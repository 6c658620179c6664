"""Ranks of tests/test_torch_distributed.py and
tests/test_torch_spatial_cases.py: each runs as one gloo process
(torch.multiprocessing), imports no JAX, and rank 0 writes what it
gathered to an npz that the test holds against the JAX package.

    spawn(task, world, inputs_npz, out_npz)

`task` is "ops" (on 4 ranks: the halo, slab-FFT and z-slab residuals and
norms, a data=4 train step and epoch, the spatial partition's halo pads
against one-process convs, a (data=1, y=2, x=2) train step and epoch and
a 4-step rollout on that mesh), "train" (the train step and epoch
alone, at data=world) or "spatial" (on 4 ranks: the fft Laplacian on
tiles with its gradient, train steps and epochs with the fft operator,
the resnet and UNet levels that do not split, the CSLP inverse on tiles,
and GMRES on a split grid, with and without the CSLP preconditioner).
"""

from __future__ import annotations

import dataclasses
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "trained_models", "round1_best_epoch890.npz")
PICK = 1


def tiny_config():
    """The port's copy of tests/test_training.tiny_config (the test checks
    that the two agree)."""
    from helmnet_tpu_torch.core.config import (Config, GeometryConfig,
                                               ModelConfig, SourceConfig,
                                               TrainingConfig)

    return Config(
        max_iterations=50,
        geometry=GeometryConfig(domain_size=32, pml_size=4, sigma_max=2.0),
        model=ModelConfig(features=8, depth=4, state_depth=4, state_channels=2),
        source=SourceConfig(amplitude=10.0, location=(26, 16)),
        training=TrainingConfig(
            buffer_size=16, train_batch_size=4, unrolling_steps=3,
            learning_rate=3e-3, minimum_learning_rate=1e-4,
        ),
    )


def train_results(mesh, inp, case: str = "") -> dict:
    """One train step on the stored batch and one epoch from a filled
    buffer, with `mesh` (None: one process); every value global. `case`
    names a spatial case (`case_config`), whose params, batch and maps
    the inputs hold under its name; "" is the tiny config."""
    from helmnet_tpu_torch.train.loop import Trainer
    from helmnet_tpu_torch.train.replay import ExperienceBatch
    from helmnet_tpu_torch.weights import load_params_npz

    cfg = case_config(tiny_config(), case)
    pre = f"{case}_" if case else ""
    params = load_params_npz(str(inp.get(f"{pre}params_npz", NPZ)), cfg, device="cpu")
    maps = inp.get(f"{pre}maps", inp["maps"])
    batch_key = f"{pre}batch" if f"{pre}batch_indices" in inp else "batch"
    t = Trainer(cfg, params=params, mesh=mesh, device="cpu")
    batch = ExperienceBatch(*(torch.from_numpy(inp[f"{batch_key}_{k}"]) for k in
                              ExperienceBatch._fields[:-1]),
                            inp[f"{batch_key}_indices"])
    metrics, evolved = t._train_step(batch, PICK)
    t2 = Trainer(cfg, params=params, mesh=mesh, device="cpu")
    t2.fill_buffer(maps)
    stats = t2.training_epoch(maps)
    return {
        "step_loss": float(metrics["loss"]),
        "step_rel_loss": float(metrics["rel_loss"]),
        "step_grad_norm": float(metrics["grad_norm"]),
        "step_wavefield": evolved["wavefield"].numpy(),
        "step_residual": evolved["residual"].numpy(),
        "step_states": evolved["states"].numpy(),
        "step_outc_b": t.params["outc"]["b"].detach().numpy(),
        "epoch_loss": stats["train_loss_mean"],
        "epoch_new_sos": stats["new_sos"],
        "epoch_wavefield": t2.buffer.wavefield.copy(),
        "epoch_states": t2.buffer.states.copy(),
        "epoch_iteration": t2.buffer.iteration.copy(),
    }


# the spatial training cases: (name, mesh sizes); `case_config` makes
# each one's config from the tiny config, in either package
SPATIAL_TRAIN = (("fft", (1, 2, 2)), ("resnet", (1, 2, 2)), ("uneven", (1, 4, 1)),
                 ("uneven48", (1, 4, 1)))


def case_config(cfg, case: str):
    """The tiny config (of either package) changed for a spatial case:
    "fft" the fft operator; "resnet" the flat resnet; "uneven" as it is
    (on (1, 4, 1) its 2-row level 4 does not split); "uneven48" at 48^2,
    where levels 3 (6 rows) and 4 (3 rows) do not split over y = 4, so
    the state of level 3 is whole along y."""
    if case == "fft":
        return cfg.replace(operator_mode="fft")
    if case == "resnet":
        return cfg.replace(model=dataclasses.replace(cfg.model, architecture="resnet"))
    if case == "uneven48":
        return cfg.replace(geometry=dataclasses.replace(cfg.geometry, domain_size=48))
    return cfg


# the fft Laplacian on tiles: each mesh at a grid whose pencils split
# (all-to-all) and one whose do not (all-gather)
FFT_CASES = (((1, 2, 2), ((32, 32), (26, 22))), ((1, 4, 1), ((32, 32), (24, 30))),
             ((1, 1, 4), ((32, 32), (30, 24))))
GMRES_N, GMRES_MODES = 64, ("matmul", "fft", "stencil")
# restart and cycles of each preconditioner's solve; the CSLP solve stops
# far above f32's floor (about 2e-6 relative), so that its histories
# compare cycle by cycle
GMRES_RUNS = {"none": (60, 15), "shifted_laplace": (30, 5)}
CSLP_MODES = ("matmul", "fft")
# the CSLP inverse on tiles: each mesh at a grid whose pencils split
# (all-to-all) and one whose do not (all-gather), both kref modes
CSLP_CASES = (((1, 2, 2), ((64, 64), (62, 58))), ((1, 4, 1), ((64, 64), (64, 62))),
              ((1, 1, 4), ((64, 64), (62, 64))))
CSLP_KREFS = ("mean", "max")


def block_medium(h: int, w: int, block_sos: float = 1.5) -> np.ndarray:
    """sos [h, w]: a unit medium with a block of `block_sos` on [20:40,
    16:52] (tests/test_stencil_distributed.py's medium at 64^2)."""
    sos = np.ones((h, w), np.float32)
    sos[20:40, 16:52] = block_sos
    return sos


def gmres_problem():
    """tests/test_stencil_distributed.py's sharded GMRES problem: 64^2,
    PML 8, a 1.5 block in a unit medium, a point source; (sos, k_sq,
    source channel pair), numpy."""
    from helmnet_tpu_torch.ops.source import point_source_map

    n = GMRES_N
    sos = block_medium(n, n)
    return sos, (1.0 / sos) ** 2, point_source_map(n, n, (n - 12, n // 2), 10.0)


def cslp_inputs(h: int, w: int):
    """The CSLP inverse's inputs on an h x w grid: k^2 [2, h, w] of
    gmres_problem's medium (its tile means differ from the grid's) and of
    its twin with a fast block (sos 1 / 1.5: its tile maxima differ from
    the grid's), and a seeded complex64 field [3, 2, h, w] (three stacked
    vectors of the two problems, as the solve's checkpoints are); numpy."""
    k_sq = np.stack([(1.0 / block_medium(h, w, s)) ** 2 for s in (1.5, 1 / 1.5)])
    rng = np.random.default_rng(h * w)
    v = rng.standard_normal((2, 3, 2, h, w))
    return k_sq.astype(np.float32), (v[0] + 1j * v[1]).astype(np.complex64)


def cslp_results() -> dict:
    """`make_shifted_laplace_inverse(..., spatial=)` on each mesh and grid
    of CSLP_CASES and each kref: the gathered result [3, 2, h, w] and each
    rank's kref^2 [world, 2], under `cslp_{mesh}_{route}_{kref}_{x|kref2}`
    (route 0: the grid whose pencils split, 1: the one whose do not)."""
    from helmnet_tpu_torch.core.config import ParallelConfig
    from helmnet_tpu_torch.core.meshes import make_mesh
    from helmnet_tpu_torch.distributed.spatial import Spatial
    from helmnet_tpu_torch.ops.spectral import make_operator
    from helmnet_tpu_torch.solvers.precond import (make_shifted_laplace_inverse,
                                                   reference_k2)

    out = {}
    for sizes, grids in CSLP_CASES:
        mesh = make_mesh(ParallelConfig(*sizes), device="cpu")
        for route, (h, w) in enumerate(grids):
            k_sq, v = (torch.from_numpy(a) for a in cslp_inputs(h, w))
            op = make_operator(h, w, 8, 2.0, 1.0, dense=False, device="cpu")
            sp = Spatial(mesh, h, w, 0)
            k_tile = sp.tile(k_sq)
            for kref in CSLP_KREFS:
                key = f"cslp_{'x'.join(map(str, sizes))}_{route}_{kref}"
                minv = make_shifted_laplace_inverse(op, k_tile, kref=kref, spatial=sp)
                got = torch.view_as_real(minv(sp.tile(v, 2)))
                out[f"{key}_x"] = torch.view_as_complex(sp.gather(got, 2)).numpy()
                kref2 = reference_k2(k_tile, kref, sp).reshape(-1)
                ranks = [torch.empty_like(kref2) for _ in range(dist.get_world_size())]
                dist.all_gather(ranks, kref2)
                out[f"{key}_kref2"] = torch.stack(ranks).numpy()
    return out


def gmres_solve(mode: str, spatial=None, precond: str = "none"):
    """The problem solved by the port's GMRES (GMRES_RUNS' restart and
    cycles for `precond`, tol 1e-6) with the spectral operator in `mode`,
    or the order-4 stencil operator; with `spatial`, on this rank's
    tiles. Returns (x, residual norms) as numpy, x gathered."""
    from helmnet_tpu_torch.ops.spectral import make_operator
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator
    from helmnet_tpu_torch.solvers.gmres import solve_helmholtz

    n = GMRES_N
    _, k_sq, src = gmres_problem()
    if mode == "stencil":
        op = make_stencil_operator(n, n, 8, 2.0, 1.0, order=4, device="cpu")
    else:
        op = make_operator(n, n, 8, 2.0, 1.0, device="cpu")
    k_sq, src = torch.from_numpy(k_sq), torch.from_numpy(src)
    if spatial is not None:
        k_sq, src = spatial.tile(k_sq, 0), spatial.tile(src, 0)
    restart, cycles = GMRES_RUNS[precond]
    res = solve_helmholtz(op, k_sq, src, mode="auto" if mode == "stencil" else mode,
                          restart=restart, max_restarts=cycles, tol=1e-6,
                          precond=precond, device="cpu", spatial=spatial)
    x = res.x if spatial is None else spatial.gather(res.x, 0)
    return x.numpy(), res.residual_norms.numpy()


def fft_results() -> dict:
    """`laplacian(mode='fft', spatial=)` on each mesh of FFT_CASES against
    the one-process `laplacian_fft`: per grid, the largest difference of
    the value and that of the input gradient of a random linear function
    of it over the reference gradient's largest value."""
    from helmnet_tpu_torch.core.config import ParallelConfig
    from helmnet_tpu_torch.core.meshes import make_mesh
    from helmnet_tpu_torch.distributed.spatial import Spatial
    from helmnet_tpu_torch.ops.spectral import laplacian, laplacian_fft, make_operator

    out = {}
    for sizes, grids in FFT_CASES:
        mesh = make_mesh(ParallelConfig(*sizes), device="cpu")
        errs = []
        for h, w in grids:
            rng = np.random.default_rng(h * w)
            u, g = (torch.tensor(rng.standard_normal((2, h, w, 2)), dtype=torch.float32)
                    for _ in range(2))
            op = make_operator(h, w, 4, 2.0, 1.0, dense=False, device="cpu")
            sp = Spatial(mesh, h, w, 0)
            ref_u = u.clone().requires_grad_(True)
            ref = laplacian_fft(op, ref_u)
            torch.sum(ref * g).backward()
            tile_u = sp.tile(u).clone().requires_grad_(True)
            got = laplacian(op, tile_u, "fft", spatial=sp)
            torch.sum(got * sp.tile(g)).backward()
            errs.append([float((sp.gather(got.detach()) - ref.detach()).abs().max()),
                         float((sp.gather(tile_u.grad) - ref_u.grad).abs().max()
                               / ref_u.grad.abs().max())])
        out[f"fft_{'x'.join(map(str, sizes))}"] = np.asarray(errs)
    return out


def spatial_results(inp) -> dict:
    """The "spatial" task on 4 ranks."""
    from helmnet_tpu_torch.core.config import ParallelConfig
    from helmnet_tpu_torch.core.meshes import make_mesh
    from helmnet_tpu_torch.distributed.spatial import Spatial

    out = fft_results()
    for case, sizes in SPATIAL_TRAIN:
        mesh = make_mesh(ParallelConfig(*sizes), device="cpu")
        out.update({f"{case}_{k}": v for k, v in train_results(mesh, inp, case).items()})
    sp = Spatial(make_mesh(ParallelConfig(1, 2, 2), device="cpu"), GMRES_N, GMRES_N, 0)
    for mode in GMRES_MODES:
        out[f"gmres_{mode}_x"], out[f"gmres_{mode}_norms"] = gmres_solve(mode, sp)
    for mode in CSLP_MODES:
        out[f"cslp_gmres_{mode}_x"], out[f"cslp_gmres_{mode}_norms"] = gmres_solve(
            mode, sp, "shifted_laplace")
    out.update(cslp_results())
    return out


# (name, kernel width, stride, padding, tile sizes): every conv kind of
# the UNet (models/blocks.py) at tiles down to one row, so the deep
# levels' halos (3 rows for the down conv, 2 for the up convs) span more
# than one tile
CONV_KINDS = (("conv3x3", 3, 1, 1, (1, 2, 4)), ("down", 8, 2, 3, (2, 4)),
              ("up_transpose", 8, 2, 3, (1, 2)), ("up_subpixel", 8, 2, 3, (1, 2)))
HALO_MESHES = ((1, 2, 2), (1, 4, 1), (1, 1, 4))


def halo_results() -> dict:
    """Each conv kind on each spatial mesh, through `spatial=` on tiles
    against the one-process conv on the whole tensor: the largest
    differences of the output and of the gradients of a random linear
    function of it (input and weights), each over the reference's size."""
    from helmnet_tpu_torch.core.config import ParallelConfig
    from helmnet_tpu_torch.core.meshes import make_mesh
    from helmnet_tpu_torch.distributed.spatial import Spatial
    from helmnet_tpu_torch.models import blocks

    out = {}
    for sizes in HALO_MESHES:
        mesh = make_mesh(ParallelConfig(*sizes), device="cpu")
        for name, k, stride, pad, tiles in CONV_KINDS:
            up = name.startswith("up")
            fn = {"conv3x3": blocks.conv2d, "down": blocks.conv2d,
                  "up_transpose": blocks.conv_transpose2d,
                  "up_subpixel": blocks.conv_transpose2d_subpixel}[name]
            errs = []
            for t in tiles:
                rng = np.random.default_rng(t)
                h, w = t * sizes[1], t * sizes[2]
                x = torch.tensor(rng.standard_normal((2, h, w, 3)), dtype=torch.float32)
                wshape = (3, 4, k, k) if up else (4, 3, k, k)
                params = {"w": torch.tensor(rng.standard_normal(wshape), dtype=torch.float32),
                          "b": torch.tensor(rng.standard_normal(4), dtype=torch.float32)}
                sp = Spatial(mesh, h, w, 0)
                results = []
                for spatial in (None, sp):
                    p = {a: v.clone().requires_grad_(True) for a, v in params.items()}
                    xin = (x if spatial is None else sp.tile(x)).clone().requires_grad_(True)
                    y = fn(p, xin, stride=stride, padding=pad, spatial=spatial)
                    if spatial is None:
                        g = torch.tensor(np.random.default_rng(99).standard_normal(y.shape),
                                         dtype=torch.float32)
                    torch.sum(y * (g if spatial is None else sp.tile(g))).backward()
                    if spatial is None:
                        results.append((y, xin.grad, p["w"].grad, p["b"].grad))
                    else:
                        dw = sp.sum(torch.cat([p["w"].grad.reshape(-1), p["b"].grad]))
                        results.append((sp.gather(y.detach()), sp.gather(xin.grad),
                                        dw[:p["w"].numel()].view_as(p["w"]),
                                        dw[p["w"].numel():]))
                errs.append([float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(results[1], results[0])])
            out[f"halo_{name}_{'x'.join(map(str, sizes))}"] = np.asarray(errs)
    return out


def spatial_rollout(inp) -> dict:
    """4 learned steps on the (data=1, y=2, x=2) mesh, each rank on its
    tiles; the gathered wavefield and the (global) rmse."""
    from helmnet_tpu_torch.core.config import ParallelConfig
    from helmnet_tpu_torch.core.meshes import make_mesh
    from helmnet_tpu_torch.distributed.spatial import Spatial
    from helmnet_tpu_torch.ops.spectral import make_operator
    from helmnet_tpu_torch.solvers.iterative import rollout
    from helmnet_tpu_torch.weights import load_params_npz

    cfg = tiny_config()
    g = cfg.geometry
    mesh = make_mesh(ParallelConfig(1, 2, 2), device="cpu")
    sp = Spatial(mesh, g.domain_size, g.domain_size, cfg.model.depth)
    op = make_operator(g.domain_size, g.domain_size, g.pml_size, g.sigma_max,
                       cfg.k0, device="cpu")
    out = rollout(load_params_npz(NPZ, cfg, device="cpu"), op,
                  sp.tile(torch.from_numpy(inp["rollout_source"])),
                  sp.tile(torch.from_numpy(inp["rollout_maps"])), cfg=cfg,
                  num_iterations=4, device="cpu", spatial=sp)
    return {"rollout_wavefield": sp.gather(out["wavefield"]).numpy(),
            "rollout_rmse": out["rmse"].numpy()}


def ops_results(inp) -> dict:
    """The sharded residuals and norms on 4 ranks, gathered."""
    from helmnet_tpu_torch.core.config import ParallelConfig
    from helmnet_tpu_torch.core.meshes import (Sharding, data_sharding, make_mesh,
                                               make_mesh3d, spatial_sharding)
    from helmnet_tpu_torch.distributed.dfft import (make_sharded_laplacian_fft,
                                                    make_sharded_residual_fft)
    from helmnet_tpu_torch.distributed.halo import (make_sharded_residual_norm,
                                                    make_sharded_stencil_residual,
                                                    spatial_put)
    from helmnet_tpu_torch.distributed.multihost import fetch_global, put_global
    from helmnet_tpu_torch.distributed.slab3d import (make_sharded_residual3d,
                                                      make_sharded_residual_norm3d,
                                                      slab_put)
    from helmnet_tpu_torch.ops.spectral import make_operator
    from helmnet_tpu_torch.ops.spectral3d import make_operator3d
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator

    out = {}
    # halo: y and x both split
    mesh = make_mesh(ParallelConfig(data=1, y=2, x=2), device="cpu")
    st = make_stencil_operator(32, 32, 4, 2.0, 1.0, order=4, device="cpu")
    u, k, s = spatial_put(mesh, (inp["halo_u"], inp["halo_k"], inp["halo_s"]))
    r = make_sharded_stencil_residual(mesh, st)(u, k, s)
    out["halo_residual"] = fetch_global(r, spatial_sharding(mesh))
    norm = make_sharded_residual_norm(mesh)(spatial_put(mesh, inp["norm_res"]))
    out["halo_norm"] = fetch_global(norm, data_sharding(mesh))
    # the slab FFT: rows split 4 ways
    mesh = make_mesh(ParallelConfig(data=1, y=4, x=1), device="cpu")
    op = make_operator(64, 64, 8, 2.0, 1.0, device="cpu")
    rows = Sharding(mesh, ("data", "y"))
    u = put_global(inp["fft_u"], rows)
    out["fft_laplacian"] = fetch_global(make_sharded_laplacian_fft(mesh, op)(u), rows)
    r = make_sharded_residual_fft(mesh, op)(u, put_global(inp["fft_k"], rows),
                                            put_global(inp["fft_s"], rows))
    out["fft_residual"] = fetch_global(r, rows)
    # z slabs, 4 of them
    mesh3 = make_mesh3d(data=1, z=4, device="cpu")
    op3 = make_operator3d(24, 24, 24, 4, 2.0, 1.0, device="cpu")
    u, k, s = slab_put(mesh3, (inp["slab_u"], inp["slab_k"], inp["slab_s"]))
    slabs = Sharding(mesh3, ("data", "z"))
    for method in ("transpose", "scatter", "overlap"):
        r = make_sharded_residual3d(mesh3, op3, method=method)(u, k, s)
        out[f"slab_{method}"] = fetch_global(r, slabs)
    norm = make_sharded_residual_norm3d(mesh3)(slab_put(mesh3, inp["slab_norm_res"]))
    out["slab_norm"] = fetch_global(norm, data_sharding(mesh3))
    # the JAX package's check: across hosts, the data axis must divide by
    # their count (here 4 hosts of one rank, then 2 of two)
    try:
        make_mesh(ParallelConfig(data=2, y=2), device="cpu", ranks_per_host=1)
        out["host_check"] = "no error"
    except ValueError as e:
        out["host_check"] = str(e)
    # data-parallel training on all 4 ranks, 2 hosts of 2
    mesh = make_mesh(ParallelConfig(data=4), device="cpu", ranks_per_host=2)
    out.update({f"data4_{k}": v for k, v in train_results(mesh, inp).items()})
    # the spatial partition: halo pads, a train step and epoch, a rollout
    out.update(halo_results())
    mesh = make_mesh(ParallelConfig(data=1, y=2, x=2), device="cpu")
    out.update({f"spatial_{k}": v for k, v in train_results(mesh, inp).items()})
    out.update(spatial_rollout(inp))
    return out


def _rank(rank: int, world: int, port: int, task: str, inputs: str, out: str):
    torch.set_num_threads(1)
    from helmnet_tpu_torch.core.config import ParallelConfig
    from helmnet_tpu_torch.core.meshes import make_mesh
    from helmnet_tpu_torch.distributed import multihost

    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        with np.load(inputs) as f:
            inp = dict(f)
        if task == "ops":
            res = ops_results(inp)
        elif task == "spatial":
            res = spatial_results(inp)
        else:
            mesh = make_mesh(ParallelConfig(data=world), device="cpu")
            res = {f"data{world}_{k}": v for k, v in train_results(mesh, inp).items()}
        # every rank holds the same global values: rank 0's, checked here
        key = "fft_step_loss" if task == "spatial" else f"data{world}_step_loss"
        loss = torch.tensor([res[key]], dtype=torch.float64)
        ref = loss.clone()
        dist.broadcast(ref, 0)
        if not torch.equal(loss, ref):
            raise AssertionError(f"rank {rank}'s loss {loss} differs from rank 0's {ref}")
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def spawn(task: str, world: int, inputs: str, out: str) -> None:
    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_rank, args=(world, port, task, inputs, out), nprocs=world)

"""Dry run of the port on one or more ranks, the counterpart of the JAX
package's `__graft_entry__.py`.

    python -m helmnet_tpu_torch.dryrun --ranks 4      # 4 gloo ranks on the CPU
    torchrun --nproc-per-node 4 -m helmnet_tpu_torch.dryrun   # NCCL, a card each

entry(device=None)   -> (fn, args): one learned step of the flagship model
                        (HybridNet + spectral PML operator, default config,
                        96^2), on `cuda` unless `device` says otherwise.
dryrun_multichip(n)  -> on the n ranks of the initialised process group:
                        the mesh JAX picks for n devices, one sharded train
                        step (data over the batch, y and x over the grid),
                        the halo-exchanged stencil residual and its norms,
                        the slab-FFT Laplacian, a 4-step spatially sharded
                        rollout and, for n >= 2, the z-slab 3D residual with
                        its overlap method against the plain one. Rank 0
                        prints one `[dryrun] ... OK` line each.
"""

from __future__ import annotations

import argparse
import os
import socket

import numpy as np
import torch


def _tiny_config(domain: int = 32):
    from .core.config import (Config, GeometryConfig, ModelConfig, SourceConfig,
                              TrainingConfig)

    return Config(
        max_iterations=50,
        geometry=GeometryConfig(domain_size=domain, pml_size=4, sigma_max=2.0),
        model=ModelConfig(),
        source=SourceConfig(amplitude=10.0, location=(domain - 6, domain // 2)),
        training=TrainingConfig(buffer_size=8, train_batch_size=4, unrolling_steps=2),
    )


def entry(device=None):
    """(fn, args): `fn(*args)` runs one learned step of the flagship model at
    the reference 96^2 geometry from a zero field and returns (wavefield,
    residual). The params are a seeded init made on the CPU, so every
    device gets the same ones."""
    from .core.config import Config
    from .core.device import resolve_device
    from .models import hybridnet
    from .ops.source import point_source_map
    from .ops.spectral import helmholtz_residual, make_operator
    from .solvers.iterative import SolverCarry, get_initials, single_step

    dev = resolve_device(device)
    cfg = Config()
    n = cfg.geometry.domain_size
    g = cfg.geometry
    op = make_operator(n, n, g.pml_size, g.sigma_max, cfg.k0, device=dev)
    params = hybridnet.params_to(
        hybridnet.init_params(torch.Generator().manual_seed(0), cfg.model), dev)
    s = cfg.source
    source = torch.as_tensor(point_source_map(n, n, tuple(s.location), s.amplitude,
                                              s.phase, s.omega), device=dev)[None]
    sos = np.ones((1, n, n), np.float32)
    sos[:, 40:64, 12:84] = 1.5
    sos = torch.as_tensor(sos, device=dev)

    @torch.no_grad()
    def fn(params, source, sos_maps):
        k_sq, wavefield = get_initials(sos_maps, cfg.source.omega)
        states = hybridnet.init_states(sos_maps.shape[0], n, cfg.model,
                                       device=sos_maps.device)
        residual = helmholtz_residual(op, wavefield, k_sq, source, cfg.operator_mode)
        carry = single_step(params, op, source, k_sq,
                            SolverCarry(wavefield, residual, states), cfg=cfg)
        return carry.wavefield, carry.residual

    return fn, (params, source, sos)


def mesh_for(n_devices: int):
    """JAX's mesh for n devices (`__graft_entry__.py:96-103`), every rank in
    it: n >= 4 -> (n/4, 2, 2), n = 2 -> (1, 2, 1), n = 1 -> (1, 1, 1)."""
    from .core.config import ParallelConfig

    if n_devices >= 4 and n_devices % 4 == 0:
        return ParallelConfig(data=n_devices // 4, y=2, x=2)
    if n_devices in (1, 2):
        return ParallelConfig(data=1, y=n_devices, x=1)
    raise ValueError(f"the dry run takes 1, 2 or a multiple of 4 ranks, not {n_devices}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The dry run on the `n_devices` ranks of the initialised process group
    (or this process alone for 1). Raises if a result is not finite or the
    overlap residual disagrees with the plain one."""
    from .core.meshes import Sharding, data_sharding, make_mesh
    from .data.ellipses import make_dataset
    from .distributed import multihost
    from .distributed.dfft import make_sharded_laplacian_fft
    from .distributed.halo import (make_sharded_residual_norm,
                                   make_sharded_stencil_residual, spatial_put)
    from .distributed.spatial import Spatial
    from .ops.stencil import make_stencil_operator
    from .solvers.iterative import rollout
    from .train.loop import Trainer

    if multihost.process_count() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on "
                         f"{multihost.process_count()} ranks")
    say = print if multihost.is_primary() else (lambda *a: None)
    par = mesh_for(n_devices)
    mesh = make_mesh(par, device=device)
    say(f"[dryrun] mesh {mesh.shape} on {n_devices} ranks ({mesh.device.type})")

    domain = 32
    cfg = _tiny_config(domain).replace(parallel=par)
    trainer = Trainer(cfg, mesh=mesh)
    maps = make_dataset(8, domain, seed=0)
    trainer.fill_buffer(maps)
    bs = cfg.training.train_batch_size
    batch = trainer.buffer.sample(bs)
    metrics, _ = trainer._train_step(trainer._to_device(batch), 1)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite training loss {loss}")
    say(f"[dryrun] sharded train_step OK: loss={loss:.4e}")

    # explicit halo-exchange stencil residual + all-reduced norms
    st = make_stencil_operator(domain, domain, 4, 2.0, 1.0, order=4, device=mesh.device)
    u, k, s = spatial_put(mesh, (batch.wavefield, batch.k_sq, batch.source))
    res = make_sharded_stencil_residual(mesh, st)(u, k, s)
    norms = multihost.fetch_global(make_sharded_residual_norm(mesh)(res),
                                   data_sharding(mesh))
    _finite("halo norms", norms)
    say(f"[dryrun] halo-exchange stencil residual OK: norms={norms}")

    # transpose-based distributed FFT Laplacian over the 'y' axis
    rows = Sharding(mesh, ("data", "y"))
    lap = make_sharded_laplacian_fft(mesh, trainer.op)(
        multihost.put_global(batch.wavefield, rows))
    _finite("slab-FFT laplacian", multihost.fetch_global(lap, rows))
    say("[dryrun] distributed slab-FFT laplacian OK")

    # spatially sharded inference rollout (halo-exchanged UNet)
    spatial = (Spatial(mesh, domain, domain, cfg.model.depth)
               if par.y * par.x > 1 else None)
    src = np.broadcast_to(trainer.source_map[None], (bs, domain, domain, 2))
    src, sos = spatial_put(mesh, (np.ascontiguousarray(src), maps[:bs]))
    out = rollout(trainer.params, trainer.op, src, sos, cfg=cfg, num_iterations=4,
                  device=mesh.device, spatial=spatial)
    rm = multihost.fetch_global(out["rmse"], Sharding(mesh, (None, "data")))
    _finite("rollout rmse", rm)
    say(f"[dryrun] sharded rollout OK: final rmse={rm[-1]}")

    if n_devices >= 2:
        _slab3d(n_devices, device, say)


def _slab3d(n_devices: int, device, say) -> None:
    """The z-slab 3D residual (partial GEMM + reduce-scatter over the slab
    axis) and its overlap method against the plain one."""
    from .core.meshes import data_sharding, make_mesh3d
    from .distributed import multihost
    from .distributed.slab3d import (make_sharded_residual3d,
                                     make_sharded_residual_norm3d, slab_put)
    from .ops.spectral3d import make_operator3d

    b3 = max(n_devices // 4, 1)
    zmesh = make_mesh3d(data=b3, z=n_devices // b3, device=device)
    n3 = 16
    op3 = make_operator3d(n3, n3, n3, 4, 2.0, 1.0, device=zmesh.device)
    rng = np.random.default_rng(7)
    u3, k3, s3 = slab_put(zmesh, (
        rng.standard_normal((b3, n3, n3, n3, 2)).astype(np.float32),
        rng.uniform(0.5, 1.2, (b3, n3, n3, n3)).astype(np.float32),
        rng.standard_normal((b3, n3, n3, n3, 2)).astype(np.float32),
    ))
    res3 = make_sharded_residual3d(zmesh, op3)(u3, k3, s3)
    norms = multihost.fetch_global(make_sharded_residual_norm3d(zmesh)(res3),
                                   data_sharding(zmesh))
    _finite("3D norms", norms)
    say(f"[dryrun] 3D z-slab residual OK: norms={norms}")
    res3o = make_sharded_residual3d(zmesh, op3, method="overlap",
                                    overlap_chunks=4)(u3, k3, s3)
    diff = _global_max((res3o - res3).abs().max())
    scale = _global_max(res3.abs().max())
    if not diff <= 1e-5 * scale:
        raise AssertionError(f"overlap residual differs by {diff} (scale {scale})")
    say(f"[dryrun] 3D z-slab OVERLAP residual OK: max|diff|={diff:.2e}")


def _global_max(t: torch.Tensor) -> float:
    t = t.detach().clone().reshape(1)
    if torch.distributed.is_initialized():
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return float(t)


def _finite(name: str, a: np.ndarray) -> None:
    if not np.all(np.isfinite(a)):
        raise FloatingPointError(f"non-finite {name}: {a}")


def _rank(rank: int, world: int, port: int) -> None:
    """One gloo rank of `--ranks`: a thread each, so ranks do not spin."""
    from .distributed import multihost

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        if rank == 0:
            fn, args = entry(device="cpu")
            print("entry() run OK:", [tuple(o.shape) for o in fn(*args)])
        dryrun_multichip(world, device="cpu")
        if rank == 0:
            print("dryrun_multichip OK")
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=None,
                   help="spawn this many gloo ranks on the CPU; without it, "
                        "join the NCCL group torchrun describes (or make one "
                        "of world size 1), one card a rank")
    args = p.parse_args(argv)
    if args.ranks is not None:
        import torch.multiprocessing as mp

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        mp.spawn(_rank, args=(args.ranks, port), nprocs=args.ranks)
        return 0

    from .distributed import multihost

    local = int(os.environ.get("LOCAL_RANK", 0))
    if "WORLD_SIZE" in os.environ:
        multihost.initialize(device=f"cuda:{local}")
    else:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        multihost.initialize(f"localhost:{port}", 1, 0, device="cuda:0")
    try:
        if multihost.is_primary():
            fn, args_ = entry(device=f"cuda:{local}")
            print("entry() run OK:", [tuple(o.shape) for o in fn(*args_)])
        dryrun_multichip(multihost.process_count())
        if multihost.is_primary():
            print("dryrun_multichip OK")
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

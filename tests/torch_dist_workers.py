"""Ranks of tests/test_torch_distributed.py: each runs as one gloo process
(torch.multiprocessing), imports no JAX, and rank 0 writes what it
gathered to an npz that the test holds against the JAX package.

    spawn(task, world, inputs_npz, out_npz)

`task` is "ops" (the halo, slab-FFT and z-slab residuals and norms, and a
data=4 train step and epoch on 4 ranks) or "train" (the train step and
epoch alone, at data=world).
"""

from __future__ import annotations

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


def train_results(mesh, inp) -> dict:
    """One train step on the stored batch and one epoch from a filled
    buffer, with `mesh` (None: one process); every value global."""
    from helmnet_tpu_torch.train.loop import Trainer
    from helmnet_tpu_torch.train.replay import ExperienceBatch
    from helmnet_tpu_torch.weights import load_params_npz

    cfg = tiny_config()
    params = load_params_npz(NPZ, cfg, device="cpu")
    t = Trainer(cfg, params=params, mesh=mesh, device="cpu")
    batch = ExperienceBatch(*(torch.from_numpy(inp[f"batch_{k}"]) for k in
                              ExperienceBatch._fields[:-1]),
                            inp["batch_indices"])
    metrics, evolved = t._train_step(batch, PICK)
    t2 = Trainer(cfg, params=params, mesh=mesh, device="cpu")
    t2.fill_buffer(inp["maps"])
    stats = t2.training_epoch(inp["maps"])
    return {
        "step_loss": float(metrics["loss"]),
        "step_rel_loss": float(metrics["rel_loss"]),
        "step_grad_norm": float(metrics["grad_norm"]),
        "step_wavefield": evolved["wavefield"].numpy(),
        "step_residual": evolved["residual"].numpy(),
        "step_outc_b": t.params["outc"]["b"].detach().numpy(),
        "epoch_loss": stats["train_loss_mean"],
        "epoch_new_sos": stats["new_sos"],
        "epoch_wavefield": t2.buffer.wavefield.copy(),
        "epoch_iteration": t2.buffer.iteration.copy(),
    }


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
        else:
            mesh = make_mesh(ParallelConfig(data=world), device="cpu")
            res = {f"data{world}_{k}": v for k, v in train_results(mesh, inp).items()}
        # every rank holds the same global values: rank 0's, checked here
        loss = torch.tensor([res[f"data{world}_step_loss"]], dtype=torch.float64)
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

"""Training CLI, port of `helmnet_tpu/cli/train.py` (reference train.py).

    python -m helmnet_tpu_torch.cli.train --parameters experiments/base.json \\
        --epochs 1000 [--platform cpu] [--data-parallel 4]

Trains on the card (`--device cuda`, the default; raises without one) or
the CPU. `--platform` is another name for `--device`, so a command line
written for the JAX CLI runs here. With no device given the CLI takes
`cuda` even with --smoke, where the JAX CLI's --smoke defaults to the
CPU: the port's entry points never move to the CPU unless asked to, so a
smoke run without a card raises instead of passing on the CPU unnoticed.
--smoke runs the JAX package's tiny end-to-end training (generated data,
32^2 grid, a few epochs) and passes when a later epoch's mean loss is
below the first's and every loss is finite.

Data parallelism: `--data-parallel N` trains on N ranks, one process each
(started here with torch.multiprocessing), on the mesh's data axis
(core/meshes.make_mesh): one card a rank under NCCL (cuda:0 .. cuda:N-1),
or N gloo processes on the CPU with `--device cpu`. `--multihost` makes
this process one host of several: `--coordinator host:port` (rank 0's
address), `--num-processes` (hosts) and `--process-id` (this host's
index); each host starts `--data-parallel / --num-processes` ranks (one
without --data-parallel), ranks host-major. Without --coordinator the
rendezvous comes from the environment (torchrun's `env://`, one rank a
process). Every rank trains the same replicated loop (train/loop.py);
only rank 0 writes logs and checkpoints.

`--ckpt-dir DIR` resumes from DIR's latest step and keeps the top-k steps
there: a step of the port's (`state.pt`) or one the JAX package wrote with
orbax (a JAX run such as checkpoints/tpu_r3c1024, copied first, since the
run goes on writing and pruning there), with its Adam state, epoch,
global step and learning-rate schedule.
"""

import argparse
import os
import socket
import sys

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--parameters", type=str, default=None,
                   help="experiment JSON (reference-compatible sections)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--log-dir", type=str, default="logs")
    p.add_argument("--ckpt-dir", type=str, default="checkpoints")
    p.add_argument("--val-every", type=int, default=2)
    p.add_argument("--val-iterations", type=int, default=None)
    p.add_argument("--device", "--platform", dest="device", type=str, default=None,
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="ranks on the mesh's data axis (all hosts together)")
    p.add_argument("--multihost", action="store_true",
                   help="this process is one host of a multi-host run "
                        "(--coordinator/--num-processes/--process-id, or "
                        "torchrun's environment)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0 (multihost)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="hosts of a multihost run")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's index in a multihost run")
    args = p.parse_args(argv)

    hosts, host = 1, 0
    if args.multihost and args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            p.error("--multihost with --coordinator needs --num-processes "
                    "and --process-id")
        hosts, host = args.num_processes, args.process_id
    world = args.data_parallel or hosts
    if world % hosts:
        p.error(f"data axis ({world}) must be divisible by the process count "
                f"({hosts})")
    per_host = world // hosts
    if args.multihost and args.coordinator is None:  # torchrun's environment
        return _rank_main(args, None, None, None, None,
                          int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
    if world == 1:
        return _train(args, None)
    coordinator = args.coordinator or f"localhost:{_free_port()}"
    if per_host == 1:
        return _rank_main(args, coordinator, world, host, 0, per_host)
    import torch.multiprocessing as mp

    try:
        mp.spawn(_spawned, args=(args, coordinator, world, host * per_host,
                                 per_host), nprocs=per_host)
    except mp.ProcessExitedException as e:
        return e.exit_code or 1
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(local: int, args, coordinator, world, first, per_host) -> None:
    rc = _rank_main(args, coordinator, world, first + local, local, per_host)
    if rc:
        sys.exit(rc)


def _rank_main(args, coordinator, world, rank, local, per_host) -> int:
    """One rank of a data-parallel run: its process group, its mesh, the
    run, and the group's end."""
    import torch.distributed as dist

    from ..core.config import ParallelConfig
    from ..core.meshes import make_mesh
    from ..distributed import multihost

    cpu = args.device is not None and args.device.startswith("cpu")
    if local is None:  # torchrun: LOCAL_RANK names this rank's card
        local = int(os.environ.get("LOCAL_RANK", 0))
    device = "cpu" if cpu else f"cuda:{local}"
    if cpu:  # the host's cores shared out: oversubscribed threads spin
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // per_host)))
    multihost.initialize(coordinator, world, rank, device=device)
    try:
        mesh = make_mesh(ParallelConfig(data=multihost.process_count()),
                         device=device, ranks_per_host=per_host)
        if multihost.is_primary():
            print(f"mesh: {mesh.shape} on {multihost.process_count()} ranks "
                  f"({dist.get_backend()})")
        return _train(args, mesh, device)
    finally:
        dist.destroy_process_group()


def _train(args, mesh, device=None) -> int:
    from ..core.config import Config, ParallelConfig
    from ..data.ellipses import load_maps, make_dataset
    from ..train.loop import Trainer

    if args.smoke:
        from ..core.config import (
            GeometryConfig,
            ModelConfig,
            SourceConfig,
            TrainingConfig,
        )

        cfg = Config(
            max_iterations=50,
            geometry=GeometryConfig(domain_size=32, pml_size=4),
            model=ModelConfig(),
            source=SourceConfig(location=(26, 16)),
            training=TrainingConfig(
                buffer_size=16, train_batch_size=4, unrolling_steps=3,
                learning_rate=3e-3,
            ),
        )
        train_maps = make_dataset(16, 32, seed=0)
        val_maps = make_dataset(4, 32, seed=1)
        epochs = args.epochs or 8
        val_iters = args.val_iterations or 10
    else:
        cfg = (
            Config.from_json_file(args.parameters)
            if args.parameters
            else Config()
        )
        train_maps = load_maps(cfg.medium.train_set)
        val_maps = load_maps(cfg.medium.validation_set)
        epochs = args.epochs or cfg.training.max_epochs
        val_iters = args.val_iterations

    kw = {}
    if mesh is not None:
        cfg = cfg.replace(parallel=ParallelConfig(data=mesh.size("data")))
        kw["mesh"] = mesh
    trainer = Trainer(cfg, log_dir=args.log_dir, device=device or args.device, **kw)
    print(f"device: {trainer.device}")
    try:
        history = trainer.fit(
            train_maps,
            val_maps,
            num_epochs=epochs,
            val_every=args.val_every,
            val_iterations=val_iters,
            ckpt_dir=None if args.smoke else args.ckpt_dir,
        )
    finally:
        trainer.close()
    for h in history:
        print(
            f"epoch {h['epoch']:4d}  loss {h['train_loss_mean']:.4e}  "
            f"maxiter {h['maxiter']:4d}  new_sos {h['new_sos']:3d}  "
            f"lr {h['lr']:.1e}  {h['epoch_time_s']:.1f}s"
            + (f"  val {h['val_loss']:.4e}" if "val_loss" in h else "")
        )
    if args.smoke:
        losses = [h["train_loss_mean"] for h in history]
        ok = min(losses[1:]) < losses[0] and np.isfinite(losses).all()
        print("SMOKE", "PASS" if ok else "FAIL", losses)
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

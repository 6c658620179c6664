"""Export the params of an orbax training run as a flat params npz.

    python tools/export_orbax_npz.py checkpoints/tpu_r2c \\
        trained_models/tpu_r2c_best.npz [--step N]

Restores the run through the JAX package
(`IterativeSolver.from_orbax_checkpoint`: the manifest's best step unless
`--step` is given) and writes its params with
`helmnet_tpu.train.checkpoint.save_params_npz` (leaves `p0 ... pN` in the
JAX tree order), which `helmnet_tpu_torch.weights.load_params_npz`
reads. Optional: the PyTorch port reads orbax runs itself, without JAX
(`helmnet_tpu_torch/train/orbax.py`); the tool reproduces the committed
`trained_models/tpu_r2c_best.npz`. Needs JAX; runs on the CPU.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("directory", help="orbax checkpoint directory")
    ap.add_argument("out", help="npz to write")
    ap.add_argument("--step", type=int, default=None,
                    help="step to export (default: the manifest's best)")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from helmnet_tpu.solvers.iterative import IterativeSolver
    from helmnet_tpu.train.checkpoint import best_step, save_params_npz

    step = args.step if args.step is not None else best_step(args.directory)
    solver = IterativeSolver.from_orbax_checkpoint(args.directory, step=step)
    save_params_npz(args.out, solver.params)
    leaves = len(jax.tree_util.tree_leaves(solver.params))
    print(f"{args.directory} step {step}: {leaves} leaves -> {args.out} "
          f"({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

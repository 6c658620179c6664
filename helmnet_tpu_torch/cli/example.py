"""Minimal inference example, port of `helmnet_tpu/cli/example.py`
(reference examples/simple_scattering.py): a 256^2 slab, a line source
given as a spatial map at row 30, 100 iterations, and a plot of the real
part of the wavefield.

    python -m helmnet_tpu_torch.cli.example \\
        --checkpoint trained_models/tpu_r2c_best.npz --out wavefield.png

`--checkpoint` takes a flat params `.npz` or a reference `.ckpt`, read
with the default config (an orbax directory is refused). `--platform
cuda` (the default) runs on the card and raises without one. The solve
is `simple_scattering`, which needs no matplotlib; `main` also plots.
"""

import argparse

import numpy as np


def simple_scattering(solver, iterations: int = 100) -> dict:
    """Solve the example's problem with `solver` (re-targeted to 256^2 and
    the line source). Returns host arrays: 'sos' [256, 256], 'wavefield'
    [256, 256, 2] (the best iterate) and 'rmse' [iterations]."""
    sos_map = np.ones((256, 256), np.float32)
    sos_map[100:170, 30:240] = 1.5

    source_map = np.zeros((2, 256, 256), np.float32)
    source_map[0, 30, 120:130] = 1.0

    solver.set_domain_size(256, source_map=source_map[None])
    out = solver.forward(sos_map, num_iterations=iterations)
    return {
        "sos": sos_map,
        "wavefield": out["wavefield"][0].cpu().numpy(),
        "rmse": out["rmse"][:, 0].cpu().numpy(),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=str,
                   default="trained_models/tpu_r2c_best.npz")
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--out", type=str, default="wavefield.png")
    p.add_argument("--platform", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="device to run on (default cuda; raises without a card)")
    args = p.parse_args(argv)

    from ..core.config import Config
    from ..core.device import resolve_device
    from ..solvers.iterative import IterativeSolver
    from .solve import load_checkpoint_params

    # cuda goes through the default, which raises without a card
    device = resolve_device(None if args.platform == "cuda" else args.platform)
    cfg = Config()
    solver = IterativeSolver(
        cfg, params=load_checkpoint_params(args.checkpoint, cfg, device),
        device=device)
    out = simple_scattering(solver, args.iterations)
    rmse = out["rmse"]
    print(f"residual RMSE: start {rmse[0]:.3e} -> final {rmse[-1]:.3e}")

    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plt.figure(figsize=(8, 6))
    plt.imshow(out["wavefield"][:, :, 0], vmin=-0.5, vmax=0.5, cmap="seismic")
    plt.colorbar()
    plt.title(f"Re(u) after {args.iterations} iterations")
    plt.savefig(args.out, dpi=120, bbox_inches="tight")
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

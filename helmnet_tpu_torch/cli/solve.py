"""Solve one Helmholtz problem with the policy's solver, port of
`helmnet_tpu/cli/solve.py`.

Routes through solvers/auto.solve_auto, which picks learned, CSLP,
two-level or recycled two-level (in 3D CSLP or two-level) from the
problem's grid size, wavelengths across and heterogeneity, and says why.

    python -m helmnet_tpu_torch.cli.solve --sos maps.npz --index 0 \\
        --checkpoint trained_models/tpu_r2c_best.npz --tol 1e-4 \\
        --out solution.npz [--platform cpu]

Runs on the card (`--platform cuda`, the default; raises without one) or
the CPU. `--checkpoint` takes a flat params `.npz` (from
`tools/export_orbax_npz.py`) or a reference `.ckpt`; an orbax directory
is refused. With --dry-run it prints the plan (method, rationale,
evidence) without solving. A [D, H, W] cube is a 3D problem; its default
point source is the 2D default scaled to the grid, at the middle of the
last axis (`ops/spectral3d.point_source_map3d`).
"""

import argparse
import os
import time

import numpy as np


def load_checkpoint_params(path: str, cfg, device):
    """Params from a flat params `.npz` or a reference `.ckpt`; an orbax
    directory raises SystemExit."""
    from ..weights import ORBAX_REFUSAL

    if os.path.isdir(path):
        raise SystemExit(f"{path} {ORBAX_REFUSAL}")
    if path.endswith(".npz"):
        from ..weights import load_params_npz

        return load_params_npz(path, cfg, device=device)
    from ..train.checkpoint import load_reference_checkpoint

    return load_reference_checkpoint(path, device=device)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sos", type=str, required=True,
                   help="npz with 'maps' (or a single 2D array)")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="params .npz or reference .ckpt (enables the learned family)")
    p.add_argument("--source-location", type=int, nargs="+", default=None)
    p.add_argument("--source-npz", type=str, default=None,
                   help="npz with a [H, W, 2] (or [D, H, W, 2]) source map; overrides "
                        "--source-location")
    p.add_argument("--amplitude", type=float, default=10.0)
    p.add_argument("--omega", type=float, default=1.0)
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--dry-run", action="store_true",
                   help="print the solver plan and exit")
    p.add_argument("--platform", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="device to run on (default cuda; raises without a card)")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from ..core.config import Config
    from ..core.device import resolve_device
    from ..ops.source import point_source_map
    from ..ops.spectral3d import point_source_map3d
    from ..solvers.auto import choose_solver, solve_auto

    # cuda goes through the default, which raises without a card
    device = resolve_device(None if args.platform == "cuda" else args.platform)
    with np.load(args.sos) as f:
        maps = f["maps"] if "maps" in f else f[f.files[0]]
    # [H,W] / [D,H,W] cube = single problem; [N,H,W] / [N,D,H,W] = batch
    if maps.ndim == 2 or (maps.ndim == 3 and
                          maps.shape[0] == maps.shape[1] == maps.shape[2]):
        sos = maps
    else:
        sos = maps[args.index]
    sos = np.asarray(sos, np.float32)
    is_3d = sos.ndim == 3

    cfg = Config()
    cfg = cfg.replace(
        geometry=dataclasses.replace(cfg.geometry, domain_size=max(sos.shape)),
        source=dataclasses.replace(cfg.source, amplitude=args.amplitude,
                                   omega=args.omega),
    )
    params = None
    if args.checkpoint:
        params = load_checkpoint_params(args.checkpoint, cfg, device)

    plan = choose_solver(sos, cfg=cfg, params=params, tol=args.tol)
    print(f"plan: {plan.method}")
    print(f"  rationale: {plan.rationale}")
    print(f"  evidence:  {plan.evidence}")
    print(f"  kwargs:    {plan.kwargs}")
    if args.dry_run:
        return 0

    if args.source_npz:
        with np.load(args.source_npz) as f:
            src = f[f.files[0]]
        if src.shape[:-1] != sos.shape or src.shape[-1] != 2:
            raise SystemExit(
                f"--source-npz shape {src.shape} does not match sos "
                f"{sos.shape} + channel pair")
        src = np.asarray(src, np.float32)
    else:
        if args.source_location:
            loc = tuple(args.source_location)
        else:
            loc = tuple(int(c * max(sos.shape) / 96) for c in Config().source.location)
            loc = loc if not is_3d else (loc[0], loc[1], sos.shape[2] // 2)
        make_source = point_source_map3d if is_3d else point_source_map
        src = make_source(*sos.shape, loc, args.amplitude, 0.0, args.omega)

    t0 = time.time()
    res, plan = solve_auto(src, sos, cfg=cfg, params=params, tol=args.tol,
                           verbose=True, device=device)
    if isinstance(res, dict):  # learned rollout output
        field = res["best_wavefield"][0].cpu().numpy()
        final = float(res["best_rmse"][0])
        traj = res["rmse"][:, 0].cpu().numpy()
        print(f"learned rollout: best residual RMSE {final:.3e} "
              f"({time.time() - t0:.1f} s)")
    else:
        field = (res.wavefield if hasattr(res, "wavefield") else res.x).cpu().numpy()
        traj = res.residual_norms
        traj = traj.cpu().numpy() if isinstance(traj, torch.Tensor) else np.asarray(traj)
        print(f"{plan.method}: rel residual "
              f"{traj[-1] / max(traj[0], 1e-30):.3e} "
              f"({int(res.iterations)} iterations, "
              f"{time.time() - t0:.1f} s)")
    if args.out:
        np.savez_compressed(args.out, wavefield=field, trajectory=traj,
                            method=plan.method, seconds=time.time() - t0)
        print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Evaluation CLI, port of `helmnet_tpu/cli/evaluate.py` (reference
evaluate.py + test_step/test_epoch_end).

    python -m helmnet_tpu_torch.cli.evaluate --checkpoint model.ckpt \\
        --testset datasets/eval256/maps.npz [--platform cpu]

Runs the learned solver over a test set on the card (`--platform cuda`,
the default) or the CPU, saving the artifacts the reference produces
(hybridnet.py:316-330):
  results/evolution_of_model_RMSE_on_test_set.npy       [samples, iters]
  results/evolution_of_wavefields_on_test_set.npy       [samples, K, 2, H, W]
(wavefield evolution decimated by --decimate to bound size).

`--packed auto` packs g=16 problems per sample (models/packed.py) for
rmse-only sweeps at 256^2 <= grid < 1024^2 with batch % 16 == 0, the JAX
package's rule, copied as it is. With a reference checkpoint the config
is the default one (`double_conv_mode="xla"`), so the packed network runs
on cuDNN, as the JAX CLI's runs on XLA.
"""

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=str, required=True,
                   help=".ckpt (reference torch) or orbax dir")
    p.add_argument("--testset", type=str, required=True, help="npz of sos maps")
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--decimate", type=int, default=100)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out", type=str, default="results")
    p.add_argument("--save-wavefields", action="store_true")
    p.add_argument("--platform", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="device to run on (default cuda; raises without a card)")
    p.add_argument("--packed", type=str, default="auto", metavar="G",
                   help="channel-pack G problems per sample (models/packed):"
                        " identical results; rmse-only. 'auto' (default)"
                        " enables g=16 for >=256^2 rmse-only sweeps with"
                        " batch%%16==0, the JAX package's rule; 0 disables.")
    args = p.parse_args(argv)

    from ..core.device import resolve_device
    from ..data.ellipses import load_maps
    from ..solvers.iterative import IterativeSolver

    if os.path.isdir(args.checkpoint):
        raise SystemExit(
            f"{args.checkpoint} is a directory (an orbax checkpoint); the "
            "PyTorch port reads reference .ckpt files only so far (ROADMAP "
            "Queue A item 3: orbax checkpoints)")
    # cuda goes through the default, which raises without a card
    device = resolve_device(None if args.platform == "cuda" else args.platform)
    solver = IterativeSolver.from_reference_checkpoint(args.checkpoint,
                                                       device=device)
    maps = load_maps(args.testset)
    if args.limit:
        maps = maps[: args.limit]
    os.makedirs(args.out, exist_ok=True)

    if args.packed == "auto":
        grid = maps.shape[-1] if len(maps) else 0
        # upper bound: rollout_packed needs the matmul operator, which
        # auto mode only selects below 1024^2 (ops/spectral.resolve_mode)
        args.packed = (
            16 if (256 <= grid < 1024 and not args.save_wavefields
                   and args.batch % 16 == 0)
            else 0
        )
        if args.packed:
            print(f"auto-packing g={args.packed} at {grid}^2 "
                  "(disable with --packed 0)")
    else:
        args.packed = int(args.packed)
    if args.packed and args.save_wavefields:
        raise SystemExit("--packed collects rmse only (no --save-wavefields)")
    if args.packed and args.batch % args.packed:
        raise SystemExit("--batch must be divisible by --packed")
    collect = ("rmse", "wavefields") if args.save_wavefields else ("rmse",)
    all_rmse, all_wf = [], []
    for start in range(0, len(maps), args.batch):
        chunk = maps[start : start + args.batch]
        if args.packed and len(chunk) % args.packed == 0:
            from ..models.packed import rollout_packed

            src = solver.source
            if src.shape[0] == 1:
                src = src.expand((len(chunk),) + tuple(src.shape[1:]))
            out = rollout_packed(
                solver.params, solver.op, src, chunk, cfg=solver.cfg,
                g=args.packed, num_iterations=args.iterations, device=device,
            )
        else:
            out = solver.forward(
                chunk, num_iterations=args.iterations, collect=collect,
                decimate=args.decimate if args.save_wavefields else 1,
            )
        all_rmse.append(out["rmse"].cpu().numpy().T)  # [B, iters]
        if args.save_wavefields:
            # [chunks, B, H, W, 2] -> [B, chunks, 2, H, W] (reference layout)
            wf = out["wavefields"].cpu().numpy()
            all_wf.append(np.transpose(wf, (1, 0, 4, 2, 3)))
        print(f"  {start + len(chunk)}/{len(maps)} done")

    rmse = np.concatenate(all_rmse, 0)
    np.save(os.path.join(args.out, "evolution_of_model_RMSE_on_test_set"), rmse)
    print("final-iteration RMSE: median %.3e  p90 %.3e" % (
        np.median(rmse[:, -1]), np.quantile(rmse[:, -1], 0.9)))
    if args.save_wavefields:
        wf = np.concatenate(all_wf, 0)
        np.save(
            os.path.join(args.out, "evolution_of_wavefields_on_test_set"), wf
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Training CLI, port of `helmnet_tpu/cli/train.py` (reference train.py).

    python -m helmnet_tpu_torch.cli.train --parameters experiments/base.json \\
        --epochs 1000 [--device cpu]

Trains on the card (`--device cuda`, the default; raises without one) or
the CPU. --smoke runs the JAX package's tiny end-to-end training
(generated data, 32^2 grid, a few epochs) and passes when a later epoch's
mean loss is below the first's and every loss is finite. The JAX CLI's
--data-parallel and --multihost are not ported.
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--parameters", type=str, default=None,
                   help="experiment JSON (reference-compatible sections)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--log-dir", type=str, default="logs")
    p.add_argument("--ckpt-dir", type=str, default="checkpoints")
    p.add_argument("--val-every", type=int, default=2)
    p.add_argument("--val-iterations", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)

    from ..core.config import Config
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

    trainer = Trainer(cfg, log_dir=args.log_dir, device=args.device)
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

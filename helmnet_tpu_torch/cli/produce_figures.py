"""Figure-reproduction CLI, port of `helmnet_tpu/cli/produce_figures.py`
(reference produce_figures.py).

    python -m helmnet_tpu_torch.cli.produce_figures --checkpoint X.ckpt|X.npz \\
        --testset datasets/splitted_96/testset.npz --out figures [--platform cpu]

`--checkpoint` takes a reference `.ckpt` or a flat params `.npz` (for an
orbax run, the file `tools/export_orbax_npz.py` writes, e.g.
trained_models/tpu_r2c_best.npz), as `cli/evaluate` does; `--orbax`
raises, naming the export tool. The solves run on the card
(`--platform cuda`, the default; `--device` is the same flag) or the CPU;
the figures are drawn on the host with matplotlib.

Renders: test-set residual-RMSE trajectories, final-wavefield mosaic,
l_inf-vs-GMRES histogram, per-example comparison figures, and the large
512^2 and skull examples.
"""

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=str, default=None,
                   help=".ckpt (reference torch) or params .npz")
    p.add_argument("--orbax", type=str, default=None,
                   help="refused: export the run with tools/export_orbax_npz.py")
    p.add_argument("--step", type=int, default=None,
                   help="explicit orbax step (with --orbax; refused)")
    p.add_argument("--testset", type=str, default=None)
    p.add_argument("--out", type=str, default="figures")
    p.add_argument("--num-samples", type=int, default=20)
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--examples", type=int, default=2)
    p.add_argument(
        "--truth-histograms", action="store_true", default=True,
        help="error-distribution histograms/boxplot vs f64 ground truth",
    )
    p.add_argument(
        "--no-truth-histograms", dest="truth_histograms", action="store_false"
    )
    p.add_argument("--large", action="store_true", help="512^2 large example")
    p.add_argument("--skull", action="store_true", help="skull example figure")
    p.add_argument("--platform", "--device", dest="platform", type=str,
                   default="cuda", choices=("cuda", "cpu"),
                   help="device to run on (default cuda; raises without a card)")
    args = p.parse_args(argv)

    from ..core.device import resolve_device
    from ..data.ellipses import load_maps, make_dataset
    from ..eval import figures
    from ..eval.harness import compare_solvers
    from ..solvers.iterative import IterativeSolver
    from ..weights import ORBAX_REFUSAL

    if bool(args.checkpoint) == bool(args.orbax):
        p.error("exactly one of --checkpoint / --orbax is required")
    if args.orbax:
        raise SystemExit(f"{args.orbax} {ORBAX_REFUSAL}")
    if os.path.isdir(args.checkpoint):
        raise SystemExit(f"{args.checkpoint} {ORBAX_REFUSAL}")
    # cuda goes through the default, which raises without a card
    device = resolve_device(None if args.platform == "cuda" else args.platform)
    solver = (
        IterativeSolver.from_params_npz(args.checkpoint, device=device)
        if args.checkpoint.endswith(".npz")
        else IterativeSolver.from_reference_checkpoint(args.checkpoint,
                                                       device=device)
    )
    if args.testset and os.path.exists(args.testset):
        maps = load_maps(args.testset)[: args.num_samples]
    else:
        print("no testset given/found - generating ellipse maps")
        maps = make_dataset(args.num_samples, solver.height, seed=123)

    def divisor_near(n, target):
        target = max(min(target, n), 1)
        for d in range(target, 0, -1):
            if n % d == 0:
                return d
        return 1

    print(f"rollouts on {len(maps)} maps ...")
    out = solver.forward(
        maps, num_iterations=args.iterations, collect=("rmse", "wavefields"),
        decimate=args.iterations,
    )
    rmse = out["rmse"].cpu().numpy().T  # [B, iters]
    finals = out["wavefields"][-1].cpu().numpy()  # [B, H, W, 2]
    print("figure: residual rmse ->", figures.fig_residual_rmse(rmse, args.out))
    print("figure: mosaic ->", figures.fig_testset_mosaic(finals, out_dir=args.out))

    print("comparing against GMRES ...")
    linfs, cmps = [], []
    for i in range(len(maps)):
        cmp = compare_solvers(
            solver, maps[i], num_iterations=args.iterations,
            decimate=divisor_near(args.iterations, args.iterations // 10),
            gmres_restart=50, gmres_max_restarts=20, gmres_tol=1e-7,
        )
        linfs.append(cmp.linf)
        cmps.append(cmp)
        if i < args.examples:
            print(
                "figure: example ->",
                figures.fig_example(cmp, maps[i], args.out, f"example_{i}.png"),
            )
    print("figure: histogram ->",
          figures.fig_error_histograms(np.array(linfs), args.out))
    print(f"l_inf vs GMRES: median {np.median(linfs):.2e} max {np.max(linfs):.2e}")

    # error-vs-residual scatter + residual/l_inf overlay traces
    # (produce_figures.py:77-176 counterparts)
    res_at = np.stack([c.model_residual_at_trace for c in cmps])
    model_linf = np.stack([c.model_linf_trace for c in cmps])
    print("figure: error vs residual ->",
          figures.fig_error_vs_residual(res_at, model_linf, args.out))
    print(
        "figure: overlay traces ->",
        figures.fig_residual_and_error_overlay(
            np.stack([c.model_residual_rmse for c in cmps]),
            model_linf,
            np.stack([c.gmres_residual_norms for c in cmps]),
            np.stack([c.gmres_linf_trace for c in cmps]),
            total_iterations=args.iterations,
            out_dir=args.out,
        ),
    )

    if args.truth_histograms:
        # error distributions vs an independent f64 ground truth
        # (produce_figures.py:178-276 family; truth = mixed-precision
        # iterative refinement to 1e-10, solvers/precond.py)
        lm, rm, lg, rg = truth_errors(solver, maps, cmps)
        print(
            "figure: error distributions ->",
            figures.fig_error_histograms_boxplot(
                np.array(lm), np.array(rm), np.array(lg), np.array(rg),
                out_dir=args.out,
            ),
        )
        print(f"vs f64 truth: learned l_inf median {np.median(lm):.2e}, "
              f"GMRES l_inf median {np.median(lg):.2e}")

    if args.large:
        print("figure: large ->", figures.fig_large_example(solver, args.out))
    if args.skull:
        sos, out = skull_solve(solver)
        from ..eval import plots

        plt = plots._plt()
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        axes[0].imshow(sos, cmap="viridis")
        axes[0].set_title("skull sos map")
        plots.show_wavefield(out["wavefield"][0].cpu().numpy(), ax=axes[1],
                             title="transcranial field Re(u)")
        path = os.path.join(args.out, "skull_example.png")
        fig.savefig(path, dpi=150, bbox_inches="tight")
        print("figure: skull ->", path)
    return 0


def truth_errors(solver, maps, cmps):
    """Each comparison's learned and GMRES fields against the f64 truth
    (`solve_helmholtz_refined` to 1e-10): lists of (learned l_inf, learned
    rmse, GMRES l_inf, GMRES rmse)."""
    from ..eval.harness import field_difference, linf_and_rmse
    from ..solvers.precond import solve_helmholtz_refined

    loc = tuple(solver.cfg.source.location)
    lm, rm, lg, rg = [], [], [], []
    print("f64 ground-truth solves for error histograms ...")
    for i, c in enumerate(cmps):
        k_sq = (solver.cfg.source.omega / maps[i]) ** 2
        truth, _ = solve_helmholtz_refined(
            solver.op, solver.cfg.geometry, solver.cfg.k0, k_sq,
            solver.source[0].cpu().numpy(), tol=1e-10,
            inner_restart=50, inner_max_restarts=8, device=solver.device,
        )
        for field, ls, rs in ((c.model_wavefield, lm, rm),
                              (c.gmres_wavefield, lg, rg)):
            diff, _, _ = field_difference(field, truth, loc)
            li, rmse_ = linf_and_rmse(diff)
            ls.append(float(li))
            rs.append(float(rmse_))
    return lm, rm, lg, rg


def skull_solve(solver, size: int = 512, iterations: int = 3000):
    """The transcranial example: `skull_example_problem(size)` with its arc
    source, `iterations` learned steps. Returns (sos map, forward's out)."""
    from ..data.skull import skull_example_problem

    sos, source = skull_example_problem(size)
    solver.set_domain_size(size, source_map=source[None])
    return sos, solver.forward(sos, num_iterations=iterations)


if __name__ == "__main__":
    raise SystemExit(main())

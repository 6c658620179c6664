"""Paper-figure reproduction (reference produce_figures.py), port of
`helmnet_tpu/eval/figures.py` on the port's `SolverComparison` and
`IterativeSolver`; matplotlib is imported when a figure is drawn.

Each `fig_*` renders one figure family from framework artifacts (ours, not
the reference's cached .mat/.npy). The CLI entry point is cli/produce_figures.
"""

from __future__ import annotations

import os

import numpy as np

from . import plots
from .harness import SolverComparison


def _save(fig, out_dir, name):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt = plots._plt()
    plt.close(fig)
    return path


def fig_residual_rmse(rmse: np.ndarray, out_dir: str = "figures"):
    """Test-set residual-RMSE trajectories (produce_figures.py:118-148):
    median + decile band over samples vs iteration."""
    plt = plots._plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    iters = np.arange(1, rmse.shape[1] + 1)
    med = np.median(rmse, 0)
    lo, hi = np.quantile(rmse, 0.1, 0), np.quantile(rmse, 0.9, 0)
    ax.fill_between(iters, lo, hi, alpha=0.25, label="10-90 percentile")
    ax.semilogy(iters, med, label="median")
    ax.set_xlabel("iteration")
    ax.set_ylabel("residual RMSE")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    return _save(fig, out_dir, "residual_rmse_testset.png")

def fig_testset_mosaic(
    wavefields: np.ndarray, rows: int = 4, cols: int = 5,
    out_dir: str = "figures",
):
    """Mosaic of final wavefields over test samples
    (produce_figures.py testset mosaic)."""
    plt = plots._plt()
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    for i, ax in enumerate(np.ravel(axes)):
        ax.axis("off")
        if i < len(wavefields):
            plots.show_wavefield(wavefields[i], ax=ax, colorbar=False)
    return _save(fig, out_dir, "testset_mosaic.png")


def fig_error_histograms(linf_errors: np.ndarray, out_dir: str = "figures"):
    """Histogram of final l_inf errors vs the classical solver
    (produce_figures.py:181-196: log-binned 0.01%..100%)."""
    plt = plots._plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    bins = np.logspace(-4, 0, 40)
    ax.hist(np.clip(linf_errors, 1e-4, 1.0), bins=bins)
    ax.set_xscale("log")
    ax.set_xlabel(r"$\ell_\infty$ error vs GMRES (fraction)")
    ax.set_ylabel("samples")
    ax.grid(True, alpha=0.3)
    return _save(fig, out_dir, "linf_histogram.png")


def fig_error_vs_residual(
    residual_traces: np.ndarray,
    linf_traces: np.ndarray,
    out_dir: str = "figures",
):
    """Physics-residual magnitude vs true l_inf error, per sample + mean and
    median aggregates, log-log (produce_figures.py:77-112). Demonstrates the
    residual is a usable on-line proxy for the (unobservable) true error.

    residual_traces, linf_traces: [N, T] aligned per-sample trajectories.
    """
    plt = plots._plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for r, e in zip(residual_traces, linf_traces):
        ax.plot(r, 100 * e, color="darkgray", alpha=0.15, lw=0.8)
    ax.plot(
        residual_traces.mean(0), 100 * linf_traces.mean(0),
        color="black", ls="--", label="mean",
    )
    ax.plot(
        np.median(residual_traces, 0), 100 * np.median(linf_traces, 0),
        color="black", label="median",
    )
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("residual magnitude")
    ax.set_ylabel(r"$\ell_\infty$ error (%)")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    return _save(fig, out_dir, "error_vs_residual.png")


def fig_residual_and_error_overlay(
    model_residual: np.ndarray,
    model_linf: np.ndarray,
    gmres_residual: np.ndarray,
    gmres_linf: np.ndarray = None,
    total_iterations: int = None,
    out_dir: str = "figures",
):
    """Two-panel learned-vs-GMRES overlay (produce_figures.py:114-176):
    left — residual magnitude vs iterations for both solvers (GMRES restart
    checkpoints spread over the iteration budget); right — l_inf error vs
    iterations (model vs the converged field; GMRES checkpoints vs its own
    converged solution when given).

    model_residual: [N, iters]; model_linf: [N, T]; gmres_residual:
    [N, R+1] per-cycle true residual norms (relative-ized here).
    """
    plt = plots._plt()
    total = total_iterations or model_residual.shape[1]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))

    g_rel = gmres_residual / np.maximum(gmres_residual[:, :1], 1e-30)
    gx = np.linspace(1, total, g_rel.shape[1])
    for g in g_rel:
        ax1.plot(gx, g, color="orange", alpha=0.15, lw=0.8)
    ax1.plot(gx, np.median(g_rel, 0), color="darkorange", label="GMRES")
    ax1.plot(gx, g_rel.mean(0), color="darkorange", ls="--")
    mx = np.arange(1, model_residual.shape[1] + 1)
    for m in model_residual:
        ax1.plot(mx, m, color="darkgray", alpha=0.15, lw=0.8)
    ax1.plot(mx, np.median(model_residual, 0), color="black", label="learned")
    ax1.plot(mx, model_residual.mean(0), color="black", ls="--")
    ax1.set_yscale("log")
    ax1.set_xlabel("iteration")
    ax1.set_title("residual magnitude")
    ax1.grid(True, which="both", alpha=0.3)
    ax1.legend()

    ex = np.linspace(1, total, model_linf.shape[1])
    for e in model_linf:
        ax2.plot(ex, 100 * e, color="darkgray", alpha=0.15, lw=0.8)
    ax2.plot(ex, 100 * np.median(model_linf, 0), color="black", label="learned")
    ax2.plot(ex, 100 * model_linf.mean(0), color="black", ls="--")
    if gmres_linf is not None:
        gex = np.linspace(1, total, gmres_linf.shape[1])
        for e in gmres_linf:
            ax2.plot(gex, 100 * e, color="orange", alpha=0.15, lw=0.8)
        ax2.plot(gex, 100 * np.median(gmres_linf, 0), color="darkorange",
                 label="GMRES")
    ax2.set_yscale("log")
    ax2.set_xlabel("iteration")
    ax2.set_title(r"$\ell_\infty$ error (%)")
    ax2.grid(True, which="both", alpha=0.3)
    ax2.legend()
    return _save(fig, out_dir, "residual_and_linf_traces.png")


def fig_error_histograms_boxplot(
    linf_model: np.ndarray,
    rmse_model: np.ndarray,
    linf_gmres: np.ndarray,
    rmse_gmres: np.ndarray,
    out_dir: str = "figures",
    name: str = "distribution_errors_global.png",
):
    """Three-panel error-distribution comparison vs an independent ground
    truth (produce_figures.py:178-276 histograms + boxplot family): log-
    binned l_inf and RMSE histograms for both solvers, plus side-by-side
    l_inf boxplots. Errors are fractions (0.01 = 1%)."""
    plt = plots._plt()
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.5))
    eps = 1e-8
    lm, lg = np.log10(linf_model + eps), np.log10(linf_gmres + eps)
    rm, rg = np.log10(rmse_model + eps), np.log10(rmse_gmres + eps)
    kw = dict(histtype="stepfilled", alpha=0.5, bins=30, ec="k")
    ticks = np.array([-4.0, -3.0, -2.0, -1.0, 0.0])
    labels = [f"{100 * 10 ** t:g}" for t in ticks]

    axes[0].hist(lm, color="black", label="learned", **kw)
    axes[0].hist(lg, color="orange", label="GMRES", **kw)
    axes[0].set_xticks(ticks, labels)
    axes[0].set_xlabel(r"$\ell_\infty$ error (%)")
    axes[0].set_ylabel("samples")
    axes[0].legend()

    axes[1].hist(rm, color="black", **kw)
    axes[1].hist(rg, color="orange", **kw)
    axes[1].set_xticks(ticks, labels)
    axes[1].set_xlabel("RMSE (%)")

    for pos, data, color in ((0.85, lm, "black"), (1.15, lg, "darkorange")):
        axes[2].boxplot(
            data, positions=(pos,), patch_artist=True, widths=0.2,
            boxprops=dict(facecolor="white", color=color),
            flierprops=dict(markerfacecolor=color, marker=".", markersize=2),
            medianprops=dict(color=color),
        )
    axes[2].set_xticks([0.85, 1.15], ["learned", "GMRES"])
    axes[2].set_yticks(ticks, labels)
    axes[2].set_ylabel(r"$\ell_\infty$ error (%)")
    return _save(fig, out_dir, name)


def fig_example(cmp: SolverComparison, sos: np.ndarray, out_dir="figures",
                name="example.png"):
    """Single-problem comparison (fig_generic figure,
    support_functions.py:493-512): sos map, learned field, GMRES field,
    error map, and the convergence traces."""
    plt = plots._plt()
    fig, axes = plt.subplots(2, 3, figsize=(14, 8))
    ax = axes[0, 0]
    im = ax.imshow(sos, cmap="viridis")
    fig.colorbar(im, ax=ax)
    ax.set_title("speed of sound")
    plots.show_wavefield(cmp.model_wavefield, ax=axes[0, 1],
                         title="learned solver Re(u)")
    plots.show_wavefield(cmp.gmres_wavefield, ax=axes[0, 2],
                         title="GMRES Re(u)")
    ax = axes[1, 0]
    err = np.abs(cmp.model_wavefield - cmp.gmres_wavefield)
    im = ax.imshow(err, cmap="magma")
    fig.colorbar(im, ax=ax)
    ax.set_title(f"|difference| (l_inf {cmp.linf:.2e})")
    plots.plot_residual_traces(
        {"learned solver": cmp.model_residual_rmse}, ax=axes[1, 1],
        title="physics residual",
    )
    plots.plot_residual_traces(
        {
            "model vs GMRES": cmp.model_linf_trace,
            "GMRES residual (per restart)": cmp.gmres_residual_norms
            / max(cmp.gmres_residual_norms[0], 1e-30),
        },
        ax=axes[1, 2],
        ylabel="relative error",
        title="convergence",
    )
    return _save(fig, out_dir, name)


def fig_large_example(solver, out_dir="figures", size: int = 512,
                      iterations: int = 2000):
    """Large-domain inference (produce_figures.py:426-443 runs 512^2 as a
    5x5 patch mosaic of 96^2 tiles; the TPU framework just runs the full
    512^2 grid directly)."""
    rng = np.random.default_rng(0)
    sos = np.ones((size, size), np.float32)
    # a few random slabs/lenses
    for _ in range(4):
        r0, c0 = rng.integers(size // 8, size - size // 4, 2)
        h, w = rng.integers(size // 16, size // 4, 2)
        sos[r0 : r0 + h, c0 : c0 + w] = 1.0 + 0.5 * rng.random() + 0.25
    solver.set_domain_size(size, source_location=(size - 40, size // 2))
    out = solver.forward(sos, num_iterations=iterations)
    wf = out["wavefield"][0].cpu().numpy()
    rmse = out["rmse"][:, 0].cpu().numpy()
    plt = plots._plt()
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    im = axes[0].imshow(sos, cmap="viridis")
    fig.colorbar(im, ax=axes[0])
    axes[0].set_title("speed of sound")
    plots.show_wavefield(wf, ax=axes[1], title=f"Re(u) after {iterations} iters")
    plots.plot_residual_traces({"residual": rmse}, ax=axes[2])
    return _save(fig, out_dir, f"large_example_{size}.png")

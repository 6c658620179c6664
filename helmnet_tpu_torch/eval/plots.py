"""Plotting utilities (reference helmnet/utils.py:25-216); the port's own
copy of `helmnet_tpu/eval/plots.py`, matplotlib imported when it draws.

show_wavefield / save helpers with the reference's conventions (real part,
seismic-style diverging colormap, optional dB magnitude), plus
rasterize_and_save for selective-rasterization vector figures.
Host-side matplotlib; Agg backend safe.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def to_real(wavefield: np.ndarray) -> np.ndarray:
    """Accept [H,W,2] pairs, [2,H,W] torch layout, or complex [H,W]."""
    w = np.asarray(wavefield)
    if np.iscomplexobj(w):
        return w.real
    if w.ndim == 3 and w.shape[-1] == 2:
        return w[..., 0]
    if w.ndim == 3 and w.shape[0] == 2:
        return w[0]
    return w


def show_wavefield(
    wavefield,
    ax=None,
    vmax: float | None = 0.5,
    cmap: str = "seismic",
    colorbar: bool = True,
    title: str | None = None,
):
    """Imshow of the real part (reference show_wavefield, utils.py:25-52)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 5))
    field = to_real(wavefield)
    vmax = vmax if vmax is not None else np.abs(field).max()
    im = ax.imshow(field, vmin=-vmax, vmax=vmax, cmap=cmap)
    if colorbar:
        ax.figure.colorbar(im, ax=ax)
    if title:
        ax.set_title(title)
    return ax


def show_magnitude_db(wavefield, ax=None, floor_db: float = -60.0, title=None):
    """20*log10|u| display normalized to its max."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 5))
    w = np.asarray(wavefield)
    mag = np.abs(w[..., 0] + 1j * w[..., 1]) if (w.ndim == 3 and w.shape[-1] == 2) \
        else np.abs(w)
    db = 20 * np.log10(np.maximum(mag / max(mag.max(), 1e-30), 1e-30))
    im = ax.imshow(db, vmin=floor_db, vmax=0, cmap="magma")
    ax.figure.colorbar(im, ax=ax)
    if title:
        ax.set_title(title)
    return ax


def plot_residual_traces(
    traces: dict, ax=None, ylabel: str = "residual RMSE", title=None
):
    """Semilog-y residual/error traces, one line per named solver."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    for name, values in traces.items():
        ax.semilogy(np.asarray(values), label=name)
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    return ax


def rasterize_and_save(
    fname: str, rasterize_list=None, fig=None, dpi: int = 300, **savefig_kw
):
    """Save a figure with selected artists rasterized (reference
    rasterize_and_save, utils.py:92-216): keeps vector output small when
    dense imshow/pcolormesh artists are present."""
    plt = _plt()
    fig = fig or plt.gcf()
    if rasterize_list is None:
        from matplotlib.collections import QuadMesh
        from matplotlib.image import AxesImage

        rasterize_list = [
            a
            for ax in fig.get_axes()
            for a in (list(ax.images) + list(ax.collections))
            if isinstance(a, (AxesImage, QuadMesh))
        ]
    for artist in rasterize_list:
        artist.set_rasterized(True)
    fig.savefig(fname, dpi=dpi, **savefig_kw)

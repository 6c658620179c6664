"""Batch -> channel block-diagonal packing of the HybridNet, port of
`helmnet_tpu/models/packed.py`.

G independent problems go into the channel axis: inputs [G*B', H, W, C]
-> [B', H, W, G*C] (group-major channels), and every conv weight is lifted
to a block-diagonal one whose off-diagonal blocks are exact zeros, so each
problem's result is unchanged. Only the network runs packed, and so do the
fields, residuals and k^2 of `rollout_packed`: packing happens once at
entry and unpacking once at exit.

Weight layouts are the port's (models/blocks.py): a conv's OIHW
[O, I, kh, kw] and a transposed conv's [I, O, kh, kw] are both
block-diagonalised on their first two axes, group-major on both.

`double_conv_mode='pallas'` (with precision 'default' and PReLU or ReLU)
sends each DoubleConv that the packed fused CUDA kernel K3 takes
(`ops.packed_double_conv.supported`: mid, out and head widths at most
512, at most 3 input parts) to it, and the others to the cuDNN convs, as
the JAX package routes by `fused_supported` between its kernel and XLA
(`packed.py:128-160`): the default model's 14 a step at depth 4 at every
g up to 64, with the 1x1 outc head folded into the last one, and none at
g = 128 (widths 1024). The choice is made from shapes before any launch,
and a launch that fails raises. A multi-part input goes to K3 in plain
part-major order with the per-part weight rows (`_split_packed_rows`)
concatenated to match, as the TPU wrapper does; the group-aware
`_gconcat` order is the cuDNN branch's. `rollout_packed` converts the K3
weights once per rollout (`prepare_k3`). Otherwise (`'xla'`) the
DoubleConvs are cuDNN convs in f32. The strided down convs and the up
convs stay cuDNN on block-diagonal weights in both modes; the JAX package
computes them outside any Pallas kernel too.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.config import Config, ModelConfig
from ..core.device import resolve_device
from ..ops.packed_double_conv import packed_double_conv, prepare
from ..ops.packed_double_conv import supported as k3_supported
from ..ops.spectral import SpectralPML, resolve_mode
from ..solvers.iterative import RESIDUAL_SCALE, _on, get_initials
from .blocks import conv2d, conv_transpose2d, conv_transpose2d_subpixel, double_conv
from .hybridnet import params_to, states_dimension

K3_KEY = "k3"  # a DoubleConv's prepared K3 weights in a packed params tree


def _pack_w(w: torch.Tensor, g: int) -> torch.Tensor:
    """[a, b, kh, kw] -> block-diagonal [g*a, g*b, kh, kw]: block (i, i)
    holds w, every other block is zero."""
    a, b, kh, kw = w.shape
    eye = torch.eye(g, dtype=w.dtype, device=w.device)
    blocks = torch.einsum("abhw,gk->gakbhw", w, eye)
    return blocks.reshape(g * a, g * b, kh, kw)


def pack_params(params, g: int):
    """Lift every conv weight to block-diagonal and tile its bias; the
    activation params (the shared PReLU slope) pass through."""

    def walk(p):
        if isinstance(p, dict):
            if "w" in p and "b" in p:
                return {"w": _pack_w(p["w"], g), "b": p["b"].repeat(g)}
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v) for v in p]
        return p

    return walk(params)


def _gconcat(a: torch.Tensor, b: torch.Tensor, g: int) -> torch.Tensor:
    """Group-aware channel concat: [..., g*ca] + [..., g*cb] ->
    [..., g*(ca+cb)] with each group's channel blocks kept together (the
    layout the block-diagonal weights contract against)."""
    lead = tuple(a.shape[:-1])
    ca, cb = a.shape[-1] // g, b.shape[-1] // g
    a5 = a.reshape(lead + (g, ca))
    b5 = b.reshape(lead + (g, cb))
    return torch.cat([a5, b5], dim=-1).reshape(lead + (g * (ca + cb),))


def pack_batch(x: torch.Tensor, g: int) -> torch.Tensor:
    """[B, H, W, C] -> [B/g, H, W, g*C] (group-major channels)."""
    b, h, w, c = x.shape
    return (x.reshape(b // g, g, h, w, c).permute(0, 2, 3, 1, 4)
            .reshape(b // g, h, w, g * c))


def unpack_batch(y: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of pack_batch."""
    bg, h, w, gc = y.shape
    return (y.reshape(bg, h, w, g, gc // g).permute(0, 3, 1, 2, 4)
            .reshape(bg * g, h, w, gc // g))


def _split_packed_rows(w: torch.Tensor, splits, g: int):
    """Split a packed block-diagonal weight's input rows per concat part.

    w: OIHW [co, g*sum(splits), kh, kw] whose input rows are group-major
    over the concatenated per-group channel blocks (the `_gconcat`
    layout). Returns one [co, g*ci, kh, kw] weight per part, each
    contracting against a separately packed input:
    conv(concat(xs)) == sum_i conv(x_i, w_i)."""
    co, _, kh, kw = w.shape
    tot = sum(splits)
    w5 = w.reshape(co, g, tot, kh, kw)
    outs, start = [], 0
    for ci in splits:
        outs.append(w5[:, :, start : start + ci].reshape(co, g * ci, kh, kw))
        start += ci
    return tuple(outs)


def uses_kernel(cfg: ModelConfig) -> bool:
    """True when `apply_packed` sends the DoubleConvs to K3."""
    return (cfg.double_conv_mode == "pallas" and cfg.precision == "default"
            and cfg.activation_function in ("prelu", "relu"))


def _k3_params(p, w1s, post=None) -> dict:
    fp = {
        "c1": {"w": tuple(w1s), "b": p["c1"]["b"]},
        "act": p["act"] if "a" in p.get("act", {}) else {},
        "c2": p["c2"],
    }
    if post is not None:  # fold a trailing 1x1 conv (outc)
        fp["post"] = post
    return fp


def k3_takes(p, cins, post=None) -> bool:
    """Whether K3 takes the packed DoubleConv `p` (with the head `post`)
    on input parts of `cins` channels, from the weights' shapes alone."""
    cm, co = int(p["c1"]["w"].shape[0]), int(p["c2"]["w"].shape[0])
    ce = co if post is None else int(post["w"].shape[0])
    return k3_supported(1, 1, cins, cm, co, ce)


def prepare_k3(packed_params, cfg: ModelConfig, g: int, inc_splits=None):
    """The packed params with the K3 weights of each DoubleConv that K3
    takes (`k3_takes`) converted once (`ops.packed_double_conv.prepare`)
    and kept under `K3_KEY`; the others are left for cuDNN.

    `inc_splits` are the per-group widths of the input parts of `inc`
    (default one part of `cfg.in_channels`; `rollout_packed` feeds three
    of 2). `apply_packed` takes a prepared entry as it is (the K3 wrapper
    raises if its input parts differ) and converts on the fly where there
    is none."""
    inc_splits = (cfg.in_channels,) if inc_splits is None else tuple(inc_splits)

    def prep(p, splits, post=None):
        if not k3_takes(p, [g * c for c in splits], post):
            return p
        w1s = (_split_packed_rows(p["c1"]["w"], splits, g) if len(splits) > 1
               else (p["c1"]["w"],))
        return dict(p, **{K3_KEY: prepare(_k3_params(p, w1s, post))})

    f, s = cfg.features, cfg.state_channels
    out = dict(packed_params, inc=prep(packed_params["inc"], inc_splits))
    out["enc"] = []
    for d, blk in enumerate(packed_params["enc"]):
        blk = dict(blk)
        if d < cfg.state_depth:
            blk["conv_signal"] = prep(blk["conv_signal"], (f, s))
            blk["conv_state"] = prep(blk["conv_state"], (f, s))
        else:
            blk["conv_signal"] = prep(blk["conv_signal"], (f,))
        out["enc"].append(blk)
    out["decode"] = [
        prep(p, (f,) if i == cfg.depth else (f, f),
             packed_params["outc"] if i == 0 else None)
        for i, p in enumerate(packed_params["decode"])
    ]
    return out


def apply_packed(
    packed_params,
    x,
    states: Tuple[torch.Tensor, ...],
    *,
    cfg: ModelConfig,
    g: int,
) -> tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """hybridnet.apply on packed tensors ([B', H, W, g*C] throughout).

    `x` may be a tuple of packed tensors whose group-aware concatenation
    forms the network input; in the K3 mode the concat never materializes
    (per-part weight slices instead)."""
    prec = cfg.precision
    act = cfg.activation_function
    use_kernel = uses_kernel(cfg)

    def dconv(p, *parts, post=None):
        if use_kernel and k3_takes(p, [int(t.shape[-1]) for t in parts], post):
            parts = tuple(t.contiguous() for t in parts)
            pw = p.get(K3_KEY)  # prepared by `prepare_k3`, else converted here
            if pw is None:
                w1s = (_split_packed_rows(p["c1"]["w"],
                                          [t.shape[-1] // g for t in parts], g)
                       if len(parts) > 1 else (p["c1"]["w"],))
                pw = _k3_params(p, w1s, post)
            return packed_double_conv(pw, parts)
        t = parts[0]
        for extra in parts[1:]:
            t = _gconcat(t, extra, g)
        h = double_conv(p, t, act, prec)
        if post is not None:
            h = conv2d(post, h, precision=prec)
        return h

    parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    x = dconv(packed_params["inc"], *parts)
    inner_signals = []
    new_states = []
    for d in range(cfg.depth):
        blk = packed_params["enc"][d]
        if d < cfg.state_depth:
            out = dconv(blk["conv_signal"], x, states[d])
            new_states.append(dconv(blk["conv_state"], out, states[d]))
        else:
            out = dconv(blk["conv_signal"], x)
        inner_signals.append(out)
        x = conv2d(blk["down"], out, stride=2, padding=3, precision=prec)

    up = conv_transpose2d_subpixel if cfg.up_mode == "subpixel" else conv_transpose2d
    x = dconv(packed_params["decode"][-1], x)
    for d in range(cfg.depth - 1, 0, -1):
        x = up(packed_params["up"][d], x, stride=2, padding=3, precision=prec)
        x = dconv(packed_params["decode"][d], x, inner_signals[d])
    # last decoder level with the 1x1 outc head folded in
    x = up(packed_params["up"][0], x, stride=2, padding=3, precision=prec)
    out = dconv(packed_params["decode"][0], x, inner_signals[0],
                post=packed_params["outc"])
    return out, tuple(new_states)


# ---------------------------------------------------------------------------
# The residual in packed layout (plain f32 matmuls, as the JAX package
# computes it outside any Pallas kernel)
# ---------------------------------------------------------------------------


def laplacian_packed(op: SpectralPML, u: torch.Tensor, g: int) -> torch.Tensor:
    """Spectral PML Laplacian on packed fields [B', H, W, g*2]: the two
    dense per-axis complex matmuls of ops/spectral.laplacian_matmul,
    contracted against a [B', H, W, g, 2] view."""
    lead = tuple(u.shape[:-1])
    v = u.reshape(lead + (g, 2))

    def cmul(m_r, m_i, sub):
        pr = torch.einsum(sub, m_r, v)
        pi = torch.einsum(sub, m_i, v)
        re = pr[..., 0] - pi[..., 1]
        im = pr[..., 1] + pi[..., 0]
        return torch.stack([re, im], dim=-1)

    ly = cmul(op.ay_r, op.ay_i, "hj,bjwgc->bhwgc")
    lx = cmul(op.ax_r, op.ax_i, "wj,bhjgc->bhwgc")
    return (lx + ly).reshape(lead + (g * 2,))


def residual_packed(op: SpectralPML, u: torch.Tensor, k_sq_p: torch.Tensor,
                    source_p: torch.Tensor, g: int) -> torch.Tensor:
    """r = L u + k^2 u - s in packed layout. u, source_p: [B', H, W, g*2];
    k_sq_p: [B', H, W, g] (packed k^2)."""
    lead = tuple(u.shape[:-1])
    ku = (k_sq_p[..., None] * u.reshape(lead + (g, 2))).reshape(lead + (g * 2,))
    return laplacian_packed(op, u, g) + ku - source_p


def rmse_packed(residual_p: torch.Tensor, g: int) -> torch.Tensor:
    """Per-problem residual RMSE from packed layout -> [B'*g] in the
    original batch order."""
    b, h, w, _ = residual_p.shape
    r = residual_p.reshape(b, h, w, g, 2)
    return torch.sqrt(torch.mean(r**2, dim=(1, 2, 4))).reshape(b * g)


COLLECT = ("rmse", "best")


@torch.no_grad()
def rollout_packed(
    params,
    op: SpectralPML,
    source,
    sos_maps,
    *,
    cfg: Config,
    g: int,
    num_iterations: int,
    collect: tuple = ("rmse",),
    device=None,
):
    """Inference rollout with the whole iteration channel-packed.

    The same math as solvers.iterative.rollout (the block-diagonal zeros
    are exact); needs batch % g == 0 and the matmul operator. Fields,
    residuals and k^2 stay packed [B/g, H, W, g*C] from entry to exit.
    collect ⊆ {'rmse', 'best'}. Returns 'wavefield' and 'residual'
    (unpacked finals), 'rmse' [iterations, B] and, with 'best',
    'best_wavefield' and 'best_rmse'.
    """
    unknown = set(collect) - set(COLLECT)
    if unknown:
        raise ValueError(f"rollout_packed collects {COLLECT}, not {sorted(unknown)}")
    dev = resolve_device(device)
    sos_maps = _on(sos_maps, dev)
    b = sos_maps.shape[0]
    if b % g:
        raise ValueError(f"batch {b} must be divisible by pack group {g}")
    mode = resolve_mode(cfg.operator_mode, sos_maps.shape[-2], sos_maps.shape[-1])
    if mode != "matmul":
        raise ValueError("rollout_packed supports the matmul operator only")
    mcfg = cfg.model
    op = op.to(dev)
    source = _on(source, dev)
    packed = pack_params(params_to(params, dev), g)
    if uses_kernel(mcfg):
        packed = prepare_k3(packed, mcfg, g, inc_splits=(2, 2, 2))
    k_sq, wavefield = get_initials(sos_maps, cfg.source.omega)
    wf_p = pack_batch(wavefield, g)
    k_sq_p = pack_batch(k_sq[..., None], g)
    src_p = pack_batch(source, g)
    res_p = residual_packed(op, wf_p, k_sq_p, src_p, g)
    dims = states_dimension(tuple(sos_maps.shape[1:3]), mcfg.depth)
    states = tuple(
        torch.zeros((b // g,) + dims[d] + (g * mcfg.state_channels,),
                    dtype=sos_maps.dtype, device=dev)
        for d in range(mcfg.state_depth)
    )
    # PML sigma channels, tiled per group: [B/g, H, W, g*2]
    sigmas_hwc = op.sigmas.permute(1, 2, 0)
    sig_p = (sigmas_hwc.repeat(1, 1, g)[None]
             .expand((b // g,) + tuple(sigmas_hwc.shape[:2]) + (g * 2,))
             .contiguous())
    track_best = "best" in collect
    best_wf = wf_p
    best_rmse = torch.full((b,), float("inf"), dtype=sos_maps.dtype, device=dev)
    rmses = []
    for _ in range(num_iterations):
        d_p, states = apply_packed(
            packed, (wf_p, RESIDUAL_SCALE * res_p, sig_p), states, cfg=mcfg, g=g)
        wf_p = d_p / RESIDUAL_SCALE + wf_p
        res_p = residual_packed(op, wf_p, k_sq_p, src_p, g)
        rmse = rmse_packed(res_p, g)
        if track_best:
            better = rmse < best_rmse  # [b]; False for NaN
            lead = tuple(wf_p.shape[:-1])
            best_wf = torch.where(
                better.reshape(b // g, 1, 1, g, 1),
                wf_p.reshape(lead + (g, 2)),
                best_wf.reshape(lead + (g, 2)),
            ).reshape(wf_p.shape)
            # NOT torch.minimum: NaN from a diverging trajectory must not
            # poison the best-so-far
            best_rmse = torch.where(better, rmse, best_rmse)
        if "rmse" in collect:
            rmses.append(rmse)
    out = {
        "wavefield": unpack_batch(wf_p, g),
        "residual": unpack_batch(res_p, g),
    }
    if track_best:
        out["best_wavefield"] = unpack_batch(best_wf, g)
        out["best_rmse"] = best_rmse
    if "rmse" in collect:
        out["rmse"] = torch.stack(rmses)
    return out

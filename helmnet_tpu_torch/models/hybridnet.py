"""HybridNet — the modified UNet with learned multi-resolution hidden state.

Port of `helmnet_tpu/models/hybridnet.py`. The hidden states are an
explicit tuple carried through the call:

    out, new_states = apply(params, x, states, cfg=...)

States are NHWC `[B, n_d, n_d, state_channels]` with n_d = domain_size/2^d
for encoder level d < state_depth. `flatten_states` / `unflatten_states`
keep the reference's flat `[B, C, sum(n_d^2)]` channel-first layout.

`double_conv_mode='pallas'` (with precision 'default' and PReLU or ReLU)
sends every DoubleConv to the fused CUDA kernel (ops/double_conv.py): 14
per step at depth 4, with the 1x1 outc head folded into the last one. The
JAX package falls back to XLA at the 24^2, 12^2 and 6^2 levels only
because its TPU kernel packs 16 pixels per lane row
(`pallas_pixconv.py:234-247`); the CUDA kernel masks ragged tiles and has
no such limit, and the function computed is the same. A width the
kernel does not take (more than 16 channels) raises there; it does not
fall back. `prepare_k1` converts the kernel's weights once
(`solvers/iterative.rollout` calls it through `prepare_params` once per
rollout) and keeps them
under `K1_KEY`; `apply` converts them in the call where they are
missing. Otherwise (`'xla'`) the DoubleConvs are cuDNN convs in f32.

`apply(..., spatial=)` runs on this rank's tiles of a grid split over the
mesh axes y and x (distributed/spatial.py): x, out and every state are
tiles, and every conv exchanges its halo. A level that does not split
over an axis runs whole along it (`Spatial.level`): the strided conv
into it reads its input gathered along that axis (`Spatial.enter`), the
transposed conv out of it is cut to the rank's tile (`Spatial.leave`),
and its state is whole along the axis. That is the `'xla'` path; K1
pads each tile with zeros inside the kernel, so `'pallas'` mode refuses
a spatial partition.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.config import ModelConfig
from ..ops.double_conv import fused_double_conv, prepare
from .blocks import (
    conv2d,
    conv_transpose2d,
    conv_transpose2d_subpixel,
    double_conv,
    init_conv,
    init_conv_transpose,
    init_double_conv,
)


K1_KEY = "k1"  # a DoubleConv's prepared K1 weights in a params tree


def uses_kernel(cfg: ModelConfig) -> bool:
    """True when `apply` sends the DoubleConvs to K1."""
    return (cfg.double_conv_mode == "pallas" and cfg.precision == "default"
            and cfg.activation_function in ("prelu", "relu"))


def prepare_params(params, cfg: ModelConfig):
    """The params a rollout runs on (the registry contract): with K1's
    weights converted once (`prepare_k1`) when `apply` sends the
    DoubleConvs to K1, else the params as they are."""
    return prepare_k1(params, cfg) if uses_kernel(cfg) else params


def prepare_k1(params, cfg: ModelConfig):
    """The params with each DoubleConv's K1 weights converted once
    (`ops.double_conv.prepare`, the outc head folded into `decode[0]`'s)
    and kept under `K1_KEY`, on the weights' device."""

    def prep(p, post=None):
        if K1_KEY in p:  # prepared already
            return p
        return dict(p, **{K1_KEY: prepare(p if post is None else dict(p, post=post))})

    out = dict(params, inc=prep(params["inc"]))
    out["enc"] = [
        {k: prep(v) if k.startswith("conv_") else v for k, v in blk.items()}
        for blk in params["enc"]
    ]
    out["decode"] = [prep(p, params["outc"] if i == 0 else None)
                     for i, p in enumerate(params["decode"])]
    return out


def states_dimension(domain_size, depth: int, spatial=None) -> list[tuple[int, int]]:
    """Per-level state grid sizes [(H/2^d, W/2^d)]. `domain_size` may be an
    int (square) or an (H, W) tuple. With `spatial`, this rank's part of
    each level (`Spatial.level`), and `domain_size` is not read."""
    if spatial is not None:
        return [(spatial.level(d).tile_h, spatial.level(d).tile_w)
                for d in range(depth)]
    if isinstance(domain_size, int):
        h = w = domain_size
    else:
        h, w = domain_size
    return [(h // (2**d), w // (2**d)) for d in range(depth)]


def init_params(generator: torch.Generator, cfg: ModelConfig):
    """Random parameters in the port's layout, on the generator's device.

    The draws differ from `jax.random`'s; weights shared with the JAX
    package go through `weights.py`.
    """
    act = cfg.activation_function
    gen = generator
    params = {
        "inc": init_double_conv(gen, cfg.in_channels, cfg.features, act),
        "enc": [],
        "decode": [],
        "up": [],
        "outc": init_conv(gen, 1, cfg.features, 2),
    }
    for d in range(cfg.depth):
        use_state = d < cfg.state_depth
        blk = {
            "conv_signal": init_double_conv(
                gen,
                cfg.features + (cfg.state_channels if use_state else 0),
                cfg.features,
                act,
            ),
            "down": init_conv(gen, 8, cfg.features, cfg.features),
        }
        if use_state:
            blk["conv_state"] = init_double_conv(
                gen, cfg.features + cfg.state_channels, cfg.state_channels, act
            )
        params["enc"].append(blk)
    for i in range(cfg.depth + 1):
        cin = cfg.features + cfg.features * (i < cfg.depth)
        params["decode"].append(init_double_conv(gen, cin, cfg.features, act))
    for _ in range(cfg.depth):
        params["up"].append(init_conv_transpose(gen, 8, cfg.features, cfg.features))
    return params


def init_states(
    batch: int, domain_size, cfg: ModelConfig, dtype=torch.float32, device="cpu",
    spatial=None,
) -> Tuple[torch.Tensor, ...]:
    """Zero hidden states (with `spatial`, this rank's parts)."""
    dims = states_dimension(domain_size, cfg.depth, spatial)
    return tuple(
        torch.zeros((batch,) + dims[d] + (cfg.state_channels,), dtype=dtype,
                    device=device)
        for d in range(cfg.state_depth)
    )


def apply(
    params,
    x: torch.Tensor,
    states: Sequence[torch.Tensor],
    *,
    cfg: ModelConfig,
    spatial=None,
) -> tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Forward pass. x: [B, H, W, in_channels] NHWC. Returns
    (out[B, H, W, 2], new_states). With `spatial`, x, the states and the
    outputs are this rank's tiles."""
    act = cfg.activation_function
    prec = cfg.precision
    use_kernel = uses_kernel(cfg)
    if use_kernel and spatial is not None:
        raise ValueError(
            "double_conv_mode='pallas' cannot run on a grid split over the "
            "mesh axes y and x: K1 pads each tile with zeros, not with its "
            "neighbours' rows; use double_conv_mode='xla'")

    if spatial is None:
        lv = lambda d: None
        enter = leave = lambda t, d: t
    else:
        lv, enter, leave = spatial.level, spatial.enter, spatial.leave

    def dconv(p, *parts, post=None, d=0):
        if use_kernel:
            pw = p.get(K1_KEY)  # prepared by `prepare_k1`, else converted there
            if pw is None:
                pw = p if post is None else dict(p, post=post)
            return fused_double_conv(pw, tuple(t.contiguous() for t in parts))
        t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        h = double_conv(p, t, act, prec, spatial=lv(d))
        if post is not None:
            h = conv2d(post, h, precision=prec)
        return h

    x = dconv(params["inc"], x)

    inner_signals = []
    new_states = []
    for d in range(cfg.depth):
        blk = params["enc"][d]
        if d < cfg.state_depth:
            out = dconv(blk["conv_signal"], x, states[d], d=d)
            new_states.append(dconv(blk["conv_state"], out, states[d], d=d))
        else:
            out = dconv(blk["conv_signal"], x, d=d)
        inner_signals.append(out)
        x = conv2d(blk["down"], enter(out, d + 1), stride=2, padding=3,
                   precision=prec, spatial=lv(d + 1))

    up = conv_transpose2d_subpixel if cfg.up_mode == "subpixel" else conv_transpose2d
    x = dconv(params["decode"][-1], x, d=cfg.depth)
    for d in range(cfg.depth - 1, 0, -1):
        x = leave(up(params["up"][d], x, stride=2, padding=3, precision=prec,
                     spatial=lv(d + 1)), d + 1)
        x = dconv(params["decode"][d], x, inner_signals[d], d=d)
    # last decoder level with the 1x1 outc head folded in
    x = leave(up(params["up"][0], x, stride=2, padding=3, precision=prec,
                 spatial=lv(1)), 1)
    out = dconv(params["decode"][0], x, inner_signals[0], post=params["outc"])
    return out, tuple(new_states)


# ---------------------------------------------------------------------------
# State pack/unpack — flat layout [B, C, sum(n_d^2)], channel-first
# ---------------------------------------------------------------------------


def flatten_states(states: Sequence[torch.Tensor]) -> torch.Tensor:
    flat = []
    for s in states:
        b, h, w, c = s.shape
        flat.append(s.permute(0, 3, 1, 2).reshape(b, c, h * w))
    return torch.cat(flat, dim=2)


def unflatten_states(
    flat: torch.Tensor, domain_size, cfg: ModelConfig, spatial=None
) -> Tuple[torch.Tensor, ...]:
    dims = states_dimension(domain_size, cfg.depth, spatial)
    states = []
    start = 0
    b, c = flat.shape[0], flat.shape[1]
    for d in range(cfg.state_depth):
        hd, wd = dims[d]
        chunk = flat[:, :, start : start + hd * wd]
        states.append(chunk.reshape(b, c, hd, wd).permute(0, 2, 3, 1).contiguous())
        start += hd * wd
    return tuple(states)


def total_state_length(domain_size, cfg: ModelConfig) -> int:
    dims = states_dimension(domain_size, cfg.depth)
    return sum(h * w for h, w in dims[: cfg.state_depth])


def iter_leaves(tree, prefix=""):
    """(path, tensor) pairs in the JAX package's tree order: dict keys
    sorted at every level, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def map_leaves(tree, fn, prefix=""):
    """The same tree with each leaf replaced by fn(path, leaf), paths as in
    `iter_leaves`."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return fn(prefix, tree)


def count_params(params) -> int:
    return sum(t.numel() for _, t in iter_leaves(params))


def params_to(params, device):
    """The same tree with every tensor moved to `device`."""
    return map_leaves(params, lambda _, t: t.to(device))

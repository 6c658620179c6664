"""Operations and bytes counted from shapes, and the chip's peaks.

The yardstick of the roofline and MFU metrics. The peaks, `step_calls`,
`bound` and `busy_share` are frozen copies of `chip_smoke.py`'s, and
`conv_flops` is its `conv_flops3d` on a grid of either rank (all tied to
the originals by `tests/test_portbench_frozen.py`).

Params trees here are the program's layout of the weights' shapes (a
conv's `w` [O, I, k...], a transposed conv's [I, O, k...]); tensors on
the `meta` device serve, since only shapes are read.
"""

from __future__ import annotations

import torch

from .reference.unet import DOUBLE_CONV

# Published H100 SXM peaks (NVIDIA data sheet, dense) at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
PEAKS = {"bf16": PEAK_BF16_FLOPS, "tf32": PEAK_TF32_FLOPS, "f32": PEAK_F32_FLOPS}


def shape_tree(weights: dict, depth: int, state_depth: int) -> dict:
    """The program-layout params tree of the reference's npz weights
    (`reference.unet.load_weights`), as `meta` tensors of their shapes."""
    def t(name):
        w = weights[name]
        if w.dim() < 3:
            return torch.empty(w.shape, device="meta")
        nd = w.dim() - 2
        # (D)HWIO -> O I k..., and flipped (D)HWIO -> I O k... for up convs
        order = (nd, nd + 1) if name.startswith("up.") else (nd + 1, nd)
        return torch.empty(w.permute(*order, *range(nd)).shape, device="meta")

    def dc(prefix):
        leaves = {k: t(f"{prefix}.{k}") for k in DOUBLE_CONV}
        return {"act": {"a": leaves["act.a"]},
                "c1": {"w": leaves["c1.w"], "b": leaves["c1.b"]},
                "c2": {"w": leaves["c2.w"], "b": leaves["c2.b"]}}

    conv = lambda prefix: {"w": t(f"{prefix}.w"), "b": t(f"{prefix}.b")}
    enc = []
    for d in range(depth):
        blk = {"conv_signal": dc(f"enc.{d}.conv_signal"), "down": conv(f"enc.{d}.down")}
        if d < state_depth:
            blk["conv_state"] = dc(f"enc.{d}.conv_state")
        enc.append(blk)
    return {"inc": dc("inc"), "enc": enc,
            "decode": [dc(f"decode.{i}") for i in range(depth + 1)],
            "up": [conv(f"up.{i}") for i in range(depth)], "outc": conv("outc")}


def step_calls(params, model, n: int):
    """The 14 DoubleConv calls of one solver step: (name, params, grid,
    input part channels)."""
    f, sc, depth = model.features, model.state_channels, model.depth
    calls = [("inc", params["inc"], n, (model.in_channels,))]
    for d in range(depth):
        blk = params["enc"][d]
        calls.append((f"enc[{d}].conv_signal", blk["conv_signal"], n >> d, (f, sc)))
        calls.append((f"enc[{d}].conv_state", blk["conv_state"], n >> d, (f, sc)))
    calls.append((f"decode[{depth}]", params["decode"][depth], n >> depth, (f,)))
    for d in range(depth - 1, 0, -1):
        calls.append((f"decode[{d}]", params["decode"][d], n >> d, (f, f)))
    post = dict(params["decode"][0], post=params["outc"])
    calls.append(("decode[0]+outc", post, n, (f, f)))
    return calls


def bound(p, parts, out) -> tuple[float, float, float, float]:
    """(flops, ops_ms, bytes_ms, cuda_core_ms) of one call: operations at
    the bf16 tensor-core peak, and each input read once and each output
    written once at the HBM rate; the bound is the larger of the two.
    cuda_core_ms is the same operations at the f32 CUDA-core peak, the
    ceiling of a kernel that runs its FMAs there."""
    b, h, w, _ = out.shape
    cin = sum(t.shape[-1] for t in parts)
    cm, co = p["c1"]["w"].shape[0], p["c2"]["w"].shape[0]
    macs = cin * cm * 9 + cm * co * 9
    if "post" in p:
        macs += co * p["post"]["w"].shape[0]
    flops = 2.0 * b * h * w * macs
    weights = sum(t.numel() for v in p.values() for t in v.values())
    nbytes = 4.0 * (sum(t.numel() for t in parts) + out.numel() + weights)
    return (flops, 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_S,
            1e3 * flops / PEAK_F32_FLOPS)


def conv_flops(params, depth: int, n: int, nd: int) -> float:
    """Operations of one network apply on one n^nd field, counted from the
    weights' shapes: 2 x MACs of every conv at its output grid, a stride-2
    transposed conv as its 2^nd phase convs of (k/2)^nd taps each
    (`chip_smoke.conv_flops3d` at nd = 3)."""
    pts = lambda level: (n >> level) ** nd
    macs = lambda p: p["w"].shape[0] * p["w"].shape[1] * p["w"][0, 0].numel()
    dconv = lambda p, level: pts(level) * (macs(p["c1"]) + macs(p["c2"]))
    total = dconv(params["inc"], 0) + pts(0) * macs(params["outc"])
    for d in range(depth):
        blk = params["enc"][d]
        total += sum(dconv(blk[k], d) for k in ("conv_signal", "conv_state") if k in blk)
        total += pts(d + 1) * macs(blk["down"]) + pts(d) * macs(params["up"][d]) / 2**nd
    total += sum(dconv(params["decode"][d], d) for d in range(depth + 1))
    return 2.0 * total


def operator_flops(n: int, nd: int) -> float:
    """Operations of one dense operator apply on one n^nd field: along each
    axis four real products (two [n, n] matrices times the field's real
    and imaginary parts), 2 n flops an output value each."""
    return nd * 4 * (2.0 * n) * n**nd


def busy_share(device_ms: float, wall_s: float) -> float:
    """chip_smoke.profile_steps' busy share: device time over the wall."""
    return device_ms / (1e3 * wall_s)

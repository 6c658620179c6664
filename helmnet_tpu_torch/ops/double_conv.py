"""Fused DoubleConv: the port of the TPU kernel `fused_double_conv_pix`
(`helmnet_tpu/ops/pallas_pixconv.py:251`) to a CUDA kernel for Hopper
(`csrc/double_conv.cu`).

It computes conv3x3 (pad 1) -> PReLU (one shared slope; ReLU when `act`
holds none) -> conv3x3 (pad 1), with an optional trailing 1x1 conv
(`post`, the UNet's outc head). The input may be a tuple of NHWC parts
whose channel concatenation feeds the first conv. Taps are bf16 and sums
f32, as on the TPU.

Params take the schema of `fused_double_conv_pix`, in the port's weight
layout (models/blocks.py): `{"c1": {"w": OIHW or a tuple of per-part
OIHW slices, "b"}, "act": {"a": [1]} or {}, "c2": {"w", "b"},
optional "post": {"w": [c_emit, cout, 1, 1], "b"}}`.

- `double_conv_plain` is the same function in plain PyTorch, with the
  kernel's bf16 roundings. The CPU tests use it, and `chip_smoke.py`
  holds the kernel against it on the card.
- `fused_double_conv` launches the kernel for CUDA tensors, or raises.
  It takes the plain version only for tensors on the CPU.
  `fused_double_conv.launches` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

MAX_CHANNELS = 16
MAX_PARTS = 2


def _parts(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _w1(params) -> torch.Tensor:
    w1 = params["c1"]["w"]
    return torch.cat(tuple(w1), dim=1) if isinstance(w1, (tuple, list)) else w1


def _slope(params):
    act = params.get("act") or {}
    return act.get("a")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def double_conv_plain(params, x) -> torch.Tensor:
    """The kernel's function in plain PyTorch: bf16-rounded x, h1, h2 and
    weights, f32 sums, bias and PReLU. NHWC in, NHWC out."""
    parts = _parts(x)
    xcat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    xn = _bf16(xcat.float()).permute(0, 3, 1, 2)
    h = F.conv2d(xn, _bf16(_w1(params)), params["c1"]["b"], padding=1)
    a = _slope(params)
    h = torch.clamp_min(h, 0) + (0.0 if a is None else a * torch.clamp_max(h, 0))
    h = F.conv2d(_bf16(h), _bf16(params["c2"]["w"]), params["c2"]["b"], padding=1)
    post = params.get("post")
    if post:
        h = F.conv2d(_bf16(h), _bf16(post["w"]), post["b"])
    return h.permute(0, 2, 3, 1).contiguous()


def supported(height: int, width: int, cin, cmid: int, cout: int,
              c_emit: int | None = None) -> bool:
    """True when the kernel takes these shapes. `cin` may be a sequence of
    per-part channel counts. Counterpart of `pix_supported`, without its
    TPU-only limits (W % 16 == 0, (H*W/16) % 8 == 0): the CUDA kernel
    masks the ragged edge tiles itself."""
    cins = (cin,) if isinstance(cin, int) else tuple(cin)
    c_emit = cout if c_emit is None else c_emit
    return (
        height > 0 and width > 0
        and 1 <= len(cins) <= MAX_PARTS and all(c > 0 for c in cins)
        and sum(cins) <= MAX_CHANNELS
        and 0 < cmid <= MAX_CHANNELS and 0 < cout <= MAX_CHANNELS
        and 0 < c_emit <= MAX_CHANNELS
    )


def _check(name: str, t: torch.Tensor, device: torch.device, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def fused_double_conv(params, x) -> torch.Tensor:
    """DoubleConv (+ optional 1x1 head) as one CUDA kernel launch.

    Shapes the kernel does not take raise on every device. Within them,
    CPU tensors take `double_conv_plain`; CUDA tensors launch the kernel or
    raise. Returns `[B, H, W, c_emit]` f32.
    """
    parts = _parts(x)
    device = parts[0].device
    b, h, w = parts[0].shape[:3]
    cins = [int(p.shape[-1]) for p in parts]
    w1 = _w1(params)
    cm, co = int(w1.shape[0]), int(params["c2"]["w"].shape[0])
    post = params.get("post")
    ce = int(post["w"].shape[0]) if post else co
    if not supported(h, w, cins, cm, co, ce):
        raise ValueError(
            f"unsupported DoubleConv: parts {cins} -> {cm} -> {co} -> {ce} "
            f"at {h}x{w} (at most {MAX_PARTS} parts and {MAX_CHANNELS} "
            f"channels each)"
        )
    if device.type == "cpu":
        return double_conv_plain(params, parts)
    if device.type != "cuda":
        raise ValueError(f"fused_double_conv runs on cuda or cpu, not {device}")
    for i, p in enumerate(parts):
        _check(f"x[{i}]", p, device, (b, h, w, cins[i]))
    _check("c1.w", w1, device, (cm, sum(cins), 3, 3))
    _check("c1.b", params["c1"]["b"], device, (cm,))
    _check("c2.w", params["c2"]["w"], device, (co, cm, 3, 3))
    _check("c2.b", params["c2"]["b"], device, (co,))
    slope = _slope(params)
    if slope is not None:
        _check("act.a", slope, device, (1,))
    if post:
        _check("post.w", post["w"], device, (ce, co, 1, 1))
        _check("post.b", post["b"], device, (ce,))

    from .._build import load_library

    lib = load_library()
    out = torch.empty((b, h, w, ce), dtype=torch.float32, device=device)
    x2 = parts[1] if len(parts) > 1 else None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hn_double_conv(
            _ptr(parts[0]), cins[0], _ptr(x2), cins[1] if x2 is not None else 0,
            _ptr(w1), _ptr(params["c1"]["b"]), _ptr(slope),
            _ptr(params["c2"]["w"]), _ptr(params["c2"]["b"]),
            _ptr(post["w"] if post else None), _ptr(post["b"] if post else None),
            _ptr(out), b, h, w, cm, co, ce, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"hn_double_conv launch failed: CUDA error {rc}")
    fused_double_conv.launches += 1
    return out


fused_double_conv.launches = 0

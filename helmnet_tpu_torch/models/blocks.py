"""Convolution building blocks, port of `helmnet_tpu/models/blocks.py`.

Functional, NHWC at the boundary, params as plain dicts of tensors.
Weights are kept in PyTorch's layouts: a conv's `w` is OIHW
`[O, I, kh, kw]`, a transposed conv's `w` is ConvTranspose2d's
`[I, O, kh, kw]` (not flipped). The JAX package keeps HWIO, with the
transposed-conv kernel stored spatially flipped; `hwio_to_torch_conv` and
`hwio_to_torch_convtranspose` convert its weights, and the two
`torch_*_to_hwio` functions go the other way.

The convs are cuDNN calls (`F.conv2d`, `F.conv_transpose2d`), as XLA ran
them on the TPU. An NHWC tensor permuted to NCHW is a channels-last
tensor, so the permutes around each call move no data.

Spatial partition: with `spatial` (distributed/spatial.Spatial) each
conv takes and returns this rank's tile of its input and output. The
zero padding becomes a halo exchange (`spatial.pad`: the neighbouring
tiles' rows, zeros only at the domain edge), then the same cuDNN call
with padding 0; a transposed conv runs on the halo-padded tile and is
cropped to its own output rows.

Precision: on the card TF32 is off (core/device.py), so these convs run in
f32 under every precision name. The names are validated and kept for
parity with the JAX package's config; 'default' is what selects the bf16
fused DoubleConv kernel in models/hybridnet.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .activations import get_activation

PRECISIONS = ("default", "high", "highest")


def resolve_precision(name: str) -> str:
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}; expected one of {PRECISIONS}")
    return name


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def conv2d(params, x, *, stride: int = 1, padding: int = 0,
           precision: str = "highest", spatial=None):
    """2D convolution, NHWC x OIHW -> NHWC, torch Conv2d semantics."""
    resolve_precision(precision)
    if spatial is not None:
        # output j reads input rows stride*j - padding ... + k - 1
        k = params["w"].shape[-1]
        x = spatial.pad(x, padding, k - stride - padding)
        padding = 0
    y = F.conv2d(_nchw(x), params["w"], params["b"], stride=stride,
                 padding=padding)
    return _nhwc(y)


def _transposed_tile(fn, params, x, stride, padding, spatial):
    """A transposed conv of this rank's tile: `fn` on the tile with its halo
    (output o reads input rows (o + padding - k + 1)/stride ...
    (o + padding)/stride), cropped to the tile's own output rows."""
    k = params["w"].shape[-1]
    lo = -((padding - k + 1) // stride)
    hi = (padding - 1) // stride + 1
    h, w = x.shape[1], x.shape[2]
    y = fn(params, spatial.pad(x, lo, hi), stride=stride, padding=padding)
    return y[:, stride * lo : stride * (lo + h), stride * lo : stride * (lo + w)]


def conv_transpose2d(params, x, *, stride: int = 2, padding: int = 3,
                     precision: str = "highest", spatial=None):
    """Torch ConvTranspose2d(k, stride, padding, output_padding=0) semantics:
    the JAX package's input-dilated conv (pad k - 1 - padding, flipped
    kernel) computes the same function."""
    resolve_precision(precision)
    if spatial is not None:
        return _transposed_tile(conv_transpose2d, params, x, stride, padding,
                                spatial)
    y = F.conv_transpose2d(_nchw(x), params["w"], params["b"], stride=stride,
                           padding=padding)
    return _nhwc(y)


def conv_transpose2d_subpixel(params, x, *, stride: int = 2, padding: int = 3,
                              precision: str = "highest", spatial=None):
    """Same math as `conv_transpose2d` (k=8, s=2, p=3) as four k/2-tap convs
    at input resolution, one per output phase (a, b) = (row%2, col%2),
    interleaved afterwards (sub-pixel convolution)."""
    resolve_precision(precision)
    if spatial is not None:
        return _transposed_tile(conv_transpose2d_subpixel, params, x, stride,
                                padding, spatial)
    w = params["w"]  # [I, O, k, k]
    k = w.shape[-1]
    if stride != 2 or k % 2:
        raise ValueError("subpixel path supports stride 2, even k only")
    # flipped conv kernel [O, I, k, k]: the JAX package's pre-flipped HWIO
    wf = w.flip(2, 3).transpose(0, 1)
    p = k - 1 - padding  # dilated-conv pad (4 for k=8, p=3)
    b_, h, wdt, _ = x.shape
    xn = _nchw(x)
    out = x.new_empty((b_, 2 * h, 2 * wdt, wf.shape[0]))
    # 1D tap algebra: y[2m+a] = sum_j xd[2m + a - p + j]*wf[j]; the dilated
    # input is nonzero only at even indices, so j = 2s + (p+a)%2 and the
    # contribution is x[m + s - (p-a)//2]*wf[j]: a k/2-tap conv with left
    # pad (p-a)//2 and right pad k/2-1 - (p-a)//2.
    for a in (0, 1):
        la = (p - a) // 2
        for b in (0, 1):
            lb = (p - b) // 2
            sub = wf[:, :, (p + a) % 2 :: 2, (p + b) % 2 :: 2]
            padded = F.pad(xn, (lb, k // 2 - 1 - lb, la, k // 2 - 1 - la))
            out[:, a::2, b::2, :] = _nhwc(F.conv2d(padded, sub))
    return out + params["b"]


# ---------------------------------------------------------------------------
# Weight-layout converters (numpy)
# ---------------------------------------------------------------------------


def torch_conv_to_hwio(w: np.ndarray) -> np.ndarray:
    """(O, I, kh, kw) -> (kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def hwio_to_torch_conv(w: np.ndarray) -> np.ndarray:
    """(kh, kw, I, O) -> (O, I, kh, kw); inverse of `torch_conv_to_hwio`."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def torch_convtranspose_to_hwio(w: np.ndarray) -> np.ndarray:
    """(I, O, kh, kw) -> spatially flipped (kh, kw, I, O) for dilated conv."""
    return np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))


def hwio_to_torch_convtranspose(w: np.ndarray) -> np.ndarray:
    """Flipped (kh, kw, I, O) -> (I, O, kh, kw); inverse of
    `torch_convtranspose_to_hwio`."""
    return np.ascontiguousarray(np.transpose(w[::-1, ::-1], (2, 3, 0, 1)))


# ---------------------------------------------------------------------------
# Initializers (xavier-normal gain .02 on conv weights, torch defaults
# elsewhere, as in the JAX package). Tensors land on the generator's device.
# ---------------------------------------------------------------------------


def init_conv(generator: torch.Generator, k: int, cin: int, cout: int,
              gain: float = 0.02):
    dev = generator.device
    fan_in = cin * k * k
    fan_out = cout * k * k
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    w = std * torch.randn((cout, cin, k, k), generator=generator, device=dev)
    bound = 1.0 / math.sqrt(fan_in)
    b = (2 * torch.rand((cout,), generator=generator, device=dev) - 1) * bound
    return {"w": w, "b": b}


def init_conv_transpose(generator: torch.Generator, k: int, cin: int, cout: int):
    # torch ConvTranspose2d default (kaiming-uniform a=sqrt(5))
    dev = generator.device
    fan_in = cout * k * k  # torch fan-in convention for transposed conv
    bound = 1.0 / math.sqrt(fan_in)
    w = (2 * torch.rand((cin, cout, k, k), generator=generator, device=dev) - 1) * bound
    b = (2 * torch.rand((cout,), generator=generator, device=dev) - 1) * bound
    return {"w": w, "b": b}


# ---------------------------------------------------------------------------
# DoubleConv: conv3x3 -> activation -> conv3x3 (NO activation after 2nd conv)
# ---------------------------------------------------------------------------


def init_double_conv(generator: torch.Generator, cin: int, cout: int,
                     activation: str, cmid=None):
    cmid = cout if cmid is None else cmid
    act_init, _ = get_activation(activation)
    return {
        "c1": init_conv(generator, 3, cin, cmid),
        "act": act_init(generator),
        "c2": init_conv(generator, 3, cmid, cout),
    }


def double_conv(params, x, activation: str, precision: str = "highest",
                spatial=None):
    _, act = get_activation(activation)
    h = conv2d(params["c1"], x, padding=1, precision=precision, spatial=spatial)
    h = act(params["act"], h)
    return conv2d(params["c2"], h, padding=1, precision=precision,
                  spatial=spatial)


def res_double_conv(params, x, activation: str, precision: str = "highest",
                    spatial=None):
    """DoubleConv with residual skip (reference ResDoubleConv)."""
    return double_conv(params, x, activation, precision, spatial=spatial) + x

"""3D convolution building blocks, port of `helmnet_tpu/models/blocks3d.py`.

Functional, NDHWC at the boundary, params as plain dicts of tensors, in
PyTorch's layouts: a conv's `w` is OIDHW `[O, I, k, k, k]`, a transposed
conv's `w` is ConvTranspose3d's `[I, O, k, k, k]` (not flipped). The JAX
package keeps DHWIO, with the transposed-conv kernel stored spatially
flipped; `dhwio_to_torch_conv3d` and `dhwio_to_torch_convtranspose3d`
convert its weights, and the two `torch_*_to_dhwio` functions go back.

The convs are cuDNN calls (`F.conv3d`, `F.conv_transpose3d`), as XLA ran
them on the TPU: the JAX package has no Pallas kernel on the 3D path. An
NDHWC tensor permuted to NCDHW is a channels-last-3d tensor, so the
permutes around each call move no data.

The down and up convs are k=4, s=2, p=1 (the JAX package's 3D choice).
`conv_transpose3d_subpixel` computes the transposed conv as eight
(k/2)^3-tap convs at input resolution, one per output-parity octant,
interleaved after: the same function, 8x fewer products.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .activations import get_activation
from .blocks import resolve_precision


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 4, 1)


def conv3d(params, x, *, stride: int = 1, padding: int = 0,
           precision: str = "highest"):
    """3D convolution, NDHWC x OIDHW -> NDHWC, torch Conv3d semantics."""
    resolve_precision(precision)
    return _ndhwc(F.conv3d(_ncdhw(x), params["w"], params["b"], stride=stride,
                           padding=padding))


def conv_transpose3d(params, x, *, stride: int = 2, padding: int = 1,
                     precision: str = "highest"):
    """Torch ConvTranspose3d(k, stride, padding) semantics: the JAX
    package's input-dilated conv (pad k - 1 - padding, flipped kernel)
    computes the same function."""
    resolve_precision(precision)
    return _ndhwc(F.conv_transpose3d(_ncdhw(x), params["w"], params["b"],
                                     stride=stride, padding=padding))


def conv_transpose3d_subpixel(params, x, *, stride: int = 2, padding: int = 1,
                              precision: str = "highest"):
    """Same math as `conv_transpose3d` (even k, s=2): each output-parity
    octant (a, b, c) = (z%2, y%2, x%2) reads one parity class of kernel
    taps per axis, so the op is eight (k/2)^3-tap convs at input
    resolution, interleaved after (blocks.conv_transpose2d_subpixel's tap
    algebra on each axis)."""
    resolve_precision(precision)
    w = params["w"]  # [I, O, k, k, k]
    k = w.shape[-1]
    if stride != 2 or k % 2:
        raise ValueError("subpixel path supports stride 2, even k only")
    # flipped conv kernel [O, I, k, k, k]: the JAX package's pre-flipped DHWIO
    wf = w.flip(2, 3, 4).transpose(0, 1)
    p = k - 1 - padding
    half = k // 2
    bsz, d, h, wdt, _ = x.shape
    xn = _ncdhw(x)
    out = x.new_empty((bsz, 2 * d, 2 * h, 2 * wdt, wf.shape[0]))

    # output parity a reads taps j = (p+a) mod 2 (step 2), left pad (p-a)//2
    def axis(a):
        return (p + a) % 2, (p - a) // 2

    for a in (0, 1):
        fa, la = axis(a)
        for b in (0, 1):
            fb, lb = axis(b)
            for c in (0, 1):
                fc, lc = axis(c)
                sub = wf[:, :, fa::2, fb::2, fc::2]
                padded = F.pad(xn, (lc, half - 1 - lc, lb, half - 1 - lb,
                                    la, half - 1 - la))
                out[:, a::2, b::2, c::2, :] = _ndhwc(F.conv3d(padded, sub))
    return out + params["b"]


# ---------------------------------------------------------------------------
# Weight-layout converters (numpy)
# ---------------------------------------------------------------------------


def torch_conv3d_to_dhwio(w: np.ndarray) -> np.ndarray:
    """(O, I, kd, kh, kw) -> (kd, kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 4, 1, 0))


def dhwio_to_torch_conv3d(w: np.ndarray) -> np.ndarray:
    """(kd, kh, kw, I, O) -> (O, I, kd, kh, kw); inverse of
    `torch_conv3d_to_dhwio`."""
    return np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2)))


def torch_convtranspose3d_to_dhwio(w: np.ndarray) -> np.ndarray:
    """(I, O, kd, kh, kw) -> spatially flipped (kd, kh, kw, I, O) for the
    JAX package's dilated conv."""
    return np.transpose(w[:, :, ::-1, ::-1, ::-1], (2, 3, 4, 0, 1))


def dhwio_to_torch_convtranspose3d(w: np.ndarray) -> np.ndarray:
    """Flipped (kd, kh, kw, I, O) -> (I, O, kd, kh, kw); inverse of
    `torch_convtranspose3d_to_dhwio`."""
    return np.ascontiguousarray(np.transpose(w[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)))


# ---------------------------------------------------------------------------
# Initializers (xavier-normal gain .02 on conv weights, as in 2D), on the
# generator's device
# ---------------------------------------------------------------------------


def init_conv3d(generator: torch.Generator, k: int, cin: int, cout: int,
                gain: float = 0.02):
    dev = generator.device
    fan_in = cin * k**3
    fan_out = cout * k**3
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    w = std * torch.randn((cout, cin, k, k, k), generator=generator, device=dev)
    bound = 1.0 / math.sqrt(fan_in)
    b = (2 * torch.rand((cout,), generator=generator, device=dev) - 1) * bound
    return {"w": w, "b": b}


def init_conv_transpose3d(generator: torch.Generator, k: int, cin: int, cout: int):
    dev = generator.device
    bound = 1.0 / math.sqrt(cout * k**3)  # torch fan-in convention
    w = (2 * torch.rand((cin, cout, k, k, k), generator=generator, device=dev) - 1) * bound
    b = (2 * torch.rand((cout,), generator=generator, device=dev) - 1) * bound
    return {"w": w, "b": b}


# ---------------------------------------------------------------------------
# DoubleConv3D: conv3x3x3 -> activation -> conv3x3x3 (no act after 2nd)
# ---------------------------------------------------------------------------


def init_double_conv3d(generator: torch.Generator, cin: int, cout: int,
                       activation: str, cmid=None):
    cmid = cout if cmid is None else cmid
    act_init, _ = get_activation(activation)
    return {
        "c1": init_conv3d(generator, 3, cin, cmid),
        "act": act_init(generator),
        "c2": init_conv3d(generator, 3, cmid, cout),
    }


def double_conv3d(params, x, activation: str, precision: str = "highest"):
    _, act = get_activation(activation)
    h = conv3d(params["c1"], x, padding=1, precision=precision)
    h = act(params["act"], h)
    return conv3d(params["c2"], h, padding=1, precision=precision)

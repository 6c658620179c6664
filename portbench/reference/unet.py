"""The recurrent UNet of the learned solver (2D or 3D), from the trained
weights as the raw npz holds them.

The npz is a flat `p0 ... pN` in the JAX package's tree order: dict keys
sorted at every level, lists in order. Conv kernels are HWIO (DHWIO in
3D); a transposed conv's kernel is stored spatially flipped, so the
transposed conv is the plain conv of that kernel over the input dilated
by 2 and padded by k - 1 - p, as it is defined in the JAX package.

One step of the network, on NC... tensors:
  x = DC(inc, x)
  per encoder level d: out = DC(conv_signal, [x, s_d]);
    s_d' = DC(conv_state, [out, s_d]) (levels below the state depth);
    x = down conv (stride 2) of out
  x = DC(decode[depth], x)
  per level d from depth - 1 to 0: x = DC(decode[d], [up(x), out_d])
  return head 1x1 conv of x, the new states
DC is conv 3x3 -> PReLU (one slope) -> conv 3x3.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .rounding import product_out, round_to

DOUBLE_CONV = ("act.a", "c1.b", "c1.w", "c2.b", "c2.w")


def leaf_names(depth: int, state_depth: int) -> list[str]:
    """The npz's leaf names in its order (p0 is the first)."""
    names = [f"decode.{i}.{k}" for i in range(depth + 1) for k in DOUBLE_CONV]
    for d in range(depth):
        kinds = ("conv_signal", "conv_state") if d < state_depth else ("conv_signal",)
        names += [f"enc.{d}.{kind}.{k}" for kind in kinds for k in DOUBLE_CONV]
        names += [f"enc.{d}.down.b", f"enc.{d}.down.w"]
    names += [f"inc.{k}" for k in DOUBLE_CONV] + ["outc.b", "outc.w"]
    names += [f"up.{i}.{k}" for i in range(depth) for k in ("b", "w")]
    return names


def load_weights(path: str, depth: int, state_depth: int, device) -> dict:
    """name -> f32 tensor on `device`, in the npz's own layouts."""
    names = leaf_names(depth, state_depth)
    with np.load(path) as f:
        if sorted(f.files) != sorted(f"p{i}" for i in range(len(names))):
            raise ValueError(f"{path} holds {len(f.files)} arrays, expected {len(names)}")
        return {n: torch.tensor(np.asarray(f[f"p{i}"], np.float32), device=device)
                for i, n in enumerate(names)}


def _oi(w: torch.Tensor) -> torch.Tensor:
    """HWIO (or DHWIO) -> OIHW (OIDHW)."""
    nd = w.dim() - 2
    return w.permute(nd + 1, nd, *range(nd))


def conv(x, w, b, *, stride: int = 1, pad: int = 0, precision: str = "f32"):
    """Cross-correlation of NC... x with the (D)HWIO kernel w, plus b."""
    fn = F.conv2d if x.dim() == 4 else F.conv3d
    y = fn(round_to(x, precision), round_to(_oi(w), precision), b, stride=stride,
           padding=pad)
    return product_out(y, precision)


def conv_up(x, w, b, *, pad: int, precision: str = "f32"):
    """Transposed conv (stride 2) as the conv of the stored kernel over
    x dilated by 2 and padded by k - 1 - pad."""
    k = w.shape[0]
    nd = x.dim() - 2
    dil = x.new_zeros(x.shape[:2] + tuple(2 * s - 1 for s in x.shape[2:]))
    dil[(slice(None), slice(None)) + (slice(None, None, 2),) * nd] = x
    return conv(dil, w, b, pad=k - 1 - pad, precision=precision)


def double_conv(p: dict, name: str, x, precision: str):
    h = conv(x, p[f"{name}.c1.w"], p[f"{name}.c1.b"], pad=1, precision=precision)
    a = p[f"{name}.act.a"]
    h = torch.clamp_min(h, 0) + a * torch.clamp_max(h, 0)
    return conv(h, p[f"{name}.c2.w"], p[f"{name}.c2.b"], pad=1, precision=precision)


def step(p: dict, x, states, *, depth: int, state_depth: int, resample: dict,
         precision: dict):
    """One network apply: (out [B, 2, ...], new states)."""
    dc = precision["double_convs"]
    rs = precision["resample_convs"]
    x = double_conv(p, "inc", x, dc)
    inner, new_states = [], []
    for d in range(depth):
        if d < state_depth:
            out = double_conv(p, f"enc.{d}.conv_signal", torch.cat([x, states[d]], 1), dc)
            new_states.append(
                double_conv(p, f"enc.{d}.conv_state", torch.cat([out, states[d]], 1), dc))
        else:
            out = double_conv(p, f"enc.{d}.conv_signal", x, dc)
        inner.append(out)
        x = conv(out, p[f"enc.{d}.down.w"], p[f"enc.{d}.down.b"], stride=2,
                 pad=resample["pad"], precision=rs)
    x = double_conv(p, f"decode.{depth}", x, dc)
    for d in range(depth - 1, -1, -1):
        x = conv_up(x, p[f"up.{d}.w"], p[f"up.{d}.b"], pad=resample["pad"], precision=rs)
        x = double_conv(p, f"decode.{d}", torch.cat([x, inner[d]], 1), dc)
    out = conv(x, p["outc.w"], p["outc.b"], precision=precision["head"])
    return out, new_states

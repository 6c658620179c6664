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
- `prepare(params)` converts the weights once into the kernel's layout
  (`PreparedDoubleConv`: bf16 B fragments of the tensor-core products,
  widths padded to 8 or 16; f32 biases). `solvers/iterative.rollout`
  does it once per rollout (`models.hybridnet.prepare_k1`).
- `tile_for(batch, height, width)` picks the kernel's output tile.
- `fused_double_conv` takes the schema dict or a `PreparedDoubleConv`,
  launches the kernel for CUDA tensors, or raises. It takes the plain
  version only for tensors on the CPU. `fused_double_conv.launches`
  counts its launches. Under an active sanitizer (core/sanitize.py) its
  output is checked as K1's when it returns.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import sanitize

MAX_CHANNELS = 16
MAX_PARTS = 2
SMS = 132  # streaming multiprocessors of an H100 SXM
# 16 x 16 output tiles where they give at least this many blocks, else
# 8 x 8 (chip_smoke.py phase 5 times each call at both tiles)
BIG_TILE_MIN_BLOCKS = 2 * SMS
TILES = ((16, 16), (8, 8))  # the kernel's `tile` argument indexes this


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


def _tiles(height: int, width: int, tile) -> int:
    return -(-height // tile[0]) * -(-width // tile[1])


def tile_for(batch: int, height: int, width: int) -> tuple[int, int]:
    """The kernel's output tile for a `batch` x `height` x `width` call:
    16 x 16 where that launches at least `BIG_TILE_MIN_BLOCKS` blocks with
    at least half of each block's output pixels inside the image, else
    8 x 8, whose smaller blocks fill the card at the small UNet levels."""
    big = TILES[0]
    live = height * width / (_tiles(height, width, big) * big[0] * big[1])
    if batch * _tiles(height, width, big) >= BIG_TILE_MIN_BLOCKS and live >= 0.5:
        return big
    return TILES[1]


def _pad8(c: int) -> int:
    return 8 if c <= 8 else 16


def _fragments(wk: torch.Tensor, k_pad: int, n_pad: int) -> torch.Tensor:
    """A [K, N] matrix -> the B fragments of `mma.m16n8k16`, bf16:
    [n_pad / 8, k_pad / 8, 32, 2], zero-padded. Element [nt, j, lane, e] is
    wk[8 j + 2 (lane % 4) + e, 8 nt + lane // 4]: lane's two values of K
    chunk j (8 rows of K) in n-tile nt."""
    k, n = wk.shape
    wp = wk.new_zeros((k_pad, n_pad))
    wp[:k, :n] = wk
    wp = wp.reshape(k_pad // 8, 4, 2, n_pad // 8, 8)  # j, t, e, nt, g
    return wp.permute(3, 0, 4, 1, 2).reshape(n_pad // 8, k_pad // 8, 32, 2) \
             .to(torch.bfloat16).contiguous()


def _conv_k(w: torch.Tensor, c_pad: int) -> torch.Tensor:
    """OIHW [o, i, 3, 3] -> [9 * c_pad, o]: row tap * c_pad + c holds
    w[:, c, tap // 3, tap % 3], zero for c >= i."""
    o, i = w.shape[:2]
    wk = w.new_zeros((9, c_pad, o))
    wk[:, :i] = w.reshape(o, i, 9).permute(2, 1, 0)
    return wk.reshape(9 * c_pad, o)


def _padded(b: torch.Tensor, n: int) -> torch.Tensor:
    out = b.new_zeros(n, dtype=torch.float32)
    out[: b.shape[0]] = b
    return out


@dataclass(frozen=True)
class PreparedDoubleConv:
    """One DoubleConv's weights in the kernel's layout, made by `prepare`.
    `params` keeps the schema dict for the plain version and the shape
    checks; the rest is what the kernel reads."""

    params: dict
    cin: int
    cm: int
    co: int
    ce: int  # head width, 0 without the head
    w1: torch.Tensor  # bf16 fragments [cmp/8, 9*cs/8, 32, 2]
    w2: torch.Tensor  # [cop/8, 9*cmp/8, 32, 2]
    w3: Optional[torch.Tensor]  # [cep/8, cop/8, 32, 2]
    b1: torch.Tensor  # f32 [cmp], zero-padded
    b2: torch.Tensor  # [cop]
    b3: Optional[torch.Tensor]  # [cep]

    @property
    def cs(self) -> int:
        return _pad8(self.cin)

    @property
    def cmp(self) -> int:
        return _pad8(self.cm)

    @property
    def cop(self) -> int:
        return _pad8(self.co)

    @property
    def cep(self) -> int:
        return _pad8(self.ce) if self.ce else 0

    def to(self, device) -> "PreparedDoubleConv":
        """The same weights on `device` (what `hybridnet.params_to` calls)."""
        move = lambda t: None if t is None else t.to(device)
        tree = lambda p: ({k: tree(v) for k, v in p.items()} if isinstance(p, dict)
                          else tuple(map(tree, p)) if isinstance(p, (tuple, list))
                          else move(p))
        return dataclasses.replace(
            self, params=tree(self.params), w1=move(self.w1), w2=move(self.w2),
            w3=move(self.w3), b1=move(self.b1), b2=move(self.b2), b3=move(self.b3))


def prepare(params) -> PreparedDoubleConv:
    """The schema dict (c1 weights whole or as per-part slices, optional
    head) -> `PreparedDoubleConv`, on the weights' device. Shapes the
    kernel does not take raise."""
    if isinstance(params, PreparedDoubleConv):
        return params
    w1 = _w1(params)
    cm, cin = int(w1.shape[0]), int(w1.shape[1])
    w2 = params["c2"]["w"]
    co = int(w2.shape[0])
    post = params.get("post")
    ce = int(post["w"].shape[0]) if post else 0
    if not supported(1, 1, cin, cm, co, ce or co):
        raise ValueError(
            f"unsupported DoubleConv: {cin} -> {cm} -> {co} -> {ce or co} "
            f"(at most {MAX_CHANNELS} channels each)")
    cs, cmp, cop = _pad8(cin), _pad8(cm), _pad8(co)
    w3 = b3 = None
    if post:
        cep = _pad8(ce)
        w3 = _fragments(post["w"].reshape(ce, co).t(), cop, cep)
        b3 = _padded(post["b"], cep)
    return PreparedDoubleConv(
        params=params, cin=cin, cm=cm, co=co, ce=ce,
        w1=_fragments(_conv_k(w1, cs), 9 * cs, cmp),
        w2=_fragments(_conv_k(w2, cmp), 9 * cmp, cop),
        w3=w3, b1=_padded(params["c1"]["b"], cmp),
        b2=_padded(params["c2"]["b"], cop), b3=b3,
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


def _vec(t: torch.Tensor, c: int, coff: int) -> int:
    """Floats per load of an input part: 16-byte vectors where its width,
    its channel offset in the staged tile and its pointer allow, else 8
    bytes, else 4."""
    for v in (4, 2):
        if c % v == 0 and coff % v == 0 and t.data_ptr() % (4 * v) == 0:
            return v
    return 1


@sanitize.kernel("K1 (fused_double_conv, ops/double_conv.py)")
def fused_double_conv(params, x, *, tile=None) -> torch.Tensor:
    """DoubleConv (+ optional 1x1 head) as one CUDA kernel launch.

    `params`: the schema dict or a `PreparedDoubleConv` (a dict is
    converted in the call). `tile`: one of `TILES`, by default
    `tile_for`'s choice. Shapes the kernel does not take raise on every
    device. Within them, CPU tensors take `double_conv_plain`; CUDA tensors
    launch the kernel or raise. Returns `[B, H, W, c_emit]` f32.
    """
    parts = _parts(x)
    device = parts[0].device
    b, h, w = parts[0].shape[:3]
    cins = [int(p.shape[-1]) for p in parts]
    fp = params.params if isinstance(params, PreparedDoubleConv) else params
    w1 = _w1(fp)
    cm, co = int(w1.shape[0]), int(fp["c2"]["w"].shape[0])
    post = fp.get("post")
    ce = int(post["w"].shape[0]) if post else co
    if not supported(h, w, cins, cm, co, ce):
        raise ValueError(
            f"unsupported DoubleConv: parts {cins} -> {cm} -> {co} -> {ce} "
            f"at {h}x{w} (at most {MAX_PARTS} parts and {MAX_CHANNELS} "
            f"channels each)"
        )
    if device.type == "cpu":
        return double_conv_plain(fp, parts)
    if device.type != "cuda":
        raise ValueError(f"fused_double_conv runs on cuda or cpu, not {device}")
    for i, p in enumerate(parts):
        _check(f"x[{i}]", p, device, (b, h, w, cins[i]))
    _check("c1.w", w1, device, (cm, sum(cins), 3, 3))
    _check("c1.b", fp["c1"]["b"], device, (cm,))
    _check("c2.w", fp["c2"]["w"], device, (co, cm, 3, 3))
    _check("c2.b", fp["c2"]["b"], device, (co,))
    slope = _slope(fp)
    if slope is not None:
        _check("act.a", slope, device, (1,))
    if post:
        _check("post.w", post["w"], device, (ce, co, 1, 1))
        _check("post.b", post["b"], device, (ce,))
    pw = prepare(params)
    for name, t, dtype in (("w1", pw.w1, torch.bfloat16), ("w2", pw.w2, torch.bfloat16),
                           ("w3", pw.w3, torch.bfloat16), ("b1", pw.b1, torch.float32),
                           ("b2", pw.b2, torch.float32), ("b3", pw.b3, torch.float32)):
        if t is not None and (t.device != device or t.dtype != dtype):
            raise ValueError(f"prepared {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {device}")

    from .._build import load_library

    lib = load_library()
    out = torch.empty((b, h, w, ce), dtype=torch.float32, device=device)
    x2 = parts[1] if len(parts) > 1 else None
    c2 = cins[1] if x2 is not None else 0
    tile = TILES.index(tile_for(b, h, w) if tile is None else tuple(tile))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hn_double_conv(
            _ptr(parts[0]), cins[0], _vec(parts[0], cins[0], 0),
            _ptr(x2), c2, _vec(x2, c2, cins[0]) if x2 is not None else 1,
            _ptr(pw.w1), _ptr(pw.b1), _ptr(slope), _ptr(pw.w2), _ptr(pw.b2),
            _ptr(pw.w3), _ptr(pw.b3), _ptr(out), b, h, w,
            pw.cs, pw.cmp, pw.cop, co, ce, pw.cep, tile, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"hn_double_conv launch failed: CUDA error {rc}")
    fused_double_conv.launches += 1
    return out


fused_double_conv.launches = 0

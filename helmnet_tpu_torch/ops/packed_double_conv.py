"""Packed fused DoubleConv: the port of the TPU kernel `fused_double_conv`
(`helmnet_tpu/ops/pallas_unet.py:175`) to a CUDA kernel for Hopper
(`csrc/packed_double_conv.cu`), for the wide channel-packed tensors of
models/packed.py.

It computes the same function as ops/double_conv.py: conv3x3 (pad 1) ->
PReLU (one shared slope; ReLU when `act` holds none) -> conv3x3 (pad 1),
with an optional trailing 1x1 conv (`post`). The input may be a tuple of
up to 3 NHWC parts whose plain, part-major channel concatenation feeds the
first conv (`pallas_unet.py:212-227`); `c1.w` may then be a tuple of
per-part OIHW slices, concatenated on the input axis to match. x, h1 and
h2 are rounded to bf16 where they enter a product, weights are bf16, and
sums, biases and PReLU are f32, as on the TPU. So its plain version is
`double_conv.double_conv_plain`, reused here.

- `prepare(params)` converts the weights once into the kernel's layout
  (bf16, chunks of 16 input channels, each tap's block in 8 x 8 core
  matrices, widths padded): `PackedWeights`.
  models/packed.py does it once per rollout.
- `tile_for(batch, height, width, cmp, cop, ce)` picks the kernel's
  output tile.
- Mid, out and head widths up to 128 take the 128-wide instances; above
  that, up to `MAX_WIDTH` = 512 (g = 64 at C = 8, the widest at which the
  TPU kernel runs), the cluster instance: one thread-block cluster of
  `cluster_size(cmp, cop)` CTAs a tile, each computing one slice of 128
  (`SLICE`) mid and out channels, with the weights slice-major.
- `packed_double_conv(params, x)` takes the schema dict or a
  `PackedWeights`. Shapes the kernel does not take raise on every device.
  CUDA tensors launch the kernel or raise; CPU tensors take the plain
  version. `packed_double_conv.launches` counts its launches. Under an
  active sanitizer (core/sanitize.py) its output is checked as K3's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from ..core import sanitize
from .double_conv import _check, _parts, _ptr, _slope, _w1, double_conv_plain

MAX_PARTS = 3
MAX_WIDTH = 512  # mid, out and head channels; the input is streamed
NARROW = 128  # the widest the 128-wide instances take
SLICE = 128  # N columns a wide instance computes at a time
CHUNK = 16  # input channels per K chunk of the kernel


SMS = 132  # streaming multiprocessors of an H100 SXM
# the kernel's `tile` argument indexes this, largest first: 8 x 16 and 4 x 8
# for the 128-wide instances, all three for the cluster instance
TILES = ((8, 16), (8, 8), (4, 8))


def is_wide(cm: int, co: int, ce: int = 0) -> bool:
    """True when these mid, out and head widths take the wide instances."""
    return max(cm, co, ce) > NARROW


def tiles_for(cmp: int = NARROW, cop: Optional[int] = None, ce: int = 0) -> tuple:
    """The tiles of the instance for padded mid and out widths `cmp` and
    `cop` (default `cmp`) and head width `ce`, largest first: the cluster
    instance holds one 128-channel slice of the mid tile a CTA, so it takes
    every tile at every width."""
    if not is_wide(cmp, cmp if cop is None else cop, ce):
        return TILES[0], TILES[2]
    return TILES


def cluster_size(cmp: int = NARROW, cop: Optional[int] = None, ce: int = 0) -> int:
    """CTAs a tile: `max(cmp, cop) / SLICE` for the cluster instance (one
    per slice of mid or out channels: 2 at g = 32, 4 at g = 64), 1 for the
    128-wide ones."""
    cop = cmp if cop is None else cop
    return max(cmp, cop) // SLICE if is_wide(cmp, cop, ce) else 1


def ctas(batch: int, height: int, width: int, tile, cmp: int = NARROW,
         cop: Optional[int] = None, ce: int = 0) -> int:
    """The CTAs of one call: output tiles times `cluster_size`."""
    tiles = batch * -(-height // tile[0]) * -(-width // tile[1])
    return tiles * cluster_size(cmp, cop, ce)


def tile_for(batch: int, height: int, width: int, cmp: int = NARROW,
             cop: Optional[int] = None, ce: int = 0) -> tuple[int, int]:
    """The kernel's output tile for a `batch` x `height` x `width` call of
    the instance for padded widths `cmp`, `cop` and head width `ce`: the
    largest of `tiles_for(cmp, cop, ce)` whose `ctas` are at least half as
    many as the card has SMs, or the smallest (batch 1: at g = 16, 8 x 16
    at 256^2 and 128^2, 4 x 8 below; at g = 32, 8 x 16 at 256^2 and
    128^2, 8 x 8 at 64^2, 4 x 8 below; at g = 64, 8 x 16 down to 64^2,
    4 x 8 below)."""
    tiles = tiles_for(cmp, cop, ce)
    for tile in tiles[:-1]:
        if 2 * ctas(batch, height, width, tile, cmp, cop, ce) >= SMS:
            return tile
    return tiles[-1]


def padded_width(c: int, wide: bool = False) -> int:
    """Mid and out widths as the kernel instances take them: 32 or 128 for
    the 128-wide instances, a multiple of 128 for the wide ones."""
    if wide:
        return -(-c // SLICE) * SLICE
    return 32 if c <= 32 else 128


def supported(height: int, width: int, cin, cmid: int, cout: int,
              c_emit: int | None = None) -> bool:
    """True when the kernel takes these shapes. `cin` may be a sequence of
    per-part channel counts. Unlike `pallas_unet.fused_supported`, no VMEM
    budget applies: the kernel streams the input channels and masks ragged
    edge tiles, so any grid and any input width go; mid, out and head
    widths are at most 512 (g * C at g = 64 and C = 8, the widest at which
    `fused_supported` finds a tiling: at 16^2 and 8^2)."""
    cins = (cin,) if isinstance(cin, int) else tuple(cin)
    c_emit = cout if c_emit is None else c_emit
    return (
        height > 0 and width > 0
        and 1 <= len(cins) <= MAX_PARTS and all(c > 0 for c in cins)
        and 0 < cmid <= MAX_WIDTH and 0 < cout <= MAX_WIDTH
        and 0 < c_emit <= MAX_WIDTH
    )


def _chunked(w: torch.Tensor, rows: int, cin_pad: int) -> torch.Tensor:
    """OIHW [o, i, 3, 3] -> bf16 [cin_pad / 16, 9, rows / 8, 2, 8, 8],
    zero-padded: chunk k of 16 input channels, tap, and the 8 x 8 core
    matrix (n // 8, c // 8) of that tap's [rows x 16] block; element
    [k, tap, n // 8, c // 8, n % 8, c % 8] is w[n, 16 k + c, tap // 3,
    tap % 3]. A chunk is one contiguous run, and each tap's block is the
    K-major layout without swizzle that wgmma reads from shared memory.
    Above 128 rows the chunks come slice-major, each of `SLICE` rows:
    [rows / 128 * cin_pad / 16, 9, 16, 2, 8, 8], chunk s * (cin_pad / 16)
    + k holding rows 128 s .. 128 s + 127 of chunk k."""
    o, i = w.shape[:2]
    wp = w.new_zeros((rows, cin_pad, 3, 3))
    wp[:o, :i] = w
    s = min(rows, SLICE)
    # slice, n // 8 in it, n % 8, k, c // 8, c % 8, tap
    wp = wp.reshape(rows // s, s // 8, 8, cin_pad // CHUNK, 2, 8, 9)
    wp = wp.permute(0, 3, 6, 1, 4, 2, 5).reshape(-1, 9, s // 8, 2, 8, 8)
    return wp.to(torch.bfloat16).contiguous()


@dataclass(frozen=True)
class PackedWeights:
    """One DoubleConv's weights in the kernel's layout, made by `prepare`.
    `params` keeps the schema dict for the plain version; the bf16 tensors
    are what the kernel reads."""

    params: dict
    cin: int
    cm: int
    co: int
    ce: int  # head width, 0 without the head
    w1: torch.Tensor  # bf16 [ceil(cin / 16), 9, cmp / 8, 2, 8, 8], or slice-major
    w2: torch.Tensor  # bf16 [cmp / 16, 9, cop / 8, 2, 8, 8], or slice-major
    w3: Optional[torch.Tensor]  # bf16 [ce padded to 8, cop]

    @property
    def wide(self) -> bool:
        return is_wide(self.cm, self.co, self.ce)

    @property
    def cmp(self) -> int:
        return padded_width(self.cm, self.wide)

    @property
    def cop(self) -> int:
        return padded_width(self.co, self.wide)

    @property
    def cep(self) -> int:
        return -(-self.ce // 8) * 8


def prepare(params) -> PackedWeights:
    """The schema dict -> `PackedWeights`, on the weights' device."""
    if isinstance(params, PackedWeights):
        return params
    w1 = _w1(params)
    cm, cin = int(w1.shape[0]), int(w1.shape[1])
    co = int(params["c2"]["w"].shape[0])
    post = params.get("post")
    ce = int(post["w"].shape[0]) if post else 0
    wide = is_wide(cm, co, ce)
    cmp, cop = padded_width(cm, wide), padded_width(co, wide)
    w3 = None
    if post:
        w3 = w1.new_zeros((-(-ce // 8) * 8, cop))
        w3[:ce, :co] = post["w"].reshape(ce, co)
        w3 = w3.to(torch.bfloat16).contiguous()
    return PackedWeights(
        params=params, cin=cin, cm=cm, co=co, ce=ce,
        w1=_chunked(w1, cmp, -(-cin // CHUNK) * CHUNK),
        w2=_chunked(params["c2"]["w"], cop, cmp),
        w3=w3,
    )


@sanitize.kernel("K3 (packed_double_conv, ops/packed_double_conv.py)")
def packed_double_conv(params, x, *, tile=None) -> torch.Tensor:
    """DoubleConv (+ optional 1x1 head) on packed tensors as one CUDA
    kernel launch. `params`: the schema dict or a `PackedWeights`; `x`: an
    NHWC tensor or a tuple of up to 3; `tile`: one of `TILES`, by default
    `tile_for`'s choice (a tile its instance does not take raises).
    Returns `[B, H, W, c_emit]` f32."""
    parts = _parts(x)
    device = parts[0].device
    b, h, w = parts[0].shape[:3]
    cins = [int(p.shape[-1]) for p in parts]
    fp = params.params if isinstance(params, PackedWeights) else params
    w1 = fp["c1"]["w"]
    w1s = tuple(w1) if isinstance(w1, (tuple, list)) else (w1,)
    if len(w1s) > 1 and [int(s.shape[1]) for s in w1s] != cins:
        raise ValueError(
            f"c1 weight slices take {[int(s.shape[1]) for s in w1s]} input "
            f"channels, the parts hold {cins}")
    cm = int(w1s[0].shape[0])
    co = int(fp["c2"]["w"].shape[0])
    post = fp.get("post")
    ce = int(post["w"].shape[0]) if post else co
    if not supported(h, w, cins, cm, co, ce):
        raise ValueError(
            f"unsupported packed DoubleConv: parts {cins} -> {cm} -> {co} -> "
            f"{ce} at {h}x{w} (at most {MAX_PARTS} parts, and at most "
            f"{MAX_WIDTH} mid, out and head channels)"
        )
    for i, p in enumerate(parts):  # on every device, as the kernel takes them
        if p.dtype != torch.float32:
            raise ValueError(f"x[{i}] has dtype {p.dtype}, expected float32")
    head = ce if post else 0
    wide = is_wide(cm, co, head)
    cmp, cop = padded_width(cm, wide), padded_width(co, wide)
    tiles = tiles_for(cmp, cop, head)
    tile = tile_for(b, h, w, cmp, cop, head) if tile is None else tuple(tile)
    if tile not in tiles:
        raise ValueError(f"tile {tile}: the instance for {cm} -> {co} -> {ce} "
                         f"channels takes {tiles}")
    if device.type == "cpu":
        return double_conv_plain(fp, parts)
    if device.type != "cuda":
        raise ValueError(f"packed_double_conv runs on cuda or cpu, not {device}")
    pw = prepare(params)
    for i, p in enumerate(parts):
        _check(f"x[{i}]", p, device, (b, h, w, cins[i]))
    if pw.cin != sum(cins):
        raise ValueError(f"c1.w takes {pw.cin} input channels, the parts "
                         f"hold {sum(cins)}")
    _check("c1.b", fp["c1"]["b"], device, (cm,))
    _check("c2.b", fp["c2"]["b"], device, (co,))
    slope = _slope(fp)
    if slope is not None:
        _check("act.a", slope, device, (1,))
    if post:
        _check("post.b", post["b"], device, (ce,))
    for name, t in (("w1", pw.w1), ("w2", pw.w2), ("w3", pw.w3)):
        if t is not None and (t.device != device or t.dtype != torch.bfloat16):
            raise ValueError(f"prepared {name} is {t.dtype} on {t.device}, "
                             f"expected bfloat16 on {device}")

    from .._build import load_library

    lib = load_library()
    out = torch.empty((b, h, w, ce), dtype=torch.float32, device=device)
    xs = list(parts) + [None] * (MAX_PARTS - len(parts))
    cs = cins + [0] * (MAX_PARTS - len(parts))
    vec = all(c % 4 == 0 and p.data_ptr() % 16 == 0 for c, p in zip(cins, parts))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hn_packed_double_conv(
            _ptr(xs[0]), cs[0], _ptr(xs[1]), cs[1], _ptr(xs[2]), cs[2],
            _ptr(pw.w1), _ptr(fp["c1"]["b"]), _ptr(slope),
            _ptr(pw.w2), _ptr(fp["c2"]["b"]),
            _ptr(pw.w3), _ptr(post["b"] if post else None),
            _ptr(out), b, h, w, cm, co, pw.ce, pw.cmp, pw.cop, pw.cep,
            int(vec), TILES.index(tile),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"hn_packed_double_conv launch failed: CUDA error {rc}")
    packed_double_conv.launches += 1
    return out


packed_double_conv.launches = 0

"""Fused FD-stencil Helmholtz residual: the port of the TPU kernels of
`helmnet_tpu/ops/pallas_stencil.py` to one CUDA kernel for Hopper
(`csrc/stencil_residual.cu`), with the non-kernel half of that module.

All three entry points compute `r = L u + k^2 u - s` for the periodic
(2r+1)-tap stencil operator of ops/stencil.py on split planes
`[B, H, W]` f32 (re and im apart), as their TPU counterparts do, and on a
CUDA tensor each launches the same kernel, `stencil_residual_kernel`:

- `residual_planes` (K2a, `pallas_stencil.py:212`) and
  `residual_planes_tiled` (K2b, :161). `tile_h` is the TPU kernel's VMEM
  row tile: it keeps its checks (`H % tile_h == 0`; `H == tile_h` goes to
  `residual_planes`), and it does not set the CUDA tile.
- `residual_planes_mxu` (K2c, :452). The TPU did its x taps as a product
  with the banded `[W, W]` matrices on the MXU; on the card they are 2r+1
  shifted reads from shared memory, so it launches the kernel with the
  tap tables (the values the bands hold) and keeps the TPU entry point's
  checks, its own counter and its plain version, the banded product
  (`banded_matrices`, built once per operator and cached on it).

A plane may be a split plane (element stride 1) or one half of a channel
pair or of a complex64 tensor seen through `torch.view_as_real` (element
stride 2), so `helmholtz_residual_kernel` (channel pairs, the counterpart
of `helmholtz_residual_pallas`) and GMRES's complex matvec launch without
a split or stack copy. `s=None` means zero and is not read.
`stencil_variant` picks the kernel's instance from the operands before
the launch: `planes` (float4 accesses to split planes), `pairs` (float4
accesses to interleaved re/im pairs) or `scalar` (anything else).

Beside the kernel: its plain PyTorch versions (`residual_planes_plain`,
`residual_planes_mxu_plain`), which the CPU tests use and chip_smoke.py
holds the kernel against on the card; one launch counter per entry
point (`residual_planes.launches`, ...), raised only where the kernel is
launched; `kernel_supported` and `helmholtz_residual_stencil_auto`, the
counterparts of `pallas_supported` and the dispatcher of the same name;
and `stencil_to_csr`, the operator as a scipy matrix on the host.

On the CPU the entry points take their plain versions; on a CUDA tensor
they launch their kernel or raise. No CUDA tensor is ever sent to a plain
version. Under an active sanitizer (core/sanitize.py) each entry point's
outputs are checked under its kernel's name when it returns.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import sanitize
from .stencil import StencilPML, laplacian_stencil

RADII = (1, 2)  # stencil orders 2 and 4


# ---------------------------------------------------------------------------
# The banded x-tap matrices (K2c's operands)
# ---------------------------------------------------------------------------


def banded_matrices(op: StencilPML) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense banded (periodic) [W, W] matrices of the x-axis taps, split
    re/im and pre-transposed for `u @ Bt`: Bt[j, i] is the coefficient of
    input column j for output column i. Built once per operator, on its
    device, and cached on it (`op.cache`); the same sums, in the same
    order, as the JAX package's `banded_matrices`."""
    bands = op.cache.get("bands")
    if bands is None:
        cxr, cxi = op.cx_r, op.cx_i
        ntaps, w = cxr.shape
        r = (ntaps - 1) // 2
        btr = torch.zeros((w, w), dtype=torch.float32, device=cxr.device)
        bti = torch.zeros_like(btr)
        cols = torch.arange(w, device=cxr.device)
        for t in range(ntaps):
            rows = (cols + (t - r)) % w
            btr.index_put_((rows, cols), cxr[t], accumulate=True)
            bti.index_put_((rows, cols), cxi[t], accumulate=True)
        bands = op.cache["bands"] = (btr, bti)
    return bands


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _diag(u_re, u_im, k_sq, s_re, s_im):
    acc_r, acc_i = k_sq * u_re, k_sq * u_im
    if s_re is not None:
        acc_r, acc_i = acc_r - s_re, acc_i - s_im
    return acc_r, acc_i


def _y_taps(op: StencilPML, u_re, u_im, acc_r, acc_i):
    r = op.radius
    for t in range(2 * r + 1):
        uyr = torch.roll(u_re, r - t, dims=-2)
        uyi = torch.roll(u_im, r - t, dims=-2)
        cyr, cyi = op.cy_r[t][:, None], op.cy_i[t][:, None]
        acc_r = acc_r + cyr * uyr - cyi * uyi
        acc_i = acc_i + cyr * uyi + cyi * uyr
    return acc_r, acc_i


def residual_planes_plain(op: StencilPML, u_re, u_im, k_sq, s_re=None,
                          s_im=None):
    """K2a/K2b's function in plain PyTorch, as `_residual_kernel`
    computes it: acc = k^2 u - s, then per tap the x and the y term, each
    product and sum rounded on its own (the kernel keeps this order)."""
    r = op.radius
    acc_r, acc_i = _diag(u_re, u_im, k_sq, s_re, s_im)
    for t in range(2 * r + 1):
        off = t - r
        uxr = torch.roll(u_re, -off, dims=-1)
        uxi = torch.roll(u_im, -off, dims=-1)
        cxr, cxi = op.cx_r[t], op.cx_i[t]
        acc_r = acc_r + cxr * uxr - cxi * uxi
        acc_i = acc_i + cxr * uxi + cxi * uxr
        uyr = torch.roll(u_re, -off, dims=-2)
        uyi = torch.roll(u_im, -off, dims=-2)
        cyr, cyi = op.cy_r[t][:, None], op.cy_i[t][:, None]
        acc_r = acc_r + cyr * uyr - cyi * uyi
        acc_i = acc_i + cyr * uyi + cyi * uyr
    return acc_r, acc_i


def residual_planes_mxu_plain(op: StencilPML, u_re, u_im, k_sq, s_re=None,
                              s_im=None):
    """K2c's function in plain PyTorch, as `_residual_kernel_mxu` computes
    it: the x taps as dense f32 products with the banded matrices, plus
    k^2 u - s, then the y taps as row shifts."""
    btr, bti = banded_matrices(op)
    xr = u_re @ btr - u_im @ bti
    xi = u_re @ bti + u_im @ btr
    d_r, d_i = _diag(u_re, u_im, k_sq, s_re, s_im)
    return _y_taps(op, u_re, u_im, xr + d_r, xi + d_i)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _plane_strides(name: str, t: torch.Tensor, shape, device,
                   batch_broadcast: bool = False) -> tuple[int, int]:
    """(batch stride, element stride) of a [B, H, W] f32 plane whose
    element (b, y, x) sits at b * bs + (y * W + x) * es, es in {1, 2}.
    Raises on anything else."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    b, h, w = shape
    sb, sy, sx = t.stride()
    for es in (1, 2):
        if (w == 1 or sx == es) and (h == 1 or sy == w * es):
            if b == 1:
                return 0, es
            if sb == h * w * es or (batch_broadcast and sb == 0):
                return sb, es
    raise ValueError(
        f"{name} has strides {t.stride()}: the kernel takes [B, H, W] planes "
        f"with element stride 1 or 2 and rows and planes packed behind them")


def _check_call(op: StencilPML, u_re, u_im, k_sq, s_re, s_im):
    if u_re.dim() != 3 or tuple(u_im.shape) != tuple(u_re.shape):
        raise ValueError(f"u_re and u_im must be [B, H, W] planes of one shape, "
                         f"got {tuple(u_re.shape)} and {tuple(u_im.shape)}")
    b, h, w = u_re.shape
    if (s_re is None) != (s_im is None):
        raise ValueError("s_re and s_im are both given or both None")
    if (tuple(k_sq.shape[-2:]) != (h, w) or k_sq.dim() not in (2, 3)
            or (k_sq.dim() == 3 and k_sq.shape[0] != b)):
        raise ValueError(f"k_sq has shape {tuple(k_sq.shape)}, expected "
                         f"[B, H, W] or [H, W] with H, W = {h}, {w}")
    if op.radius not in RADII:
        raise ValueError(f"the kernels take stencil radius {RADII}, not {op.radius}")
    if op.width != w or op.height != h:
        raise ValueError(f"operator is {op.height}x{op.width}, fields are {h}x{w}")


def _into(out, rr, ri):
    if out is None:
        return rr, ri
    out[0].copy_(rr)
    out[1].copy_(ri)
    return out


VARIANTS = ("scalar", "planes", "pairs")  # the kernel's `mode` argument


def _interleaved(re: torch.Tensor, im: torch.Tensor, es: int) -> bool:
    """Whether re and im are the two halves of one (re, im) pair buffer."""
    return es == 2 and im.data_ptr() == re.data_ptr() + 4


def _operands(op: StencilPML, u_re, u_im, k_sq, s_re, s_im, out):
    """Check every operand of a launch and pick the instance. Returns
    (variant, k3, strides): `k3` is k_sq as [B, H, W] (a batch stride of 0
    broadcasts one plane) and `strides` (ubs, uxs, kbs, sbs, sxs, rbs, rxs)
    in elements. `out=None` stands for fresh planes in u's layout
    (`_empty_planes`), which fit whatever instance u fits; rbs and rxs are
    then None."""
    device = u_re.device
    b, h, w = u_re.shape
    shape = (b, h, w)
    ubs, uxs = _plane_strides("u_re", u_re, shape, device)
    if _plane_strides("u_im", u_im, shape, device) != (ubs, uxs):
        raise ValueError("u_re and u_im must share their strides")
    k3 = k_sq if k_sq.dim() == 3 else k_sq.expand(shape)
    kbs, kxs = _plane_strides("k_sq", k3, shape, device, batch_broadcast=True)
    if kxs != 1:
        raise ValueError("k_sq must have element stride 1")
    fields = [(u_re, u_im, ubs, uxs)]
    sbs = sxs = 0
    if s_re is not None:
        sbs, sxs = _plane_strides("s_re", s_re, shape, device)
        if _plane_strides("s_im", s_im, shape, device) != (sbs, sxs):
            raise ValueError("s_re and s_im must share their strides")
        fields.append((s_re, s_im, sbs, sxs))
    rbs = rxs = None
    if out is not None:
        rbs, rxs = _plane_strides("r_re", out[0], shape, device)
        if _plane_strides("r_im", out[1], shape, device) != (rbs, rxs):
            raise ValueError("r_re and r_im must share their strides")
        fields.append((out[0], out[1], rbs, rxs))

    at = lambda t, n: t.data_ptr() % n == 0
    if h < op.radius:  # a chunk would need more than one period of wrap
        variant = "scalar"
    elif (w % 2 == 0 and at(k3, 8) and kbs % 2 == 0
          and all(_interleaved(re, im, es) and at(re, 16) and bs % 4 == 0
                  for re, im, bs, es in fields)):
        variant = "pairs"
    elif (w % 4 == 0 and at(k3, 16) and kbs % 4 == 0
          and all(es == 1 and at(re, 16) and at(im, 16) and bs % 4 == 0
                  for re, im, bs, es in fields)):
        variant = "planes"
    else:
        variant = "scalar"
    return variant, k3, (ubs, uxs, kbs, sbs, sxs, rbs, rxs)


def _empty_planes(u_re, u_im, uxs: int):
    """(r_re, r_im) in u's layout: the halves of one [B, H, W, 2] buffer
    when u's planes are, else two split planes."""
    if _interleaved(u_re, u_im, uxs):
        r = torch.empty((*u_re.shape, 2), dtype=torch.float32, device=u_re.device)
        return r[..., 0], r[..., 1]
    return (torch.empty(u_re.shape, dtype=torch.float32, device=u_re.device),
            torch.empty(u_re.shape, dtype=torch.float32, device=u_re.device))


def stencil_variant(op: StencilPML, u_re, u_im, k_sq, s_re=None, s_im=None,
                    *, out=None) -> str:
    """The kernel instance a launch with these operands takes, on any
    device: `pairs` when u, s and r are each one buffer of interleaved
    (re, im) pairs (16-byte aligned, k_sq 8-byte aligned, W even),
    `planes` when all are split planes (16-byte aligned, W % 4 == 0), else
    `scalar`; the vector instances also need H >= the stencil radius.
    `out=None` stands for the planes the launch would allocate: u's
    layout."""
    _check_call(op, u_re, u_im, k_sq, s_re, s_im)
    return _operands(op, u_re, u_im, k_sq, s_re, s_im, out)[0]


def _launch(op: StencilPML, u_re, u_im, k_sq, s_re, s_im, out):
    """Check every operand and launch `hn_stencil_residual` on the current
    stream, with the instance `stencil_variant` picks. Returns
    (r_re, r_im)."""
    device = u_re.device
    if device.type != "cuda":
        raise ValueError(f"the stencil kernels run on cuda or cpu, not {device}")
    variant, k3, strides = _operands(op, u_re, u_im, k_sq, s_re, s_im, out)
    ubs, uxs, kbs, sbs, sxs, rbs, rxs = strides
    b, h, w = u_re.shape
    if out is None:
        out = _empty_planes(u_re, u_im, uxs)
        rbs, rxs = _plane_strides("r_re", out[0], (b, h, w), device)
    tables = (op.cx_r, op.cx_i, op.cy_r, op.cy_i)
    for name, t, n in zip(("cx_r", "cx_i", "cy_r", "cy_i"), tables, (w, w, h, h)):
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"operator {name} must be contiguous float32 on {device}")
        if tuple(t.shape) != (2 * op.radius + 1, n):
            raise ValueError(f"operator {name} has shape {tuple(t.shape)}")

    from .._build import load_library

    lib = load_library()
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hn_stencil_residual(
            ptr(u_re), ptr(u_im), ubs, uxs, ptr(k3), kbs,
            ptr(s_re), ptr(s_im), sbs, sxs, ptr(out[0]), ptr(out[1]), rbs, rxs,
            *map(ptr, tables), b, h, w, op.radius, VARIANTS.index(variant),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"hn_stencil_residual ({variant}) launch failed: "
                           f"CUDA error {rc}")
    return out


@sanitize.kernel("K2a (residual_planes, ops/stencil_residual.py)")
def residual_planes(op: StencilPML, u_re, u_im, k_sq, s_re=None, s_im=None,
                    *, out=None):
    """Fused stencil residual on split planes [B, H, W] -> (r_re, r_im).

    `k_sq` is [B, H, W] or [H, W]; `s_re`/`s_im` may be None (zero).
    `out`: optional (r_re, r_im) planes to write into, for example the two
    halves of a channel-pair tensor; they must not overlap the inputs.
    Without it the kernel writes planes in u's layout (the halves of one
    pair buffer when u's are)."""
    _check_call(op, u_re, u_im, k_sq, s_re, s_im)
    if u_re.device.type == "cpu":
        return _into(out, *residual_planes_plain(op, u_re, u_im, k_sq, s_re, s_im))
    out = _launch(op, u_re, u_im, k_sq, s_re, s_im, out)
    residual_planes.launches += 1
    return out


def _tile_rows(h: int, tile_h: int) -> None:
    if tile_h <= 0 or h % tile_h != 0:
        raise ValueError(f"H={h} must be divisible by tile_h={tile_h}")


@sanitize.kernel("K2b (residual_planes_tiled, ops/stencil_residual.py)")
def residual_planes_tiled(op: StencilPML, u_re, u_im, k_sq, s_re=None,
                          s_im=None, *, tile_h: int = 128, out=None):
    """Row-tiled stencil residual for large grids (K2b). `tile_h` is the
    TPU kernel's VMEM row tile: H must be a multiple of it, and a single
    tile goes to `residual_planes`, as on the TPU. The CUDA kernel is
    `residual_planes`' own; `tile_h` does not set its tile."""
    _check_call(op, u_re, u_im, k_sq, s_re, s_im)
    h = u_re.shape[1]
    _tile_rows(h, tile_h)
    if h == tile_h:
        return residual_planes(op, u_re, u_im, k_sq, s_re, s_im, out=out)
    if u_re.device.type == "cpu":
        return _into(out, *residual_planes_plain(op, u_re, u_im, k_sq, s_re, s_im))
    out = _launch(op, u_re, u_im, k_sq, s_re, s_im, out)
    residual_planes_tiled.launches += 1
    return out


@sanitize.kernel("K2c (residual_planes_mxu, ops/stencil_residual.py)")
def residual_planes_mxu(op: StencilPML, u_re, u_im, k_sq, s_re=None,
                        s_im=None, *, tile_h: int = 128, out=None):
    """Stencil residual whose TPU kernel did the x taps as a banded product
    on the MXU (K2c). The same `tile_h` checks as `residual_planes_tiled`.
    The band picks each tap once only when W >= 2r + 1, so narrower grids
    raise on every device. On the CPU its plain version is the banded
    product; on the card it launches the one stencil kernel with the tap
    tables, which agrees with the band to about 1e-6."""
    _check_call(op, u_re, u_im, k_sq, s_re, s_im)
    h, w = u_re.shape[1:]
    _tile_rows(h, tile_h)
    if h == tile_h:
        return residual_planes(op, u_re, u_im, k_sq, s_re, s_im, out=out)
    if w < 2 * op.radius + 1:
        raise ValueError(f"W={w} is narrower than the {2 * op.radius + 1}-tap band")
    if u_re.device.type == "cpu":
        return _into(out, *residual_planes_mxu_plain(op, u_re, u_im, k_sq, s_re,
                                                     s_im))
    out = _launch(op, u_re, u_im, k_sq, s_re, s_im, out)
    residual_planes_mxu.launches += 1
    return out


residual_planes.launches = 0
residual_planes_tiled.launches = 0
residual_planes_mxu.launches = 0


def reset_launches() -> None:
    residual_planes.launches = 0
    residual_planes_tiled.launches = 0
    residual_planes_mxu.launches = 0


# bytes; 7 f32 planes double-buffered in the TPU's VMEM. Kept so that the
# choice between the whole-plane and the tiled entry point, and so the
# launch count of each, is the JAX package's.
_WHOLE_PLANE_VMEM_BUDGET = 10_000_000


def helmholtz_residual_kernel(op: StencilPML, u: torch.Tensor,
                              k_sq: torch.Tensor,
                              source: torch.Tensor | None = None) -> torch.Tensor:
    """Channel-pair wrapper, the counterpart of `helmholtz_residual_pallas`:
    u, source [..., H, W, 2]; k_sq [..., H, W] (one plane broadcasts over
    the batch); source None means zero. Whole-plane entry point below the
    TPU's VMEM budget or when H % 128 != 0, else the tiled one. The planes
    go to the kernel as stride-2 halves of the pairs: no copies."""
    h, w = u.shape[-3], u.shape[-2]
    u4 = u.reshape(-1, h, w, 2)
    b = u4.shape[0]
    k3 = k_sq.reshape(-1, h, w)
    if k3.shape[0] == 1 and b > 1:
        k3 = k3.expand(b, h, w)
    s4 = None if source is None else source.reshape(b, h, w, 2)
    r = torch.empty(u4.shape, dtype=u.dtype, device=u.device)
    args = (op, u4[..., 0], u4[..., 1], k3,
            None if s4 is None else s4[..., 0], None if s4 is None else s4[..., 1])
    out = (r[..., 0], r[..., 1])
    if h * w * 4 * 7 * 2 <= _WHOLE_PLANE_VMEM_BUDGET or h % 128 != 0:
        residual_planes(*args, out=out)
    else:
        residual_planes_tiled(*args, tile_h=128, out=out)
    return r.reshape(u.shape)


def kernel_supported(height: int, width: int, device) -> bool:
    """The counterpart of `pallas_supported`: the CUDA kernel takes any
    grid of H, W >= 1, on a CUDA device. (The TPU kernel needed W % 128 ==
    0 and H % 8 == 0 on a TPU.)"""
    return torch.device(device).type == "cuda" and height >= 1 and width >= 1


def helmholtz_residual_stencil_auto(op: StencilPML, u: torch.Tensor,
                                    k_sq: torch.Tensor,
                                    source: torch.Tensor | None = None):
    """The kernel for CUDA tensors, the plain stencil of ops/stencil.py for
    CPU tensors (as the JAX dispatcher takes Pallas on a TPU and XLA
    elsewhere). source None means zero."""
    h, w = u.shape[-3], u.shape[-2]
    if kernel_supported(h, w, u.device):
        return helmholtz_residual_kernel(op, u, k_sq, source)
    r = laplacian_stencil(op, u) + k_sq[..., None] * u
    return r if source is None else r - source


# ---------------------------------------------------------------------------
# The operator as an explicit sparse matrix (host, scipy)
# ---------------------------------------------------------------------------


def stencil_to_csr(op: StencilPML, k_sq=None):
    """Assemble the full (H*W, H*W) complex CSR matrix of the stencil
    operator (+ diag(k_sq)) with scipy: the explicit form of what the
    kernels apply matrix-free. Host-side, for verification and direct
    solves."""
    import numpy as np
    import scipy.sparse as sp

    host = lambda t: t.detach().cpu().numpy()
    cxr, cxi, cyr, cyi = map(host, (op.cx_r, op.cx_i, op.cy_r, op.cy_i))
    ntaps, w = cxr.shape
    h = cyr.shape[1]
    r = (ntaps - 1) // 2

    cx = cxr + 1j * cxi  # [ntaps, W]
    cy = cyr + 1j * cyi  # [ntaps, H]

    def axis_matrix(c, n):
        A = np.zeros((n, n), np.complex128)
        for t in range(ntaps):
            off = t - r
            for i in range(n):
                A[i, (i + off) % n] += c[t, i]
        return sp.csr_matrix(A)

    Ax = axis_matrix(cx, w)
    Ay = axis_matrix(cy, h)
    M = sp.kron(sp.identity(h), Ax) + sp.kron(Ay, sp.identity(w))
    if k_sq is not None:
        if isinstance(k_sq, torch.Tensor):
            k_sq = host(k_sq)
        M = M + sp.diags(np.asarray(k_sq, np.complex128).ravel())
    return M.tocsr()

"""The port's fused stencil residual entry points (ops/stencil_residual.py)
against the JAX package's Pallas kernels (ops/pallas_stencil.py), on the
CPU: JAX runs its kernels in interpret mode, the port its plain versions.
The cases are tests/test_pallas_stencil.py's own, at its tolerances:

- `residual_planes` / the channel-pair wrapper at 32^2, orders 2 and 4,
  and 16x48: atol 1e-5 (:35, :76);
- `residual_planes_tiled` and `residual_planes_mxu` at 256x128 with
  tile_h=64: atol 1e-5 (:90) and 2e-4 (:116); tile_h=40 raises (:93);
- `stencil_to_csr @ u` against the plain residual: atol 1e-4 (:51).

Also: a stride-2 complex64 view gives the split-plane result, s=None
equals s=0, the dispatcher takes the plain stencil on the CPU, and no
launch is counted on the CPU.
"""

import numpy as np
import pytest
import torch

from helmnet_tpu.ops import pallas_stencil as jps
from helmnet_tpu.ops import stencil as jst
from helmnet_tpu_torch.ops import stencil as tst
from helmnet_tpu_torch.ops import stencil_residual as tsr


def _ops(h, w, order, pml):
    return (jst.make_stencil_operator(h, w, pml, 2.0, 1.0, order=order),
            tst.make_stencil_operator(h, w, pml, 2.0, 1.0, order=order,
                                      device="cpu"))


def _fields(b, h, w, seed, ones=False):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    if ones:
        return u, np.ones((b, h, w), np.float32), np.zeros_like(u)
    k_sq = rng.uniform(0.5, 1.2, (b, h, w)).astype(np.float32)
    src = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    return u, k_sq, src


def _planes(u, k_sq, src):
    t = lambda a: torch.tensor(np.ascontiguousarray(a))
    return t(u[..., 0]), t(u[..., 1]), t(k_sq), t(src[..., 0]), t(src[..., 1])


@pytest.mark.parametrize("h,w,order,pml,ones", [
    (32, 32, 2, 4, False), (32, 32, 4, 4, False), (16, 48, 4, 4, True),
])
def test_pair_wrapper_matches_pallas(h, w, order, pml, ones):
    jop, top = _ops(h, w, order, pml)
    u, k_sq, src = _fields(3 if h == 32 else 2, h, w, seed=h + order, ones=ones)
    ref = np.asarray(jps.helmholtz_residual_pallas(jop, u, k_sq, src,
                                                   interpret=True))
    got = tsr.helmholtz_residual_kernel(top, torch.tensor(u), torch.tensor(k_sq),
                                        torch.tensor(src)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    rr, ri = tsr.residual_planes(top, *_planes(u, k_sq, src))
    np.testing.assert_allclose(np.stack([rr.numpy(), ri.numpy()], -1), ref,
                               atol=1e-5)


@pytest.mark.parametrize("entry,atol", [("tiled", 1e-5), ("mxu", 2e-4)])
def test_row_tiled_entry_points_match_pallas(entry, atol):
    jop, top = _ops(256, 128, 4, 8)
    u, k_sq, src = _fields(2, 256, 128, seed=3 if entry == "tiled" else 4)
    jfn = jps.residual_planes_tiled if entry == "tiled" else jps.residual_planes_mxu
    tfn = tsr.residual_planes_tiled if entry == "tiled" else tsr.residual_planes_mxu
    jr, ji = jfn(jop, u[..., 0], u[..., 1], k_sq, src[..., 0], src[..., 1],
                 tile_h=64, interpret=True)
    rr, ri = tfn(top, *_planes(u, k_sq, src), tile_h=64)
    np.testing.assert_allclose(rr.numpy(), np.asarray(jr), atol=atol)
    np.testing.assert_allclose(ri.numpy(), np.asarray(ji), atol=atol)
    # and against the XLA-form stencil of the port
    xla = tst.helmholtz_residual_stencil(top, torch.tensor(u), torch.tensor(k_sq),
                                         torch.tensor(src)).numpy()
    np.testing.assert_allclose(np.stack([rr.numpy(), ri.numpy()], -1), xla,
                               atol=atol)


@pytest.mark.parametrize("entry", ["tiled", "mxu"])
def test_bad_tile_divisor(entry):
    _, top = _ops(96, 128, 4, 8)
    z = torch.zeros((1, 96, 128))
    fn = tsr.residual_planes_tiled if entry == "tiled" else tsr.residual_planes_mxu
    with pytest.raises(ValueError, match="divisible"):
        fn(top, z, z, z, z, z, tile_h=40)


def test_mxu_refuses_a_grid_narrower_than_its_band():
    _, top = _ops(8, 4, 4, 1)
    z = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="band"):
        tsr.residual_planes_mxu(top, z, z, z, tile_h=4)


@pytest.mark.parametrize("order", [2, 4])
def test_csr_matvec_matches_plain_residual(order):
    _, top = _ops(32, 32, order, 4)
    rng = np.random.default_rng(1)
    uc = rng.standard_normal((32, 32)) + 1j * rng.standard_normal((32, 32))
    k_sq = rng.uniform(0.5, 1.2, (32, 32))
    expected = (tsr.stencil_to_csr(top, k_sq) @ uc.ravel()).reshape(32, 32)
    u = torch.tensor(np.stack([uc.real, uc.imag], -1).astype(np.float32)[None])
    rr, ri = tsr.residual_planes(top, u[..., 0], u[..., 1],
                                 torch.tensor(k_sq.astype(np.float32))[None])
    np.testing.assert_allclose((rr + 1j * ri)[0].numpy(), expected, atol=1e-4)


def test_complex_view_no_source_and_dispatch():
    """A complex64 tensor through view_as_real (element stride 2) gives the
    split-plane result; s=None equals s=0; the CPU dispatcher is the plain
    stencil of ops/stencil.py; no launch is counted on the CPU."""
    _, top = _ops(24, 40, 4, 4)
    u, k_sq, _ = _fields(2, 24, 40, seed=5)
    uc = torch.view_as_complex(torch.tensor(u))
    pair = torch.view_as_real(uc)
    k = torch.tensor(k_sq)
    tsr.reset_launches()
    split = tsr.residual_planes(top, pair[..., 0].contiguous(),
                                pair[..., 1].contiguous(), k)
    strided = tsr.residual_planes(top, pair[..., 0], pair[..., 1], k)
    zeros = torch.zeros_like(pair[..., 0])
    with_zero_s = tsr.residual_planes(top, pair[..., 0], pair[..., 1], k,
                                      zeros, zeros)
    for a, b, c in zip(split, strided, with_zero_s):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    auto = tsr.helmholtz_residual_stencil_auto(top, pair, k)
    lap = tst.laplacian_stencil(top, pair) + k[..., None] * pair
    torch.testing.assert_close(auto, lap, rtol=0, atol=0)
    np.testing.assert_allclose(auto.numpy(), torch.stack(split, -1).numpy(),
                               atol=1e-5)
    # one k^2 plane broadcasts over the batch
    one_k = tsr.helmholtz_residual_kernel(top, pair, k[:1])
    two_k = tsr.helmholtz_residual_kernel(top, pair, k[:1].expand(2, -1, -1).contiguous())
    torch.testing.assert_close(one_k, two_k, rtol=0, atol=0)
    assert not tsr.kernel_supported(24, 40, "cpu")
    assert tsr.kernel_supported(24, 40, "cuda")
    assert (tsr.residual_planes.launches, tsr.residual_planes_tiled.launches,
            tsr.residual_planes_mxu.launches) == (0, 0, 0)


def test_pair_wrapper_picks_the_tpu_entry_point(monkeypatch):
    """Whole plane below the VMEM budget or for H % 128 != 0, tiled with
    tile_h=128 above it: the JAX wrapper's choice."""
    calls = []
    monkeypatch.setattr(tsr, "residual_planes",
                        lambda *a, **k: calls.append("planes"))
    monkeypatch.setattr(tsr, "residual_planes_tiled",
                        lambda *a, **k: calls.append(("tiled", k["tile_h"])))
    for h, w in ((256, 256), (512, 512), (520, 512)):
        _, top = _ops(h, w, 4, 8)
        u = torch.zeros((1, h, w, 2))
        tsr.helmholtz_residual_kernel(top, u, torch.zeros((1, h, w)))
    assert calls == ["planes", ("tiled", 128), "planes"]


def test_wrapper_rejects_bad_arguments():
    _, top = _ops(32, 32, 4, 4)
    z = torch.zeros((1, 32, 32))
    with pytest.raises(ValueError, match="both"):
        tsr.residual_planes(top, z, z, z, z, None)
    with pytest.raises(ValueError, match="k_sq"):
        tsr.residual_planes(top, z, z, torch.zeros((1, 16, 32)))
    with pytest.raises(ValueError, match="k_sq"):
        z2 = torch.zeros((2, 32, 32))
        tsr.residual_planes(top, z2, z2, z)
    with pytest.raises(ValueError, match="operator"):
        tsr.residual_planes(top, torch.zeros((1, 16, 32)), torch.zeros((1, 16, 32)),
                            torch.zeros((1, 16, 32)))


def _pair_operands(b, h, w):
    """GMRES's matvec operands: stride-2 halves of a complex64 view."""
    pair = torch.view_as_real(torch.zeros((b, h, w), dtype=torch.complex64))
    return (pair[..., 0], pair[..., 1], torch.zeros((b, h, w)))


def _offset_planes(b, h, w):
    """Split planes that start one float into their buffers."""
    view = lambda: torch.zeros(b * h * w + 1)[1:].view(b, h, w)
    return (view(), view(), torch.zeros((b, h, w)), view(), view())


@pytest.mark.parametrize("case,want", [
    ("split 512^2 x 8", "planes"),
    ("view_as_real 16 x 256^2", "pairs"),
    ("channel pairs [B, H, W, 2]", "pairs"),
    ("W = 33", "scalar"),
    ("offset by one float", "scalar"),
    ("3x5 plane", "scalar"),
])
def test_stencil_variant(case, want):
    """The kernel instance each operand layout takes: the choice is made
    from shapes, strides and pointer alignment, which CPU tensors share
    with CUDA ones."""
    z = lambda *s: torch.zeros(s)
    kw = {}
    if case == "split 512^2 x 8":
        h = w = 512
        args = (z(8, h, w), z(8, h, w), z(8, h, w), z(8, h, w), z(8, h, w))
    elif case == "view_as_real 16 x 256^2":
        h = w = 256
        args = _pair_operands(16, h, w)
    elif case == "channel pairs [B, H, W, 2]":
        h, w = 64, 96
        u, s, r = z(3, h, w, 2), z(3, h, w, 2), z(3, h, w, 2)
        args = (u[..., 0], u[..., 1], z(h, w), s[..., 0], s[..., 1])
        kw["out"] = (r[..., 0], r[..., 1])
    elif case == "W = 33":
        h, w = 32, 33
        args = (z(2, h, w), z(2, h, w), z(2, h, w))
    elif case == "offset by one float":
        h, w = 64, 128
        args = _offset_planes(2, h, w)
    else:
        h, w = 3, 5
        args = (z(2, h, w), z(2, h, w), z(2, h, w))
    op = tst.make_stencil_operator(h, w, 1 if h == 3 else 4, 2.0, 1.0,
                                   device="cpu")
    assert tsr.stencil_variant(op, *args, **kw) == want

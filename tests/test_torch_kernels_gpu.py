"""Card-only tests: the port's CUDA kernels against their plain versions.

On a machine with an NVIDIA Hopper card and nvcc:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

(`--noconftest` because tests/conftest.py imports JAX, which that machine
does not have.) This file imports no JAX. Without a card every test skips,
decided inside the `cuda` fixture.
"""

import numpy as np
import pytest
import torch

from helmnet_tpu_torch.ops.double_conv import (
    double_conv_plain,
    fused_double_conv,
)

pytestmark = pytest.mark.gpu

TOL = 2e-2  # atol = TOL * max|ref|, as tests/test_pallas_pixconv.py:36


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from helmnet_tpu_torch.core.device import resolve_device

    return resolve_device("cuda")


def _conv(rng, cin, cout, k, device, scale):
    w = rng.standard_normal((cout, cin, k, k)).astype(np.float32) * scale
    b = rng.standard_normal(cout).astype(np.float32) * 0.1
    return {"w": torch.tensor(w, device=device), "b": torch.tensor(b, device=device)}


def _params(rng, cin, cmid, cout, device, act=True, c_emit=None):
    p = {
        "c1": _conv(rng, cin, cmid, 3, device, 0.3),
        "act": {"a": torch.tensor([0.25], device=device)} if act else {},
        "c2": _conv(rng, cmid, cout, 3, device, 0.3),
    }
    if c_emit is not None:
        p["post"] = _conv(rng, cout, c_emit, 1, device, 0.5)
    return p


def _inputs(rng, b, h, w, cins, device):
    return tuple(
        torch.tensor(rng.standard_normal((b, h, w, c)).astype(np.float32),
                     device=device)
        for c in cins
    )


def _check(p, parts):
    ref = double_conv_plain(p, parts)
    got = fused_double_conv(p, parts)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    atol = TOL * ref.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=atol)


@pytest.mark.parametrize(
    "cins,cmid,cout,c_emit,h,w",
    [
        ((6,), 8, 8, None, 96, 96),       # inc
        ((8, 2), 8, 8, None, 96, 96),     # enc signal with state
        ((8, 2), 2, 2, None, 48, 48),     # enc state
        ((8, 8), 8, 8, None, 24, 24),     # decode with skip
        ((8,), 8, 8, None, 6, 6),         # deepest decode, one ragged tile
        ((8, 8), 8, 8, 2, 96, 96),        # decode[0] with the outc head
        ((16,), 16, 16, 16, 20, 36),      # widest channels, ragged tiles
        ((3, 5), 3, 5, None, 17, 33),     # odd counts and sizes
    ],
)
def test_kernel_matches_plain(cuda, cins, cmid, cout, c_emit, h, w):
    rng = np.random.default_rng(0)
    p = _params(rng, sum(cins), cmid, cout, cuda, c_emit=c_emit)
    _check(p, _inputs(rng, 3, h, w, cins, cuda))


@pytest.mark.parametrize("with_head", [False, True])
@pytest.mark.parametrize(
    "b,h,w",
    [(32, 6, 6), (32, 12, 12), (32, 24, 24), (3, 40, 72), (1, 96, 96),
     (1, 24, 24)],
)
def test_kernel_tiles_and_prepared_weights(cuda, b, h, w, with_head):
    """Both output tiles (`tile_for` picks 8 x 8 at the small levels and
    for small batches, 16 x 16 else), ragged grids, batch 1, with and
    without the head; prepared weights give the bits of weights converted
    in the call."""
    from helmnet_tpu_torch.ops.double_conv import prepare

    rng = np.random.default_rng(h * 100 + w + b)
    p = _params(rng, 16, 8, 8, cuda, c_emit=2 if with_head else None)
    w1 = p["c1"]["w"]
    split = dict(p, c1={"w": (w1[:, :8].contiguous(), w1[:, 8:].contiguous()),
                        "b": p["c1"]["b"]})
    parts = _inputs(rng, b, h, w, (8, 8), cuda)
    _check(split, parts)
    torch.testing.assert_close(fused_double_conv(prepare(split), parts),
                               fused_double_conv(split, parts), rtol=0, atol=0)


@pytest.mark.parametrize("tile", [(16, 16), (8, 8)])
def test_kernel_at_either_tile(cuda, tile):
    """Each output tile, chosen or not, gives the plain version's result."""
    from helmnet_tpu_torch.ops.double_conv import prepare

    rng = np.random.default_rng(12)
    p = _params(rng, 10, 8, 8, cuda, c_emit=2)
    parts = _inputs(rng, 2, 40, 56, (8, 2), cuda)
    ref = double_conv_plain(p, parts)
    got = fused_double_conv(prepare(p), parts, tile=tile)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=TOL * ref.abs().max().item())


def test_relu_without_slope(cuda):
    rng = np.random.default_rng(1)
    p = _params(rng, 6, 8, 8, cuda, act=False)
    _check(p, _inputs(rng, 2, 32, 32, (6,), cuda))


def test_split_first_conv_weights(cuda):
    rng = np.random.default_rng(2)
    p = _params(rng, 10, 8, 8, cuda)
    w1 = p["c1"]["w"]
    split = dict(p, c1={"w": (w1[:, :8].contiguous(), w1[:, 8:].contiguous()),
                        "b": p["c1"]["b"]})
    parts = _inputs(rng, 2, 32, 32, (8, 2), cuda)
    torch.testing.assert_close(fused_double_conv(split, parts),
                               fused_double_conv(p, parts))


def test_side_stream(cuda):
    rng = np.random.default_rng(3)
    p = _params(rng, 16, 8, 8, cuda, c_emit=2)
    parts = _inputs(rng, 4, 48, 48, (8, 8), cuda)
    ref = fused_double_conv(p, parts)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        got = fused_double_conv(p, parts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref)


def test_counts_launches(cuda):
    rng = np.random.default_rng(4)
    p = _params(rng, 6, 8, 8, cuda)
    parts = _inputs(rng, 1, 16, 16, (6,), cuda)
    before = fused_double_conv.launches
    fused_double_conv(p, parts)
    double_conv_plain(p, parts)
    assert fused_double_conv.launches == before + 1


def test_wrapper_rejects(cuda):
    rng = np.random.default_rng(5)
    p = _params(rng, 6, 8, 8, cuda)
    x = _inputs(rng, 1, 16, 16, (6,), cuda)[0]
    with pytest.raises(ValueError, match="contiguous"):
        fused_double_conv(p, x.transpose(1, 2))
    with pytest.raises(ValueError, match="dtype"):
        fused_double_conv(p, x.double())
    with pytest.raises(ValueError, match="unsupported"):
        wide = _params(rng, 18, 8, 8, cuda)
        fused_double_conv(wide, _inputs(rng, 1, 16, 16, (18,), cuda))
    with pytest.raises(ValueError, match="parts"):
        three = _params(rng, 6, 8, 8, cuda)
        fused_double_conv(three, _inputs(rng, 1, 16, 16, (2, 2, 2), cuda))
    with pytest.raises(ValueError, match="on cpu"):
        fused_double_conv(p, (x, x[..., :2].cpu().contiguous()))


# ---------------------------------------------------------------------------
# K3: the packed fused DoubleConv (ops/packed_double_conv.py)
# ---------------------------------------------------------------------------


def _check_k3(p, parts):
    from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv, prepare

    ref = double_conv_plain(p, parts)
    got = packed_double_conv(p, parts)
    again = packed_double_conv(prepare(p), parts)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    atol = TOL * ref.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=atol)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize(
    "cins,cmid,cout,c_emit,h,w",
    [
        ((32, 32, 32), 128, 128, None, 20, 36),   # inc at g=16, ragged tiles
        ((128, 32), 128, 128, None, 33, 17),      # enc signal with state
        ((128, 32), 32, 32, None, 16, 16),        # enc state
        ((128,), 128, 128, None, 16, 16),         # deepest decode
        ((128, 128), 128, 128, 32, 40, 24),       # decode[0] with the outc head
        ((12, 20), 24, 16, None, 17, 33),         # narrow widths, padded
        ((3, 5, 7), 10, 6, 5, 9, 11),             # odd widths: scalar loads
        ((40,), 100, 70, 5, 7, 30),               # mid 100 in the 128 instance
        ((16, 16), 128, 32, None, 8, 16),         # one whole tile
    ],
)
def test_k3_matches_plain(cuda, cins, cmid, cout, c_emit, h, w):
    rng = np.random.default_rng(0)
    p = _params(rng, sum(cins), cmid, cout, cuda, c_emit=c_emit)
    p["c1"]["w"] = p["c1"]["w"] * 0.3  # keep wide sums near unit scale
    p["c2"]["w"] = p["c2"]["w"] * 0.3
    w1 = p["c1"]["w"]
    bounds = np.cumsum((0,) + cins)
    split = dict(p, c1={"w": tuple(w1[:, a:b].contiguous()
                                   for a, b in zip(bounds[:-1], bounds[1:])),
                        "b": p["c1"]["b"]})
    _check_k3(split, _inputs(rng, 2, h, w, cins, cuda))


@pytest.mark.parametrize(
    "n,cins,cmid,cout,c_emit",
    [
        (16, (128,), 128, 128, None),          # decode[4]: the small tile
        (32, (128, 32), 128, 128, None),       # enc[3].conv_signal
        (32, (128, 32), 32, 32, None),         # enc[3].conv_state
        (64, (128, 128), 128, 128, None),      # decode[2]
        (256, (32, 32, 32), 128, 128, None),   # inc: the large tile, wgmma
        (256, (128, 32), 32, 32, None),        # enc[0].conv_state
        (256, (128, 128), 128, 128, 32),       # decode[0] with the head
        (128, (128, 128), 128, 128, None),     # decode[1]
    ],
)
def test_k3_levels_of_a_packed_step(cuda, n, cins, cmid, cout, c_emit):
    """The widths of the 256^2, g = 16 packed step at its levels: 4 x 8
    tiles on mma.sync at 64^2 and below, 8 x 16 tiles on wgmma through the
    chunk ring at 128^2 and 256^2."""
    from helmnet_tpu_torch.ops.packed_double_conv import TILES, tile_for

    assert tile_for(1, n, n) == (TILES[0] if n >= 128 else TILES[-1])
    rng = np.random.default_rng(n + cmid)
    p = _params(rng, sum(cins), cmid, cout, cuda, c_emit=c_emit)
    p["c1"]["w"] = p["c1"]["w"] * 0.3
    p["c2"]["w"] = p["c2"]["w"] * 0.3
    w1 = p["c1"]["w"]
    bounds = np.cumsum((0,) + cins)
    split = dict(p, c1={"w": tuple(w1[:, a:b].contiguous()
                                   for a, b in zip(bounds[:-1], bounds[1:])),
                        "b": p["c1"]["b"]})
    _check_k3(split, _inputs(rng, 1, n, n, cins, cuda))


@pytest.mark.parametrize("tile", [(8, 16), (4, 8)])
def test_k3_at_either_tile(cuda, tile):
    """Each K3 output tile, chosen or not, gives the plain version's result
    (ragged edges, the head)."""
    from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv, prepare

    rng = np.random.default_rng(13)
    p = _params(rng, 160, 128, 128, cuda, c_emit=32)
    p["c1"]["w"] = p["c1"]["w"] * 0.3
    p["c2"]["w"] = p["c2"]["w"] * 0.3
    parts = _inputs(rng, 1, 36, 20, (160,), cuda)
    ref = double_conv_plain(p, parts)
    got = packed_double_conv(prepare(p), parts, tile=tile)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=TOL * ref.abs().max().item())


def test_k3_relu_without_slope(cuda):
    rng = np.random.default_rng(1)
    p = _params(rng, 96, 128, 128, cuda, act=False)
    _check_k3(p, _inputs(rng, 1, 24, 24, (96,), cuda))


def test_k3_side_stream(cuda):
    from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv, prepare

    rng = np.random.default_rng(3)
    p = prepare(_params(rng, 64, 32, 32, cuda, c_emit=8))
    parts = _inputs(rng, 2, 40, 40, (64,), cuda)
    ref = packed_double_conv(p, parts)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        got = packed_double_conv(p, parts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref)


def test_k3_counts_launches(cuda):
    from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv

    rng = np.random.default_rng(4)
    p = _params(rng, 32, 32, 32, cuda)
    parts = _inputs(rng, 1, 16, 16, (32,), cuda)
    before = packed_double_conv.launches
    packed_double_conv(p, parts)
    double_conv_plain(p, parts)
    assert packed_double_conv.launches == before + 1


def test_k3_wrapper_rejects(cuda):
    from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv

    rng = np.random.default_rng(5)
    p = _params(rng, 32, 32, 32, cuda)
    x = _inputs(rng, 1, 16, 16, (32,), cuda)[0]
    with pytest.raises(ValueError, match="contiguous"):
        packed_double_conv(p, x.transpose(1, 2))
    with pytest.raises(ValueError, match="dtype"):
        packed_double_conv(p, x.double())
    with pytest.raises(ValueError, match="unsupported"):
        wide = _params(rng, 32, 136, 32, cuda)
        packed_double_conv(wide, x)
    with pytest.raises(ValueError, match="unsupported"):
        four = _params(rng, 32, 32, 32, cuda)
        packed_double_conv(four, _inputs(rng, 1, 16, 16, (8, 8, 8, 8), cuda))
    with pytest.raises(ValueError, match="on cpu"):
        two = _params(rng, 40, 32, 32, cuda)
        packed_double_conv(two, (x, x[..., :8].cpu().contiguous()))


# ---------------------------------------------------------------------------
# K2a-c: the fused stencil residual (ops/stencil_residual.py)
# ---------------------------------------------------------------------------

# K2a and K2b repeat their plain version's roundings in its order, so they
# are held to the bit; K2c's plain version is the banded product, whose x
# taps sum in another order: atol 2e-4 (tests/test_pallas_stencil.py:116)
K2_ATOL = {"planes": 0.0, "tiled": 0.0, "mxu": 2e-4}


def _k2_fields(rng, b, h, w, device):
    t = lambda a: torch.tensor(a.astype(np.float32), device=device)
    u = t(rng.standard_normal((b, h, w, 2)))
    s = t(rng.standard_normal((b, h, w, 2)))
    k_sq = t(rng.uniform(0.5, 1.2, (b, h, w)))
    return u, s, k_sq


def _k2_entry(kind, tile_h):
    from helmnet_tpu_torch.ops import stencil_residual as sr

    if kind == "planes":
        return sr.residual_planes, sr.residual_planes_plain
    entry = sr.residual_planes_tiled if kind == "tiled" else sr.residual_planes_mxu
    plain = (sr.residual_planes_plain if kind == "tiled"
             else sr.residual_planes_mxu_plain)
    return (lambda *a, **k: entry(*a, tile_h=tile_h, **k)), plain


def _k2_operands(layout, u, s, k_sq, with_s, k_broadcast):
    """The planes of one case: split, stride-2 halves of [B, H, W, 2],
    stride-2 halves of complex64 views, or split planes one float into
    their buffers."""
    if layout == "complex":
        u = torch.view_as_real(torch.view_as_complex(u.contiguous()))
        s = torch.view_as_real(torch.view_as_complex(s.contiguous()))
    if layout in ("pairs", "complex"):
        planes = [u[..., 0], u[..., 1], s[..., 0], s[..., 1]]
    else:
        planes = [t.contiguous() for t in (u[..., 0], u[..., 1], s[..., 0], s[..., 1])]
    if layout == "offset":
        def shifted(t):
            buf = torch.empty(t.numel() + 1, device=t.device)
            buf[1:].copy_(t.reshape(-1))
            return buf[1:].view(t.shape)
        planes = [shifted(t) for t in planes]
    ur, ui, sr_, si = planes
    if not with_s:
        sr_ = si = None
    k = k_sq[0] if k_broadcast else k_sq
    return ur, ui, k, sr_, si


@pytest.mark.parametrize("kind", ["planes", "tiled", "mxu"])
@pytest.mark.parametrize(
    "order,b,h,w,pml,layout,with_s,k_broadcast,variant",
    [
        (4, 2, 64, 128, 8, "split", True, False, "planes"),   # aligned, split planes
        (2, 2, 64, 128, 8, "split", True, False, "planes"),   # order 2
        (4, 3, 96, 72, 8, "pairs", True, False, "pairs"),     # ragged columns, pairs
        (4, 1, 40, 40, 8, "split", False, False, "planes"),   # s = None
        (2, 2, 32, 33, 8, "pairs", False, False, "scalar"),   # ragged, stride 2, no s
        (4, 2, 3, 5, 1, "split", True, False, "scalar"),      # PML 1: wraps twice
        (4, 2, 1, 1, 0, "split", True, False, "scalar"),      # one point
        (4, 3, 64, 128, 8, "split", True, True, "planes"),    # k^2 broadcast
        (4, 3, 48, 64, 8, "pairs", True, True, "pairs"),      # k^2 broadcast, pairs
        (4, 2, 64, 128, 8, "offset", True, False, "scalar"),  # misaligned views
        (4, 16, 256, 256, 8, "complex", False, False, "pairs"),  # GMRES's matvec
    ],
)
def test_k2_matches_plain(cuda, kind, order, b, h, w, pml, layout, with_s,
                          k_broadcast, variant):
    from helmnet_tpu_torch.ops import stencil_residual as sr
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator

    rng = np.random.default_rng(order * 100 + h + w)
    op = make_stencil_operator(h, w, pml, 2.0, 1.0, order=order, device=cuda)
    u, s, k_sq = _k2_fields(rng, b, h, w, cuda)
    args = _k2_operands(layout, u, s, k_sq, with_s, k_broadcast)
    assert sr.stencil_variant(op, *args) == variant
    entry, plain = _k2_entry(kind, h // 2 if h % 2 == 0 else 1)
    got = entry(op, *args)
    ref = plain(op, *args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        if K2_ATOL[kind] == 0.0:
            assert torch.equal(g, r)
        else:
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       atol=K2_ATOL[kind])


def test_k2_pair_wrapper_and_complex_view(cuda):
    """The channel-pair wrapper and a complex64 tensor seen through
    view_as_real give the split-plane result, and s=None equals s=0."""
    from helmnet_tpu_torch.ops import stencil_residual as sr
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator

    rng = np.random.default_rng(7)
    op = make_stencil_operator(48, 80, 8, 2.0, 1.0, device=cuda)
    u, s, k_sq = _k2_fields(rng, 2, 48, 80, cuda)
    ref = torch.stack(sr.residual_planes_plain(
        op, u[..., 0], u[..., 1], k_sq, s[..., 0], s[..., 1]), -1)
    got = sr.helmholtz_residual_kernel(op, u, k_sq, s)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    uc = torch.view_as_complex(u.contiguous())
    no_s = sr.helmholtz_residual_stencil_auto(op, torch.view_as_real(uc), k_sq)
    zero_s = sr.helmholtz_residual_kernel(op, u, k_sq, torch.zeros_like(s))
    torch.cuda.synchronize()
    torch.testing.assert_close(no_s, zero_s, rtol=0, atol=0)


def test_k2_tile_rules_and_counts(cuda):
    from helmnet_tpu_torch.ops import stencil_residual as sr
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator

    rng = np.random.default_rng(8)
    op = make_stencil_operator(128, 64, 8, 2.0, 1.0, device=cuda)
    u, s, k_sq = _k2_fields(rng, 1, 128, 64, cuda)
    planes = (u[..., 0], u[..., 1], k_sq, s[..., 0], s[..., 1])
    sr.reset_launches()
    sr.residual_planes_tiled(op, *planes, tile_h=64)
    sr.residual_planes_tiled(op, *planes, tile_h=128)  # one tile: K2a
    sr.residual_planes_mxu(op, *planes, tile_h=32)
    sr.residual_planes_plain(op, *planes)
    counts = (sr.residual_planes.launches, sr.residual_planes_tiled.launches,
              sr.residual_planes_mxu.launches)
    assert counts == (1, 1, 1)
    with pytest.raises(ValueError, match="divisible"):
        sr.residual_planes_tiled(op, *planes, tile_h=40)


def test_k2_wrapper_rejects(cuda):
    from helmnet_tpu_torch.ops import stencil_residual as sr
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator

    rng = np.random.default_rng(9)
    op = make_stencil_operator(32, 32, 4, 2.0, 1.0, device=cuda)
    u, s, k_sq = _k2_fields(rng, 1, 32, 32, cuda)
    ur, ui = u[..., 0].contiguous(), u[..., 1].contiguous()
    with pytest.raises(ValueError, match="dtype"):
        sr.residual_planes(op, ur.double(), ui.double(), k_sq)
    with pytest.raises(ValueError, match="strides"):
        sr.residual_planes(op, ur.transpose(1, 2), ui.transpose(1, 2), k_sq)
    with pytest.raises(ValueError, match="on cpu"):
        sr.residual_planes(op, ur, ui.cpu(), k_sq)
    with pytest.raises(ValueError, match="operator"):
        sr.residual_planes(op.to("cpu"), ur, ui, k_sq)


def test_k2c_launches_the_one_kernel(cuda):
    """K2c on the card raises only its own counter, agrees with K2a's
    kernel to the bit (the same launch with the same tap tables), and the
    library has no tensor-core band kernel any more."""
    from helmnet_tpu_torch._build import load_library
    from helmnet_tpu_torch.ops import stencil_residual as sr
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator

    rng = np.random.default_rng(10)
    op = make_stencil_operator(128, 128, 8, 2.0, 1.0, device=cuda)
    u, s, k_sq = _k2_fields(rng, 2, 128, 128, cuda)
    planes = (u[..., 0], u[..., 1], k_sq, s[..., 0], s[..., 1])
    sr.reset_launches()
    got = sr.residual_planes_mxu(op, *planes, tile_h=64)
    assert (sr.residual_planes.launches, sr.residual_planes_tiled.launches,
            sr.residual_planes_mxu.launches) == (0, 0, 1)
    ref = sr.residual_planes(op, *planes)
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert not hasattr(load_library(), "hn_stencil_residual_mma")


def _r2c(cfg, device):
    from pathlib import Path

    from helmnet_tpu_torch.weights import load_params_npz

    npz = Path(__file__).resolve().parent.parent / "trained_models" / "tpu_r2c_best.npz"
    return load_params_npz(str(npz), cfg, device=device)


def test_k1_inside_the_learned_preconditioner(cuda):
    """One application of `make_learned_preconditioner` in 'pallas' mode
    launches K1 14 times a step with weights prepared once, and equals the
    same application on the CPU, where the wrapper takes the plain version,
    within K1's tolerance."""
    import dataclasses

    from helmnet_tpu_torch.core.config import Config
    from helmnet_tpu_torch.ops.spectral import make_operator
    from helmnet_tpu_torch.solvers.fgmres import make_learned_preconditioner

    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, precision="default",
                                                double_conv_mode="pallas",
                                                up_mode="subpixel"))
    params = _r2c(cfg, cuda)
    rng = np.random.default_rng(11)
    n, iters = 96, 4
    sos = np.ones((n, n), np.float32)
    sos[30:66, 24:78] += rng.random((36, 54)).astype(np.float32)
    v = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    g = cfg.geometry
    op = make_operator(n, n, g.pml_size, g.sigma_max, cfg.k0, device=cuda)
    apply = make_learned_preconditioner(params, op, sos, cfg=cfg, iterations=iters,
                                        device=cuda)
    fused_double_conv.launches = 0
    got = apply(torch.from_numpy(v).to(cuda)).cpu()
    assert fused_double_conv.launches == 14 * iters
    plain = make_learned_preconditioner(params, op.to("cpu"), sos, cfg=cfg,
                                        iterations=iters, device="cpu")
    ref = plain(torch.from_numpy(v))
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max() <= TOL * ref.abs().max()


def test_k2a_inside_the_deflated_matvec(cuda):
    """On a StencilPML every matvec of `solve_helmholtz_deflated` is one K2a
    launch, bit-equal to the plain version on the same basis row; a solve
    launches K2a exactly once for each matvec it makes: one for the first
    residual, then a cycle's Arnoldi steps and its closing residual."""
    from helmnet_tpu_torch.ops import stencil_residual as sr
    from helmnet_tpu_torch.ops.stencil import make_stencil_operator
    from helmnet_tpu_torch.solvers.deflation import solve_helmholtz_deflated
    from helmnet_tpu_torch.solvers.gmres import make_helmholtz_matvec

    rng = np.random.default_rng(12)
    n = 64
    op = make_stencil_operator(n, n, 8, 2.0, 1.0, order=4, device=cuda)
    k_sq = torch.tensor(rng.uniform(0.25, 1.0, (n, n)).astype(np.float32), device=cuda)
    basis = torch.randn((3, n * n), dtype=torch.complex64, device=cuda)
    mv = make_helmholtz_matvec(op, k_sq)
    sr.reset_launches()
    got = mv(basis[1].reshape(1, n, n))[0]
    assert sr.residual_planes.launches == 1
    pair = torch.view_as_real(basis[1].reshape(n, n))
    ref = torch.complex(*sr.residual_planes_plain(op, pair[..., 0], pair[..., 1], k_sq))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)

    src = np.zeros((n, n, 2), np.float32)
    src[n - 12, n // 2, 0] = 10.0
    sr.reset_launches()
    res = solve_helmholtz_deflated(op, k_sq, src, restart=12, k=4, max_cycles=4,
                                   tol=0.0, device=cuda)
    cycles = len(res.residual_norms) - 1
    assert cycles == 4 and res.iterations == 12 + 3 * 8
    assert sr.residual_planes.launches == 1 + res.iterations + cycles
    assert sr.residual_planes_tiled.launches == sr.residual_planes_mxu.launches == 0

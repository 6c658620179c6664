"""The port's packed fused DoubleConv K3 (its plain version, as the wrapper
runs it on the CPU) against the JAX package's Pallas kernel
`pallas_unet.fused_double_conv` in interpret mode, at the shapes of
tests/test_pallas_unet.py; atol 2e-2 * max|ref| (test_pallas_unet.py:25-26).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.models.blocks import init_double_conv
from helmnet_tpu.models.packed import _pack_w as jax_pack_w
from helmnet_tpu.models.packed import _split_packed_rows as jax_split_rows
from helmnet_tpu.ops.pallas_unet import fused_double_conv as jax_fused
from helmnet_tpu_torch.models.blocks import hwio_to_torch_conv
from helmnet_tpu_torch.ops.double_conv import double_conv_plain
from helmnet_tpu_torch.ops.packed_double_conv import (
    CHUNK,
    MAX_WIDTH,
    TILES,
    cluster_size,
    ctas,
    packed_double_conv,
    padded_width,
    prepare,
    supported,
    tile_for,
    tiles_for,
)
from helmnet_tpu_torch.weights import from_jax_params

TOL = 2e-2


def _jax_params(cin, cout, act="prelu", seed=0, scale=50):
    p = init_double_conv(jax.random.PRNGKey(seed), cin, cout, act)
    return jax.tree.map(lambda t: np.asarray(t * scale if t.ndim == 4 else t), p)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL * np.abs(ref).max())


def _packed_jax(cin, cout, g, seed=0):
    """A DoubleConv lifted to block-diagonal g-packed weights (HWIO)."""
    p = _jax_params(cin, cout, seed=seed)
    return {
        "c1": {"w": np.asarray(jax_pack_w(jnp.asarray(p["c1"]["w"]), g)),
               "b": np.tile(p["c1"]["b"], g)},
        "act": p["act"],
        "c2": {"w": np.asarray(jax_pack_w(jnp.asarray(p["c2"]["w"]), g)),
               "b": np.tile(p["c2"]["b"], g)},
    }


def _split(jp, splits, g):
    """JAX and port params whose c1 weights are split per input part."""
    w1s = tuple(np.asarray(w) for w in
                jax_split_rows(jnp.asarray(jp["c1"]["w"]), splits, g))
    jfp = dict(jp, c1={"w": w1s, "b": jp["c1"]["b"]})
    tp = from_jax_params({k: v for k, v in jp.items()}, device="cpu")
    tp["c1"]["w"] = tuple(torch.from_numpy(hwio_to_torch_conv(w)) for w in w1s)
    return jfp, tp


@pytest.mark.parametrize("cin,cout,h,w", [(10, 8, 16, 16), (6, 8, 24, 16)])
def test_one_part_matches_pallas_kernel(cin, cout, h, w):
    jp = _jax_params(cin, cout)
    x = _x((2, h, w, cin))
    ref = jax_fused(jp, jnp.asarray(x), interpret=True)
    got = packed_double_conv(from_jax_params(jp, device="cpu"), torch.from_numpy(x))
    _close(got, ref)


def test_relu_without_slope():
    jp = _jax_params(6, 8, act="relu")
    assert jp["act"] == {}
    x = _x((1, 16, 16, 6))
    ref = jax_fused(jp, jnp.asarray(x), interpret=True)
    _close(packed_double_conv(from_jax_params(jp, device="cpu"),
                              torch.from_numpy(x)), ref)


def test_two_packed_parts_with_split_rows():
    """g = 4: the signal (8 channels a group) and the state (2) as separate
    packed parts, with the packed c1 rows split per part."""
    g = 4
    jfp, tp = _split(_packed_jax(10, 8, g), [8, 2], g)
    a, b = _x((2, 16, 16, 8 * g), 1), _x((2, 16, 16, 2 * g), 2)
    ref = jax_fused(jfp, (jnp.asarray(a), jnp.asarray(b)), interpret=True)
    got = packed_double_conv(tp, (torch.from_numpy(a), torch.from_numpy(b)))
    _close(got, ref)


def test_three_parts_the_inc_layout():
    """The `inc` call of a packed step: wavefield, 1e3*residual and sigma,
    each g*2 channels, g = 2."""
    g = 2
    jfp, tp = _split(_packed_jax(6, 8, g, seed=3), [2, 2, 2], g)
    xs = [_x((1, 16, 16, 2 * g), s) for s in (4, 5, 6)]
    ref = jax_fused(jfp, tuple(map(jnp.asarray, xs)), interpret=True)
    got = packed_double_conv(tp, tuple(map(torch.from_numpy, xs)))
    _close(got, ref)
    _close(packed_double_conv(prepare(tp), tuple(map(torch.from_numpy, xs))), ref)


def test_post_1x1_head():
    g = 2
    jfp, tp = _split(_packed_jax(16, 8, g, seed=7), [8, 8], g)
    rng = np.random.default_rng(3)
    post = {"w": rng.standard_normal((1, 1, 8 * g, 2 * g)).astype(np.float32) * 0.5,
            "b": rng.standard_normal(2 * g).astype(np.float32) * 0.1}
    jfp["post"] = post
    tp["post"] = {"w": torch.from_numpy(hwio_to_torch_conv(post["w"])),
                  "b": torch.from_numpy(post["b"])}
    a, b = _x((2, 16, 24, 8 * g), 8), _x((2, 16, 24, 8 * g), 9)
    ref = jax_fused(jfp, (jnp.asarray(a), jnp.asarray(b)), interpret=True)
    got = packed_double_conv(tp, (torch.from_numpy(a), torch.from_numpy(b)))
    assert got.shape == (2, 16, 24, 2 * g)
    _close(got, ref)


def test_wrapper_on_cpu_is_the_plain_version():
    tp = from_jax_params(_jax_params(10, 8), device="cpu")
    x = torch.from_numpy(_x((2, 16, 16, 10)))
    before = packed_double_conv.launches
    got = packed_double_conv(tp, x)
    assert packed_double_conv.launches == before  # no kernel launched
    torch.testing.assert_close(got, double_conv_plain(tp, x), rtol=0, atol=0)
    torch.testing.assert_close(packed_double_conv(prepare(tp), x), got,
                               rtol=0, atol=0)


def _unchunk(t: torch.Tensor) -> torch.Tensor:
    """The prepared [k, tap, n // 8, c // 8, n % 8, c % 8] layout back to
    [k, n, tap, c]."""
    k, taps, ng = t.shape[:3]
    return t.permute(0, 2, 4, 1, 3, 5).reshape(k, ng * 8, taps, CHUNK)


def test_prepared_layout():
    """The kernel reads w1 as [k, tap, n // 8, c // 8, n % 8, c % 8] =
    bf16(w1[n, 16k + c, tap // 3, tap % 3]), each tap's [n x 16] block in
    8 x 8 core matrices, zero-padded to the instance's widths, and w3 as
    [e, o]."""
    rng = np.random.default_rng(11)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    p = {"c1": {"w": (t(40, 20, 3, 3), t(40, 15, 3, 3)), "b": t(40)},
         "act": {"a": torch.tensor([0.25])},
         "c2": {"w": t(24, 40, 3, 3), "b": t(24)},
         "post": {"w": t(5, 24, 1, 1), "b": t(5)}}
    pw = prepare(p)
    assert (pw.cin, pw.cm, pw.co, pw.ce) == (35, 40, 24, 5)
    assert (pw.cmp, pw.cop, pw.cep) == (128, 32, 8)
    assert pw.w1.dtype == torch.bfloat16
    assert pw.w1.shape == (3, 9, 128 // 8, 2, 8, 8)
    assert pw.w2.shape == (128 // CHUNK, 9, 32 // 8, 2, 8, 8)
    assert pw.w3.shape == (8, 32)
    w1 = torch.cat(p["c1"]["w"], dim=1).to(torch.bfloat16)
    for k, n, tap, c in [(0, 0, 0, 0), (1, 39, 8, 3), (2, 7, 4, 2), (0, 3, 5, 15)]:
        assert pw.w1[k, tap, n // 8, c // 8, n % 8, c % 8] == \
            w1[n, CHUNK * k + c, tap // 3, tap % 3]
    u1 = _unchunk(pw.w1)
    assert not u1[2, :, :, 3:].any()   # channels 35..47: padding
    assert not u1[:, 40:].any()        # mid rows 40..127: padding
    w2 = p["c2"]["w"].to(torch.bfloat16)
    u2 = _unchunk(pw.w2)
    assert u2[2, 23, 7, 3] == w2[23, 2 * CHUNK + 3, 2, 1]
    assert pw.w2[2, 7, 23 // 8, 0, 23 % 8, 3] == w2[23, 2 * CHUNK + 3, 2, 1]
    assert not u2[:, 24:].any() and not u2[3:].any()
    assert pw.w3[4, 23] == p["post"]["w"][4, 23, 0, 0].to(torch.bfloat16)
    assert not pw.w3[5:].any() and not pw.w3[:, 24:].any()
    assert padded_width(1) == 32 and padded_width(33) == 128


def test_supported_bounds():
    assert supported(256, 256, (32, 32, 32), 128, 128)
    assert supported(256, 256, (128, 128), 128, 128, c_emit=32)
    assert supported(17, 33, (3, 5, 7), 10, 6, 5)
    assert supported(16, 16, 512, 128, 128)        # any input width
    assert supported(16, 16, (128, 128, 128), 512, 512, c_emit=128)  # g = 64
    assert supported(96, 96, 32, 129, 32)          # the wide instances
    assert not supported(96, 96, (8, 8, 8, 8), 8, 8)   # at most 3 parts
    assert not supported(96, 96, 32, 513, 32)
    assert not supported(96, 96, 32, 32, 513)
    assert not supported(96, 96, 32, 32, 32, c_emit=513)
    assert not supported(0, 96, 32, 32, 32)


def test_wrapper_rejects():
    """Shapes, dtypes and devices the kernel does not take raise on the
    CPU too, so a CPU run fails where the card's would."""
    tp = from_jax_params(_jax_params(8, 8), device="cpu")
    x = torch.from_numpy(_x((1, 8, 8, 8)))
    with pytest.raises(ValueError, match="unsupported"):
        packed_double_conv(tp, (x[..., :2],) * 4)
    with pytest.raises(ValueError, match="unsupported"):
        wide = from_jax_params(_jax_params(8, MAX_WIDTH + 1), device="cpu")
        packed_double_conv(wide, x)
    with pytest.raises(ValueError, match="tile"):
        packed_double_conv(tp, x, tile=(8, 8))  # a wide instance's tile
    with pytest.raises(ValueError, match="dtype"):
        packed_double_conv(tp, x.double())
    with pytest.raises(ValueError, match="slices"):
        split = dict(tp, c1={"w": (tp["c1"]["w"][:, :6], tp["c1"]["w"][:, 6:]),
                             "b": tp["c1"]["b"]})
        packed_double_conv(split, (x[..., :4], x[..., 4:]))
    with pytest.raises(ValueError, match="cuda or cpu"):
        packed_double_conv(tp, x.to("meta"))


# The JAX kernel's widths above 128 (g = 32 and g = 64 of the default
# model, 8 channels a problem): one part, or the `inc` layout's three
# parts of 2 channels a problem, with and without the fused head, at the
# levels where `fused_supported` finds a tiling for them.
WIDE_CASES = [
    # (g, per-group part widths, grid, head)
    (32, (8,), 16, False),
    (32, (2, 2, 2), 16, True),
    (32, (8, 8), 8, True),
    (64, (8,), 8, True),
    (64, (2, 2, 2), 16, False),
    (64, (2, 2, 2), 8, True),
]


@pytest.mark.parametrize("g,splits,n,head", WIDE_CASES)
def test_wide_matches_pallas_kernel(g, splits, n, head):
    jp = _packed_jax(sum(splits), 8, g, seed=g + n)
    if len(splits) > 1:
        jfp, tp = _split(jp, list(splits), g)
    else:
        jfp, tp = jp, from_jax_params(jp, device="cpu")
    if head:
        rng = np.random.default_rng(g)
        post = {"w": rng.standard_normal((1, 1, 8 * g, 2 * g)).astype(np.float32) * 0.1,
                "b": rng.standard_normal(2 * g).astype(np.float32) * 0.1}
        jfp = dict(jfp, post=post)
        tp["post"] = {"w": torch.from_numpy(hwio_to_torch_conv(post["w"])),
                      "b": torch.from_numpy(post["b"])}
    xs = [_x((1, n, n, c * g), 20 + i) for i, c in enumerate(splits)]
    ref = jax_fused(jfp, tuple(map(jnp.asarray, xs)), interpret=True)
    pw = prepare(tp)
    assert pw.wide and (pw.cmp, pw.cop) == (8 * g, 8 * g)
    got = packed_double_conv(pw, tuple(map(torch.from_numpy, xs)))
    assert got.shape == (1, n, n, (2 if head else 8) * g)
    _close(got, ref)


def test_wide_prepared_layout():
    """Above 128 rows the chunks come slice-major: chunk s * nck + k holds
    rows 128 s .. 128 s + 127 of input chunk k, in the 128-row layout; the
    widths are padded to multiples of 128 (a 32-wide side too)."""
    rng = np.random.default_rng(12)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    p = {"c1": {"w": t(300, 40, 3, 3), "b": t(300)},
         "act": {"a": torch.tensor([0.25])},
         "c2": {"w": t(20, 300, 3, 3), "b": t(20)},
         "post": {"w": t(130, 20, 1, 1), "b": t(130)}}
    pw = prepare(p)
    assert pw.wide and (pw.cmp, pw.cop, pw.cep) == (384, 128, 136)
    nck1, nck2 = 3, 384 // CHUNK
    assert pw.w1.shape == (3 * nck1, 9, 16, 2, 8, 8)
    assert pw.w2.shape == (1 * nck2, 9, 16, 2, 8, 8)
    assert pw.w3.shape == (136, 128)
    w1 = p["c1"]["w"].to(torch.bfloat16)
    for n, c, tap in [(0, 0, 0), (129, 17, 4), (299, 39, 8), (255, 33, 2)]:
        s_, k = n // 128, c // CHUNK
        nn, cc = n % 128, c % CHUNK
        assert pw.w1[s_ * nck1 + k, tap, nn // 8, cc // 8, nn % 8, cc % 8] == \
            w1[n, c, tap // 3, tap % 3]
    u1 = _unchunk(pw.w1)  # [s * nck + k, n % 128, tap, c]
    assert not u1[2 * nck1:, 300 - 256:].any()  # rows 300..383: padding
    assert not u1[nck1 - 1, :, :, 8:].any()      # channels 40..47: padding
    w2 = p["c2"]["w"].to(torch.bfloat16)
    assert pw.w2[17, 5, 19 // 8, 1, 19 % 8, 7] == w2[19, 17 * CHUNK + 15, 1, 2]
    assert padded_width(129, wide=True) == 256 and padded_width(32, wide=True) == 128


def test_tiles_of_each_instance():
    """The 128-wide instances take 8 x 16 and 4 x 8, one CTA a tile; the
    cluster instance takes 8 x 16, 8 x 8 and 4 x 8 at every width, with
    max(cmp, cop) / 128 CTAs a tile; `tile_for` picks the largest whose
    CTAs are at least half as many as the card has SMs."""
    assert tiles_for(128) == ((8, 16), (4, 8)) == tiles_for(32, ce=128)
    assert tiles_for(256, ce=64) == TILES == tiles_for(512, ce=128)
    assert tiles_for(256, ce=136) == TILES == tiles_for(128, ce=136)
    assert tiles_for(128, 256) == TILES  # out width 256: the cluster
    assert [cluster_size(*w) for w in [(128,), (32, 128, 128), (256,), (128, 384),
                                       (384, 256, 130), (512,), (128, 128, 136)]] \
        == [1, 1, 2, 3, 3, 4, 1]
    # (batch, grid, cmp, cop, ce) -> (tile, CTAs): g = 16, 32 and 64 at
    # 256^2 down to 16^2, batch 1, and a batch of 4
    table = {
        (1, 256, 128, 128, 0): ((8, 16), 512),
        (1, 128, 128, 128, 0): ((8, 16), 128),
        (1, 64, 128, 128, 0): ((4, 8), 128),
        (1, 256, 256, 256, 0): ((8, 16), 1024),
        (1, 128, 256, 256, 0): ((8, 16), 256),
        (1, 64, 256, 256, 0): ((8, 8), 128),
        (1, 32, 256, 256, 0): ((4, 8), 64),
        (1, 256, 256, 256, 64): ((8, 16), 1024),
        (1, 256, 512, 512, 0): ((8, 16), 2048),
        (1, 64, 512, 512, 0): ((8, 16), 128),
        (1, 32, 512, 512, 0): ((4, 8), 128),
        (1, 16, 512, 512, 0): ((4, 8), 32),
        (4, 32, 512, 512, 0): ((8, 16), 128),
    }
    for (b, n, cmp, cop, ce), (tile, count) in table.items():
        assert tile_for(b, n, n, cmp, cop, ce) == tile
        assert ctas(b, n, n, tile, cmp, cop, ce) == count
    assert ctas(2, 17, 33, (8, 16), 384, 256) == 2 * 3 * 3 * 3

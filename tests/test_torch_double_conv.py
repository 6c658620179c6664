"""The port's fused DoubleConv (plain version, as the wrapper runs it on
the CPU) against the JAX package's Pallas kernel `fused_double_conv_pix`
in interpret mode, at the shapes of tests/test_pallas_pixconv.py:20-27;
atol 2e-2 * max|ref| (test_pallas_pixconv.py:36).
"""

import jax
import numpy as np
import pytest
import torch

from helmnet_tpu.models.blocks import init_double_conv
from helmnet_tpu.ops.pallas_pixconv import fused_double_conv_pix
from helmnet_tpu_torch.models.blocks import hwio_to_torch_conv
from helmnet_tpu_torch.ops.double_conv import (
    double_conv_plain,
    fused_double_conv,
    supported,
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
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize(
    "cin,cout,h,w",
    [(6, 8, 16, 16), (10, 8, 32, 32), (16, 8, 24, 48), (8, 2, 16, 32)],
)
def test_matches_pallas_kernel(cin, cout, h, w):
    jp = _jax_params(cin, cout)
    x = _x((2, h, w, cin))
    ref = fused_double_conv_pix(jp, x, interpret=True)
    tp = from_jax_params(jp, device="cpu")
    _close(double_conv_plain(tp, torch.from_numpy(x)), ref)


def test_relu_empty_act_params():
    jp = _jax_params(6, 8, act="relu")
    assert jp["act"] == {}
    x = _x((1, 16, 16, 6))
    ref = fused_double_conv_pix(jp, x, interpret=True)
    _close(double_conv_plain(from_jax_params(jp, device="cpu"),
                             torch.from_numpy(x)), ref)


def test_multi_input_parts():
    jp = _jax_params(10, 8)
    a, b = _x((2, 32, 32, 8), 1), _x((2, 32, 32, 2), 2)
    w1 = jp["c1"]["w"]
    jfp = {"c1": {"w": (w1[:, :, :8], w1[:, :, 8:]), "b": jp["c1"]["b"]},
           "act": jp["act"], "c2": jp["c2"]}
    ref = fused_double_conv_pix(jfp, (a, b), interpret=True)
    tp = from_jax_params(jp, device="cpu")
    tw1 = torch.from_numpy(hwio_to_torch_conv(w1))
    split = dict(tp, c1={"w": (tw1[:, :8], tw1[:, 8:]), "b": tp["c1"]["b"]})
    parts = (torch.from_numpy(a), torch.from_numpy(b))
    _close(double_conv_plain(split, parts), ref)
    _close(double_conv_plain(tp, parts), ref)


def test_post_1x1_head():
    jp = _jax_params(16, 8)
    rng = np.random.default_rng(3)
    jp["post"] = {"w": rng.standard_normal((1, 1, 8, 2)).astype(np.float32) * 0.5,
                  "b": rng.standard_normal(2).astype(np.float32) * 0.1}
    x = _x((2, 32, 32, 16))
    ref = fused_double_conv_pix(jp, x, interpret=True)
    got = double_conv_plain(from_jax_params(jp, device="cpu"), torch.from_numpy(x))
    assert got.shape == (2, 32, 32, 2)
    _close(got, ref)


def test_wrapper_on_cpu_is_the_plain_version():
    tp = from_jax_params(_jax_params(10, 8), device="cpu")
    parts = (torch.from_numpy(_x((2, 16, 16, 8))), torch.from_numpy(_x((2, 16, 16, 2))))
    before = fused_double_conv.launches
    got = fused_double_conv(tp, parts)
    assert fused_double_conv.launches == before  # no kernel launched
    torch.testing.assert_close(got, double_conv_plain(tp, parts), rtol=0, atol=0)


def test_plain_rounds_like_the_kernel():
    """bf16 taps: the plain version differs from an f32 DoubleConv by about
    bf16's relative precision, no more."""
    from helmnet_tpu_torch.models.blocks import conv2d, double_conv

    tp = from_jax_params(_jax_params(16, 8), device="cpu")
    x = torch.from_numpy(_x((2, 16, 16, 16)))
    f32 = double_conv(tp, x, "prelu", "highest")
    got = double_conv_plain(tp, x)
    err = (got - f32).abs().max() / f32.abs().max()
    assert 1e-5 < err < TOL
    post = {"w": torch.ones(2, 8, 1, 1) * 0.1, "b": torch.zeros(2)}
    head = double_conv_plain(dict(tp, post=post), x)
    torch.testing.assert_close(head, conv2d(post, got), rtol=2e-2, atol=2e-2)


def test_supported_bounds():
    assert supported(96, 96, (8, 2), 8, 8)
    assert supported(96, 96, 16, 8, 8, c_emit=2)
    assert supported(6, 6, 8, 8, 8)      # no TPU lane-packing limit
    assert supported(17, 33, (3, 5), 3, 5)
    assert not supported(96, 96, 24, 8, 8)          # > 16 input channels
    assert not supported(96, 96, (2, 2, 2), 8, 8)   # at most two parts
    assert not supported(96, 96, 8, 17, 8)
    assert not supported(96, 96, 8, 8, 8, c_emit=20)


@pytest.mark.parametrize("cins, cout", [((24,), 8), ((2, 2, 2), 8), ((8,), 20)])
def test_wrapper_rejects_unsupported_shapes_on_cpu(cins, cout):
    """The wrapper refuses what the kernel does not take on every device,
    so a CPU run fails where the card's would."""
    tp = from_jax_params(_jax_params(sum(cins), cout), device="cpu")
    parts = tuple(torch.from_numpy(_x((1, 8, 8, c), seed=i)) for i, c in enumerate(cins))
    with pytest.raises(ValueError, match="unsupported"):
        fused_double_conv(tp, parts)


def _unfragment(t: torch.Tensor) -> torch.Tensor:
    """B fragments [n/8, k/8, 32, 2] back to the dense [k, n] matrix."""
    nt, kc = t.shape[:2]
    return (t.reshape(nt, kc, 8, 4, 2).permute(1, 3, 4, 0, 2)
            .reshape(kc * 8, nt * 8))


@pytest.mark.parametrize("cin,cm,co,ce,split", [
    (2, 2, 2, None, None), (6, 8, 8, None, None), (10, 8, 2, None, (8, 2)),
    (16, 8, 8, 2, (8, 8)), (16, 16, 16, 16, None), (3, 5, 7, 3, (1, 2)),
])
def test_prepared_layout(cin, cm, co, ce, split):
    """Unpacking the kernel's fragments gives back the bf16-rounded OIHW
    weights, zero in the padded widths (8 or 16), for whole and split c1
    weights; biases are f32, zero-padded."""
    from helmnet_tpu_torch.ops.double_conv import PreparedDoubleConv, prepare

    rng = np.random.default_rng(cin * 100 + cm * 10 + co)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    w1 = t(cm, cin, 3, 3)
    c1w = w1 if split is None else (w1[:, : split[0]], w1[:, split[0]:])
    p = {"c1": {"w": c1w, "b": t(cm)}, "act": {"a": torch.tensor([0.25])},
         "c2": {"w": t(co, cm, 3, 3), "b": t(co)}}
    if ce:
        p["post"] = {"w": t(ce, co, 1, 1), "b": t(ce)}
    pw = prepare(p)
    assert isinstance(pw, PreparedDoubleConv) and prepare(pw) is pw
    pad = lambda c: 8 if c <= 8 else 16
    cs, cmp, cop = pad(cin), pad(cm), pad(co)
    assert (pw.cs, pw.cmp, pw.cop, pw.cep) == (cs, cmp, cop, pad(ce) if ce else 0)
    assert pw.w1.dtype == pw.w2.dtype == torch.bfloat16
    assert pw.w1.shape == (cmp // 8, 9 * cs // 8, 32, 2)
    assert pw.w2.shape == (cop // 8, 9 * cmp // 8, 32, 2)
    # [k = tap * c_pad + c, n] -> OIHW
    d1 = _unfragment(pw.w1).reshape(9, cs, cmp).permute(2, 1, 0).reshape(cmp, cs, 3, 3)
    d2 = _unfragment(pw.w2).reshape(9, cmp, cop).permute(2, 1, 0).reshape(cop, cmp, 3, 3)
    torch.testing.assert_close(d1[:cm, :cin], w1.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(d2[:co, :cm], p["c2"]["w"].to(torch.bfloat16),
                               rtol=0, atol=0)
    assert not d1[cm:].any() and not d1[:, cin:].any()
    assert not d2[co:].any() and not d2[:, cm:].any()
    assert pw.b1.dtype == torch.float32 and pw.b1.shape == (cmp,)
    torch.testing.assert_close(pw.b1[:cm], p["c1"]["b"], rtol=0, atol=0)
    assert not pw.b1[cm:].any() and not pw.b2[co:].any()
    if ce:
        cep = pad(ce)
        assert pw.w3.shape == (cep // 8, cop // 8, 32, 2)
        d3 = _unfragment(pw.w3)  # [o, e]
        torch.testing.assert_close(d3[:co, :ce].t(),
                                   p["post"]["w"][:, :, 0, 0].to(torch.bfloat16),
                                   rtol=0, atol=0)
        assert not d3[co:].any() and not d3[:, ce:].any()
        assert pw.b3.shape == (cep,) and not pw.b3[ce:].any()
    else:
        assert pw.w3 is None and pw.b3 is None


def test_wrapper_takes_prepared_weights_on_cpu():
    """A `PreparedDoubleConv` gives the bits of its schema dict (the CPU
    runs the plain version on `params`), and a shape the kernel does not
    take raises when it is prepared."""
    from helmnet_tpu_torch.ops.double_conv import prepare

    tp = from_jax_params(_jax_params(10, 8), device="cpu")
    parts = (torch.from_numpy(_x((2, 16, 16, 8))), torch.from_numpy(_x((2, 16, 16, 2))))
    torch.testing.assert_close(fused_double_conv(prepare(tp), parts),
                               fused_double_conv(tp, parts), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported"):
        prepare(from_jax_params(_jax_params(18, 8), device="cpu"))


# the levels of the 96^2 x 32 model (experiments/base.json, depth 4) and of
# the 256^2, g = 16 packed model (batch 1)
K1_LEVELS = [(32, 96 >> d) for d in range(5)]
K3_LEVELS = [(1, 256 >> d) for d in range(5)]


def _blocks(b, h, w, tile):
    return b * -(-h // tile[0]) * -(-w // tile[1])


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_tile_choice_fills_blocks(kernel):
    """At every level the chosen output tile leaves at least half of each
    block's output pixels inside the image, and where the largest tile
    would give fewer blocks than half the card's SMs a smaller one is
    chosen."""
    from helmnet_tpu_torch.ops import double_conv as k1
    from helmnet_tpu_torch.ops import packed_double_conv as k3

    mod, levels = (k1, K1_LEVELS) if kernel == "K1" else (k3, K3_LEVELS)
    chosen = []
    for b, n in levels:
        tile = mod.tile_for(b, n, n)
        assert tile in mod.TILES
        live = n * n / (-(-n // tile[0]) * tile[0] * -(-n // tile[1]) * tile[1])
        assert live >= 0.5, (kernel, n, tile, live)
        if 2 * _blocks(b, n, n, mod.TILES[0]) < mod.SMS:
            assert tile != mod.TILES[0], (kernel, n)
        chosen.append(tile)
    assert chosen[0] == mod.TILES[0]  # the largest level: the large tile
    assert chosen[-1] == mod.TILES[-1]
    # ragged grids and batch 1 at 96^2 go to the small tile
    assert k1.tile_for(1, 96, 96) == k1.TILES[1]
    assert k1.tile_for(3, 40, 72) == k1.TILES[1]

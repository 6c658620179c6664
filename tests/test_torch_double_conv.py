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

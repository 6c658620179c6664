"""The port's conv blocks and activations against the JAX package's, on
the CPU, at precision 'highest' with the JAX params converted to the
port's layout; atol 1e-5 * max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.models import activations as jact
from helmnet_tpu.models import blocks as jb
from helmnet_tpu_torch.models import activations as tact
from helmnet_tpu_torch.models import blocks as tb

TOL = 1e-5


def _close(got, ref, rel=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, atol=rel * np.abs(ref).max())


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv_params(key, k, cin, cout, transposed=False):
    if transposed:
        jp = jb.init_conv_transpose(key, k, cin, cout)
        w = tb.hwio_to_torch_convtranspose(np.asarray(jp["w"]))
    else:
        jp = jb.init_conv(key, k, cin, cout, gain=1.0)
        w = tb.hwio_to_torch_conv(np.asarray(jp["w"]))
    return jp, {"w": _t(w), "b": _t(jp["b"])}


@pytest.mark.parametrize(
    "k,stride,padding,cin,cout,n",
    [(3, 1, 1, 6, 8, 16), (8, 2, 3, 8, 8, 16), (1, 1, 0, 8, 2, 12),
     (3, 1, 1, 16, 8, 12)],
)
def test_conv2d(k, stride, padding, cin, cout, n):
    jp, tp = _conv_params(jax.random.PRNGKey(0), k, cin, cout)
    x = _x((2, n, n, cin))
    ref = jb.conv2d(jp, x, stride=stride, padding=padding, precision="highest")
    got = tb.conv2d(tp, _t(x), stride=stride, padding=padding, precision="highest")
    _close(got.numpy(), ref)


@pytest.mark.parametrize("form", ["dilated", "subpixel"])
@pytest.mark.parametrize("n", [3, 6, 8])
def test_conv_transpose2d(form, n):
    jp, tp = _conv_params(jax.random.PRNGKey(1), 8, 8, 8, transposed=True)
    x = _x((2, n, n, 8), seed=n)
    jfn = jb.conv_transpose2d if form == "dilated" else jb.conv_transpose2d_subpixel
    tfn = tb.conv_transpose2d if form == "dilated" else tb.conv_transpose2d_subpixel
    ref = jfn(jp, x, stride=2, padding=3, precision="highest")
    got = tfn(tp, _t(x), stride=2, padding=3, precision="highest")
    assert got.shape == (2, 2 * n, 2 * n, 8) and got.is_contiguous()
    _close(got.numpy(), ref)


def test_subpixel_equals_dilated():
    _, tp = _conv_params(jax.random.PRNGKey(2), 8, 8, 4, transposed=True)
    x = _t(_x((1, 5, 7, 8)))
    _close(tb.conv_transpose2d_subpixel(tp, x).numpy(),
           tb.conv_transpose2d(tp, x).numpy())


@pytest.mark.parametrize("activation", ["prelu", "relu", "gelu", "celu"])
def test_double_conv(activation):
    jp = jb.init_double_conv(jax.random.PRNGKey(3), 10, 8, activation)
    jp = jax.tree.map(lambda t: t * 20 if t.ndim == 4 else t, jp)
    tp = {
        "c1": {"w": _t(tb.hwio_to_torch_conv(np.asarray(jp["c1"]["w"]))),
               "b": _t(jp["c1"]["b"])},
        "act": {k: _t(v) for k, v in jp["act"].items()},
        "c2": {"w": _t(tb.hwio_to_torch_conv(np.asarray(jp["c2"]["w"]))),
               "b": _t(jp["c2"]["b"])},
    }
    x = _x((2, 16, 16, 10))
    ref = jb.double_conv(jp, x, activation, "highest")
    got = tb.double_conv(tp, _t(x), activation, "highest")
    _close(got.numpy(), ref)


@pytest.mark.parametrize(
    "name",
    ["relu", "celu", "tanh", "gelu", "tanhshrink", "softplus", "leakyrelu",
     "prelu", "relu_batchnorm"],
)
def test_activations(name):
    x = _x((4, 64), seed=5) * 4
    jinit, japply = jact.get_activation(name)
    tinit, tapply = tact.get_activation(name)
    jp = jinit(jax.random.PRNGKey(0))
    tp = tinit(torch.Generator().manual_seed(0))
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    np.testing.assert_allclose(tapply(tp, _t(x)).numpy(),
                               np.asarray(japply(jp, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_unknown_activation_and_precision():
    with pytest.raises(NotImplementedError):
        tact.get_activation("swish")
    with pytest.raises(ValueError, match="precision"):
        tb.resolve_precision("bf16")


def test_layout_converters_round_trip():
    w = _x((8, 6, 3, 3))
    np.testing.assert_array_equal(tb.hwio_to_torch_conv(tb.torch_conv_to_hwio(w)), w)
    np.testing.assert_array_equal(tb.torch_conv_to_hwio(w),
                                  jb.torch_conv_to_hwio(w))
    wt = _x((8, 4, 8, 8))
    np.testing.assert_array_equal(
        tb.hwio_to_torch_convtranspose(tb.torch_convtranspose_to_hwio(wt)), wt)
    np.testing.assert_array_equal(tb.torch_convtranspose_to_hwio(wt),
                                  jb.torch_convtranspose_to_hwio(wt))


def test_init_shapes_follow_torch_layout():
    g = torch.Generator().manual_seed(0)
    c = tb.init_conv(g, 3, 6, 8)
    t = tb.init_conv_transpose(g, 8, 8, 4)
    assert c["w"].shape == (8, 6, 3, 3) and c["b"].shape == (8,)
    assert t["w"].shape == (8, 4, 8, 8) and t["b"].shape == (4,)

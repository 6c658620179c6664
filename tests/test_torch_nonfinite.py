"""A NaN in a DoubleConv's input: where the port's K1 and K3 entry points
(their plain versions, as the wrappers run them on the CPU) put NaNs in
their output, against the JAX package's Pallas kernels in interpret mode
(as tests/test_torch_double_conv.py and
tests/test_torch_packed_double_conv.py run them). Both packages compute
PReLU as max(h, 0) + slope * min(h, 0), which keeps a NaN (ReLU too, at
slope 0); the card's kernels are held to these same masks by
tests/test_torch_kernels_gpu.py and chip_smoke.py.

- K1: the port's mask is the NaN's 5 x 5 receptive field (two 3 x 3
  convs), over every output channel, in the planted sample. JAX's
  `fused_double_conv_pix` packs 16 pixels of a row into its lanes and
  takes each conv as a banded matrix over whole packed rows; the band's
  zero taps multiply the NaN too (NaN * 0 = NaN), so its mask covers whole
  rows of the receptive field: wider, never narrower. Finite entries
  agree within atol 2e-2 * max|ref| (test_pallas_pixconv.py:36).
- K3: `pallas_unet.fused_double_conv` shifts whole planes and keeps the
  receptive field: the masks are equal. With g-packed block-diagonal
  weights a NaN in one problem's channel meets the other problems' zero
  blocks, so it reaches every problem of its pack at the same pixels, in
  both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.ops.pallas_pixconv import fused_double_conv_pix
from helmnet_tpu.ops.pallas_unet import fused_double_conv as jax_fused
from helmnet_tpu_torch.ops.double_conv import fused_double_conv
from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv
from helmnet_tpu_torch.weights import from_jax_params

from tests.test_torch_double_conv import _jax_params, _x
from tests.test_torch_packed_double_conv import _packed_jax, _split

TOL = 2e-2


def _planted(shapes, at, seed=1):
    """Seeded input parts, NaN at `at` = (part, sample, y, x, channel)."""
    xs = [_x(s, seed + i) for i, s in enumerate(shapes)]
    part, *where = at
    xs[part][tuple(where)] = np.nan
    return xs


def _field(shape, at) -> np.ndarray:
    """The NaN mask of a DoubleConv output `shape` [B, H, W, C] for a NaN at
    (sample, y, x): the 5 x 5 receptive field, every channel."""
    b, y, x = at
    mask = np.zeros(shape, dtype=bool)
    mask[b, max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = True
    return mask


def _agree_where_finite(got, ref):
    """The port's and JAX's outputs agree on the entries finite in both."""
    got, ref = np.asarray(got), np.asarray(ref)
    both = np.isfinite(got) & np.isfinite(ref)
    assert both.any()
    np.testing.assert_allclose(got[both], ref[both],
                               atol=TOL * np.abs(ref[both]).max())


@pytest.mark.parametrize(
    "act,cins,head,at",
    [
        ("prelu", (6,), False, (0, 1, 7, 9, 0)),
        ("relu", (6,), False, (0, 1, 7, 9, 0)),      # ReLU: slope 0, NaN kept
        ("prelu", (8, 2), True, (1, 0, 0, 31, 1)),  # the state part, a corner, the head
    ],
)
def test_k1_nan_mask(act, cins, head, at):
    jp = _jax_params(sum(cins), 8, act=act)
    if head:
        rng = np.random.default_rng(3)
        jp["post"] = {"w": rng.standard_normal((1, 1, 8, 2)).astype(np.float32) * 0.5,
                      "b": rng.standard_normal(2).astype(np.float32) * 0.1}
    xs = _planted([(2, 32, 32, c) for c in cins], at)
    if len(cins) == 1:
        jfp, jx = jp, xs[0]
    else:
        w1 = jp["c1"]["w"]
        jfp = dict(jp, c1={"w": (w1[:, :, :cins[0]], w1[:, :, cins[0]:]),
                           "b": jp["c1"]["b"]})
        jx = tuple(xs)
    ref = np.asarray(fused_double_conv_pix(jfp, jx, interpret=True))
    got = fused_double_conv(from_jax_params(jp, device="cpu"),
                            tuple(map(torch.from_numpy, xs))).numpy()
    b, y, x = at[1:4]
    field = _field(got.shape, (b, y, x))
    np.testing.assert_array_equal(np.isnan(got), field)
    jax_nan = np.isnan(ref)
    assert (jax_nan >= field).all()  # JAX's mask holds the port's
    band = np.zeros_like(jax_nan)
    band[b, max(y - 2, 0):y + 3] = True  # the receptive field's rows, whole
    assert (jax_nan <= band).all()
    _agree_where_finite(got, ref)


@pytest.mark.parametrize(
    "act,cins,at",
    [
        ("prelu", (6,), (0, 1, 7, 9, 0)),
        ("relu", (6,), (0, 1, 7, 9, 0)),
        ("prelu", (8, 2), (1, 0, 31, 0, 1)),  # the second part, an edge
    ],
)
def test_k3_nan_mask_equals_jax(act, cins, at):
    jp = _jax_params(sum(cins), 8, act=act)
    xs = _planted([(2, 32, 32, c) for c in cins], at)
    tp = from_jax_params(jp, device="cpu")
    if len(cins) > 1:
        w1 = jp["c1"]["w"]
        jp = dict(jp, c1={"w": (w1[:, :, :cins[0]], w1[:, :, cins[0]:]),
                          "b": jp["c1"]["b"]})
    ref = np.asarray(jax_fused(jp, tuple(map(jnp.asarray, xs)), interpret=True))
    got = packed_double_conv(tp, tuple(map(torch.from_numpy, xs))).numpy()
    field = _field(got.shape, at[1:4])
    np.testing.assert_array_equal(np.isnan(got), field)
    np.testing.assert_array_equal(np.isnan(ref), field)
    _agree_where_finite(got, ref)


def test_k3_nan_in_one_problem_poisons_its_pack():
    """g = 2, block-diagonal weights, the inc layout (three parts of g * 2
    channels): a NaN in problem 0's channel of the second part makes both
    problems' outputs NaN at the receptive field, in both packages."""
    g = 2
    jfp, tp = _split(_packed_jax(6, 8, g, seed=3), [2, 2, 2], g)
    at = (1, 1, 12, 20, 1)  # channel 1 of part 1: problem 0
    xs = _planted([(2, 32, 32, 2 * g)] * 3, at, seed=4)
    ref = np.asarray(jax_fused(jfp, tuple(map(jnp.asarray, xs)), interpret=True))
    got = packed_double_conv(tp, tuple(map(torch.from_numpy, xs))).numpy()
    field = _field(got.shape, at[1:4])
    np.testing.assert_array_equal(np.isnan(got), field)
    np.testing.assert_array_equal(np.isnan(ref), field)
    for out in (got, ref):  # problem 1 (channels 8..15) as problem 0
        np.testing.assert_array_equal(np.isnan(out[..., 8:]), np.isnan(out[..., :8]))
    _agree_where_finite(got, ref)

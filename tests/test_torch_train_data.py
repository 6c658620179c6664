"""The training slice's data side: the port's source maps, ellipse
generator, native row mover and replay buffer against the JAX package's,
on the CPU.

- `line_source_map` within atol 1e-6 of JAX's (tests/test_training.py:181);
- `point_sources_on_device` within 3e-6 * amplitude of JAX's and of
  `point_source_map` (tests/test_device_buffer.py:30,106);
- `make_dataset(seed)`, `_polylines_numpy` and the replay buffer's draws
  equal to JAX's; the native `gather_rows` / `scatter_rows` equal to
  numpy indexing.
"""

import numpy as np
import pytest
import torch

from helmnet_tpu.core import native as jnative
from helmnet_tpu.data import ellipses as jell
from helmnet_tpu.ops import source as jsrc
from helmnet_tpu.train import replay as jreplay
from helmnet_tpu_torch.core import native as tnative
from helmnet_tpu_torch.data import ellipses as tell
from helmnet_tpu_torch.ops import source as tsrc
from helmnet_tpu_torch.train import replay as treplay


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("ends", [((8, 6), (8, 25)), ((3, 4), (28, 30)),
                                  ((8, 6), (8, 6))])
def test_line_source_map(ends, smooth):
    args = (32, 40, *ends, 10.0, 0.25, 2.0, 0.0, smooth)
    got = tsrc.line_source_map(*args)
    assert got.shape == (32, 40, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, jsrc.line_source_map(*args), atol=1e-6)
    np.testing.assert_array_equal(tsrc.line_source_amplitude(32, 40, *ends, 10.0, smooth),
                                  jsrc.line_source_amplitude(32, 40, *ends, 10.0, smooth))


def test_line_source_rejects_outside_endpoints():
    with pytest.raises(ValueError, match="outside"):
        tsrc.line_source_map(32, 32, (0, 0), (32, 5))


@pytest.mark.parametrize("smooth", [True, False])
def test_point_sources_on_device(smooth):
    ky, kx = tsrc.point_source_kernels(40, 56, smooth)
    jky, jkx = jsrc.point_source_kernels(40, 56, smooth)
    np.testing.assert_array_equal(ky, jky)
    np.testing.assert_array_equal(kx, jkx)
    locs = [(0, 0), (17, 33), (39, 55)]
    got = tsrc.point_sources_on_device(torch.as_tensor(ky), torch.as_tensor(kx),
                                       torch.tensor(locs, dtype=torch.int32),
                                       10.0, 0.25, 2.0, 0.0)
    assert got.shape == (3, 40, 56, 2) and got.dtype == torch.float32
    ref = np.asarray(jsrc.point_sources_on_device(jky, jkx, np.asarray(locs, np.int32),
                                                  10.0, 0.25, 2.0, 0.0))
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-6 * 10.0)
    for i, loc in enumerate(locs):
        one = tsrc.point_source_map(40, 56, loc, 10.0, 0.25, 2.0, 0.0, smooth)
        np.testing.assert_allclose(got[i].numpy(), one, atol=3e-6 * np.abs(one).max())


def test_source_batch_from_locations():
    locs = [(5, 7), (20, 11)]
    got = tsrc.source_batch_from_locations(32, 32, locs, 10.0, 0.5, 1.0, True)
    ref = jsrc.source_batch_from_locations(32, 32, locs, 10.0, 0.5, 1.0, True)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("imsize,seed", [(32, 0), (96, 3)])
def test_make_dataset_equals_jax(imsize, seed):
    got = tell.make_dataset(6, imsize, seed=seed)
    assert got.shape == (6, imsize, imsize) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jell.make_dataset(6, imsize, seed=seed))


def test_make_dataset_without_cv2_equals_jax(monkeypatch):
    """The card's machine has no cv2: both packages then take
    `_polylines_numpy`, and agree."""
    monkeypatch.setattr(tell, "cv2", None)
    monkeypatch.setattr(jell, "cv2", None)
    got = tell.make_dataset(4, 48, seed=5)
    np.testing.assert_array_equal(got, jell.make_dataset(4, 48, seed=5))
    assert np.all(got >= 1.0) and np.all(got <= 2.0 + 1e-6)


@pytest.mark.parametrize("thickness", [1, 4, 9])
def test_polylines_numpy_equals_jax(thickness):
    rng = np.random.default_rng(thickness)
    pts = rng.integers(-4, 44, size=(30, 2)).astype(np.int32)
    got = np.zeros((40, 40), np.uint8)
    ref = np.zeros((40, 40), np.uint8)
    tell._polylines_numpy(got, pts, thickness)
    jell._polylines_numpy(ref, pts, thickness)
    assert got.any()
    np.testing.assert_array_equal(got, ref)


def test_split_and_get_dataset(tmp_path):
    maps = tell.make_dataset(20, 32, seed=1)
    out = tell.split_and_save(maps, str(tmp_path / "port"), splits=(12, 4, 4))
    ref = jell.split_and_save(maps, str(tmp_path / "jax"), splits=(12, 4, 4))
    for name in ("trainset", "validation", "testset"):
        np.testing.assert_array_equal(tell.get_dataset(out[name]),
                                      jell.get_dataset(ref[name]))
    assert tell.get_dataset(out["trainset"]).shape == (12, 32, 32)
    with pytest.raises(ValueError, match="splits"):
        tell.split_and_save(maps, str(tmp_path / "x"), splits=(20, 1, 0))


def test_native_rows_equal_numpy():
    if not tnative.available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(0)
    src = rng.standard_normal((50, 7, 3)).astype(np.float32)
    idx = rng.permutation(50)[:20]
    got = tnative.gather_rows(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    dst = np.zeros_like(src)
    tnative.scatter_rows(dst, got, idx)
    ref = np.zeros_like(src)
    ref[idx] = src[idx]
    np.testing.assert_array_equal(dst, ref)
    with pytest.raises(IndexError):
        tnative.gather_rows(src, np.array([0, 50]))
    np.testing.assert_array_equal(tnative.generate_ellipses(4, 32, seed=7),
                                  jnative.generate_ellipses(4, 32, seed=7))


def test_native_fallback_without_library(monkeypatch):
    monkeypatch.setattr(tnative, "load", lambda: None)
    src = np.arange(24, dtype=np.float32).reshape(6, 4)
    idx = np.array([4, 1])
    np.testing.assert_array_equal(tnative.gather_rows(src, idx), src[idx])
    dst = np.zeros_like(src)
    tnative.scatter_rows(dst, src[idx], idx)
    np.testing.assert_array_equal(dst[idx], src[idx])
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.generate_ellipses(2, 16)


def test_replay_buffer_draws_equal_jax():
    """Same seed, same slots; writes land in the sampled slots."""
    args = (12, 16, 16, 2, 340)
    tb, jb = treplay.ReplayBuffer(*args), jreplay.ReplayBuffer(*args)
    rng = np.random.default_rng(1)
    wf = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    st = rng.standard_normal((2, 2, 340)).astype(np.float32)
    k = np.ones((2, 16, 16), np.float32)
    for b in (tb, jb):
        b.append_batch(np.array([3, 5]), wf, st, k, wf, wf, np.array([7, 9]))
        b.append(8, wf[1], st[1], k[1], wf[1], wf[1], 42)
    for _ in range(3):
        got, ref = tb.sample(5), jb.sample(5)
        for name, a, r in zip(got._fields, got, ref):
            np.testing.assert_array_equal(a, r, err_msg=name)
    full = tb.sample(12)
    assert sorted(full.indices.tolist()) == list(range(12))
    pos = list(full.indices).index(8)
    assert full.iteration[pos] == 42
    np.testing.assert_array_equal(full.wavefield[pos], wf[1])

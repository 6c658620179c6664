"""The port's channel-packed network and rollout (models/packed.py)
against the JAX package's, on the CPU, with the trained weights of
trained_models/round1_best_epoch890.npz at 32^2:

- `pack_params` and `_split_packed_rows`: exactly, leaf by leaf;
- `apply_packed`: 'xla'/'highest' at atol 1e-4 * max|ref|, 'pallas' at
  atol 2e-2 * max|ref| (test_pallas_unet.py:25-26; the JAX side runs K3
  in interpret mode, the port its plain version);
- `rollout_packed`: 'xla'/'highest' at rtol 1e-3 (the unpacked port tests'
  tolerance), 'pallas' on the rmse at rtol 0.05 (test_pallas_unet.py:116);
- the port's packed rollout against its own unpacked one at precision
  'highest': rmse rtol 1e-5, atol 1e-7; wavefield rtol 1e-4, atol 1e-6
  (tests/test_packed.py:92-97), and the residual within 1e-4 of its
  largest value.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.core import config as jconf
from helmnet_tpu.models import packed as jp
from helmnet_tpu.solvers import iterative as jit_
from helmnet_tpu_torch.core import config as tconf
from helmnet_tpu_torch.models import packed as tp
from helmnet_tpu_torch.models.blocks import hwio_to_torch_conv
from helmnet_tpu_torch.models.hybridnet import iter_leaves
from helmnet_tpu_torch.ops.packed_double_conv import PackedWeights
from helmnet_tpu_torch.ops.spectral import make_operator
from helmnet_tpu_torch.solvers import iterative as tit
from helmnet_tpu_torch.weights import from_jax_params, load_params_npz
from tests.test_torch_iterative import NPZ, _config, _jax_params

N = 32


def jax_tree_asarray(tree):
    import jax

    return jax.tree.map(jnp.asarray, tree)


def _solvers(**model_kw):
    jcfg, tcfg = _config(jconf, **model_kw), _config(tconf, **model_kw)
    js = jit_.IterativeSolver(jcfg, params=_jax_params(jcfg))
    ts = tit.IterativeSolver(tcfg, params=load_params_npz(NPZ, tcfg, device="cpu"),
                             device="cpu")
    return js, ts


def _sos(b, seed=0):
    rng = np.random.default_rng(seed)
    sos = np.ones((b, N, N), np.float32)
    sos[:, 10:20, 8:22] = 1.0 + rng.random((b, 10, 14)).astype(np.float32)
    return sos


def _src(js, b):
    return np.ascontiguousarray(np.broadcast_to(np.asarray(js.source), (b, N, N, 2)))


def test_pack_unpack_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 16, 16, 6)).astype(np.float32))
    y = tp.unpack_batch(tp.pack_batch(x, 4), 4)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    ref = np.asarray(jp.pack_batch(jnp.asarray(x.numpy()), 4))
    np.testing.assert_array_equal(tp.pack_batch(x, 4).numpy(), ref)


@pytest.mark.parametrize("g", [2, 4])
def test_pack_params_matches_jax(g):
    js, ts = _solvers()
    ref = from_jax_params(
        jax_tree_to_numpy(jp.pack_params(js.params, g)), device="cpu")
    got = tp.pack_params(ts.params, g)
    ref_leaves, got_leaves = dict(iter_leaves(ref)), dict(iter_leaves(got))
    assert list(ref_leaves) == list(got_leaves)
    for path, r in ref_leaves.items():
        torch.testing.assert_close(got_leaves[path], r, rtol=0, atol=0, msg=path)
    assert got["up"][0]["w"].shape == (8 * g, 8 * g, 8, 8)
    # off-diagonal blocks are exactly zero
    assert not got["inc"]["c1"]["w"][:8, 6:].any()


def test_split_packed_rows_matches_jax():
    g = 4
    js, ts = _solvers()
    jw = jp.pack_params(js.params, g)["enc"][0]["conv_signal"]["c1"]["w"]
    tw = tp.pack_params(ts.params, g)["enc"][0]["conv_signal"]["c1"]["w"]
    ref = jp._split_packed_rows(jw, [8, 2], g)
    got = tp._split_packed_rows(tw, [8, 2], g)
    assert [t.shape for t in got] == [(8 * g, 8 * g, 3, 3), (8 * g, 2 * g, 3, 3)]
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t.numpy(), hwio_to_torch_conv(np.asarray(r)))


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.mark.parametrize("mode,rel", [("xla", 1e-4), ("pallas", 2e-2)])
def test_apply_packed_matches_jax(mode, rel):
    g = 2
    kw = (dict(precision="highest") if mode == "xla"
          else dict(precision="default", double_conv_mode="pallas"))
    js, ts = _solvers(**kw)
    rng = np.random.default_rng(5)
    parts = [rng.standard_normal((2, N, N, 2 * g)).astype(np.float32)
             for _ in range(3)]
    states = [rng.standard_normal((2, N >> d, N >> d, 2 * g)).astype(np.float32)
              for d in range(4)]
    ref, ref_states = jp.apply_packed(
        jp.pack_params(js.params, g), tuple(map(jnp.asarray, parts)),
        tuple(map(jnp.asarray, states)), cfg=js.cfg.model, g=g)
    packed = tp.pack_params(ts.params, g)
    for params in (packed, tp.prepare_k3(packed, ts.cfg.model, g, (2, 2, 2))):
        got, got_states = tp.apply_packed(
            params, tuple(map(torch.from_numpy, parts)),
            tuple(map(torch.from_numpy, states)), cfg=ts.cfg.model, g=g)
        for a, b in zip((got, *got_states), (ref, *ref_states)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, atol=rel * np.abs(b).max())


def test_rollout_packed_xla_matches_jax():
    js, ts = _solvers(precision="highest")
    sos, src = _sos(4), _src(js, 4)
    kw = dict(g=2, num_iterations=6, collect=("rmse", "best"))
    ref = jp.rollout_packed(js.params, js.op, jnp.asarray(src), jnp.asarray(sos),
                            cfg=js.cfg, **kw)
    got = tp.rollout_packed(ts.params, ts.op, src, sos, cfg=ts.cfg, device="cpu",
                            **kw)
    assert got["rmse"].shape == (6, 4)
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(ref["rmse"]), rtol=1e-3)
    np.testing.assert_allclose(got["best_rmse"].numpy(), np.asarray(ref["best_rmse"]),
                               rtol=1e-3)
    for key in ("wavefield", "residual", "best_wavefield"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), r, atol=1e-3 * np.abs(r).max())


def test_rollout_packed_pallas_matches_jax():
    js, ts = _solvers(precision="default", double_conv_mode="pallas")
    sos, src = _sos(4, seed=1), _src(js, 4)
    kw = dict(g=2, num_iterations=4, collect=("rmse",))
    ref = jp.rollout_packed(js.params, js.op, jnp.asarray(src), jnp.asarray(sos),
                            cfg=js.cfg, **kw)
    got = tp.rollout_packed(ts.params, ts.op, src, sos, cfg=ts.cfg, device="cpu",
                            **kw)
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(ref["rmse"]),
                               rtol=0.05, atol=1e-8)


@pytest.mark.parametrize("g", [2, 4])
def test_rollout_packed_matches_unpacked(g):
    _, ts = _solvers(precision="highest")
    sos = _sos(8, seed=2)
    src = ts.source.expand(8, -1, -1, -1)
    kw = dict(cfg=ts.cfg, num_iterations=6, collect=("rmse", "best"), device="cpu")
    ref = tit.rollout(ts.params, ts.op, src, sos, **kw)
    got = tp.rollout_packed(ts.params, ts.op, src, sos, g=g, **kw)
    torch.testing.assert_close(got["rmse"], ref["rmse"], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got["best_rmse"], ref["best_rmse"], rtol=1e-5, atol=1e-7)
    for key in ("wavefield", "best_wavefield"):
        torch.testing.assert_close(got[key], ref[key], rtol=1e-4, atol=1e-6)
    # the residual is L u, whose derivatives amplify the wavefield's
    # last-bit differences; held at 1e-4 of its own scale
    r = ref["residual"]
    torch.testing.assert_close(got["residual"], r, rtol=0,
                               atol=1e-4 * r.abs().max().item())


def test_rollout_packed_raises():
    _, ts = _solvers()
    src = ts.source.expand(3, -1, -1, -1)
    with pytest.raises(ValueError, match="divisible"):
        tp.rollout_packed(ts.params, ts.op, src, _sos(3), cfg=ts.cfg, g=2,
                          num_iterations=1, device="cpu")
    fft = ts.cfg.replace(operator_mode="fft")
    with pytest.raises(ValueError, match="matmul"):
        tp.rollout_packed(ts.params, ts.op, src[:2], _sos(2), cfg=fft, g=2,
                          num_iterations=1, device="cpu")
    with pytest.raises(ValueError, match="collects"):
        tp.rollout_packed(ts.params, ts.op, src[:2], _sos(2), cfg=ts.cfg, g=2,
                          num_iterations=1, collect=("wavefields",), device="cpu")


def test_rollout_packed_refuses_k3_widths_before_converting(monkeypatch):
    """At g=128 the default model's mid and out widths are 1024, above
    K3's 512 (the widest at which the JAX kernel runs), but for the four
    conv_state DoubleConvs (widths 256). 'pallas' mode sends each to K3 or
    to cuDNN by its shape, before any K3 weight is converted, as JAX's
    goes to XLA where `fused_supported` fails: only the conv_state weights
    are converted, only they reach K3 (4 calls a step), and the rmse is
    the 'xla' mode's within the 'pallas' gate (rtol 0.05). K3's wrapper
    itself still refuses the width."""
    _, ts = _solvers(double_conv_mode="pallas", precision="default")
    converted, launched = [], []
    real_prepare, real_k3 = tp.prepare, tp.packed_double_conv
    monkeypatch.setattr(tp, "prepare",
                        lambda p: converted.append(p) or real_prepare(p))
    monkeypatch.setattr(tp, "packed_double_conv",
                        lambda p, x: launched.append(p) or real_k3(p, x))
    g = 128
    src = ts.source.expand(g, -1, -1, -1)
    out = tp.rollout_packed(ts.params, ts.op, src, _sos(g), cfg=ts.cfg, g=g,
                            num_iterations=1, device="cpu")
    assert len(converted) == 4 and len(launched) == 4
    assert all(int(p["c2"]["w"].shape[0]) == 2 * g for p in converted)
    xla = ts.cfg.replace(model=dataclasses.replace(ts.cfg.model,
                                                   double_conv_mode="xla"))
    ref = tp.rollout_packed(ts.params, ts.op, src, _sos(g), cfg=xla, g=g,
                            num_iterations=1, device="cpu")
    np.testing.assert_allclose(out["rmse"].numpy(), ref["rmse"].numpy(), rtol=0.05)
    from helmnet_tpu_torch.ops import packed_double_conv as pdc

    wide = {"c1": {"w": (torch.zeros(8 * g, 6 * g, 3, 3),), "b": torch.zeros(8 * g)},
            "act": {}, "c2": {"w": torch.zeros(8 * g, 8 * g, 3, 3), "b": torch.zeros(8 * g)}}
    with pytest.raises(ValueError, match="unsupported"):
        pdc.packed_double_conv(wide, (torch.zeros(1, 4, 4, 6 * g),))


def test_apply_packed_above_width_512_matches_jax():
    """One packed apply at g=65 (widths 520, above K3's 512) in 'pallas'
    mode, the smallest that reaches it: the default widths at depth 1 on
    a 4^2 grid. JAX's `fused_supported` takes none of its DoubleConvs (XLA
    convs), K3 none (cuDNN's convs, the CPU's here); 'xla' mode's
    tolerance, 1e-4 * max|ref|."""
    from tests.test_torch_hybridnet import jax_layout_params

    g, n = 65, 4
    kw = dict(depth=1, state_depth=1, precision="default", double_conv_mode="pallas")
    jm, tm = jconf.ModelConfig(**kw), tconf.ModelConfig(**kw)
    jparams = jax_layout_params(tm)
    rng = np.random.default_rng(5)
    parts = [rng.standard_normal((1, n, n, 2 * g)).astype(np.float32) for _ in range(3)]
    states = [rng.standard_normal((1, n, n, 2 * g)).astype(np.float32)]
    ref, ref_states = jp.apply_packed(
        jp.pack_params(jax_tree_asarray(jparams), g), tuple(map(jnp.asarray, parts)),
        tuple(map(jnp.asarray, states)), cfg=jm, g=g)
    packed = tp.pack_params(from_jax_params(jparams, device="cpu"), g)
    got, got_states = tp.apply_packed(
        tp.prepare_k3(packed, tm, g, (2, 2, 2)), tuple(map(torch.from_numpy, parts)),
        tuple(map(torch.from_numpy, states)), cfg=tm, g=g)
    for a, b in zip((got, *got_states), (ref, *ref_states)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max())


def test_rollout_packed_pallas_at_g32_matches_jax():
    """g=32 (mid and out widths 256, the wide K3 instances on the card) in
    'pallas' mode: the port's rollout on K3's plain version against JAX's
    on its Pallas kernel in interpret mode, rmse at rtol 0.05
    (test_pallas_unet.py:116)."""
    js, ts = _solvers(precision="default", double_conv_mode="pallas")
    g = 32
    sos, src = _sos(g, seed=4), _src(js, g)
    kw = dict(g=g, num_iterations=2, collect=("rmse",))
    ref = jp.rollout_packed(js.params, js.op, jnp.asarray(src), jnp.asarray(sos),
                            cfg=js.cfg, **kw)
    got = tp.rollout_packed(ts.params, ts.op, src, sos, cfg=ts.cfg, device="cpu",
                            **kw)
    assert got["rmse"].shape == (2, g)
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(ref["rmse"]),
                               rtol=0.05, atol=1e-8)


def test_pallas_step_calls_k3_fourteen_times(monkeypatch):
    """Every DoubleConv of a packed step goes through the K3 wrapper, with
    the weights prepared once per rollout; none goes to cuDNN."""
    _, ts = _solvers(precision="default", double_conv_mode="pallas")
    calls = []
    real = tp.packed_double_conv

    def counting(params, x):
        calls.append(isinstance(params, PackedWeights))
        return real(params, x)

    def no_cudnn(*a, **k):
        raise AssertionError("a DoubleConv went to cuDNN in 'pallas' mode")

    monkeypatch.setattr(tp, "packed_double_conv", counting)
    monkeypatch.setattr(tp, "double_conv", no_cudnn)
    src = ts.source.expand(2, -1, -1, -1)
    tp.rollout_packed(ts.params, ts.op, src, _sos(2), cfg=ts.cfg, g=2,
                      num_iterations=3, device="cpu")
    assert len(calls) == 14 * 3
    assert all(calls)  # each call took the weights prepared for the rollout


def test_operator_on_another_grid_size():
    """The packed residual equals the unpacked one on a non-square grid."""
    op = make_operator(16, 24, 4, 2.0, 1.0, device="cpu")
    rng = np.random.default_rng(9)
    u = torch.from_numpy(rng.standard_normal((4, 16, 24, 2)).astype(np.float32))
    k_sq = torch.from_numpy(rng.random((4, 16, 24)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((4, 16, 24, 2)).astype(np.float32))
    from helmnet_tpu_torch.ops.spectral import helmholtz_residual

    ref = helmholtz_residual(op, u, k_sq, s)
    got = tp.residual_packed(op, tp.pack_batch(u, 2), tp.pack_batch(k_sq[..., None], 2),
                             tp.pack_batch(s, 2), 2)
    torch.testing.assert_close(tp.unpack_batch(got, 2), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tp.rmse_packed(got, 2), tit.residual_rmse(ref),
                               rtol=1e-5, atol=1e-7)

"""The port's HybridNet against the JAX package's, on the CPU, at 32^2 and
depth 2 with the JAX params converted: atol 1e-4 * max|ref| in
'xla'/'highest' mode, 2e-2 * max|ref| in 'pallas'/'default' mode (the
JAX side runs its Pallas kernel in interpret mode, the port its plain
version).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from helmnet_tpu.core.config import ModelConfig as JModelConfig
from helmnet_tpu.models import hybridnet as jh
from helmnet_tpu_torch.core.config import ModelConfig as TModelConfig
from helmnet_tpu_torch.models import hybridnet as th
from helmnet_tpu_torch.models.registry import get_architecture
from helmnet_tpu_torch.models.blocks import (
    torch_conv_to_hwio,
    torch_convtranspose_to_hwio,
)
from helmnet_tpu_torch.weights import from_jax_params

SMALL = dict(features=8, depth=2, state_depth=2, state_channels=2)
N = 32


def jax_layout_params(cfg, seed: int = 0, conv_scale: float = 1.0):
    """Random params in the JAX package's layout (nested dicts and lists
    of numpy arrays, HWIO, flipped transposed convs), drawn with the
    port's initializer; `jax.random` draws would cost seconds of op-by-op
    dispatch."""

    def to_jax(path, t):
        a = t.numpy()
        if a.ndim == 4:
            a = a * conv_scale
            a = (torch_convtranspose_to_hwio(a) if path.startswith("up[")
                 else torch_conv_to_hwio(a))
        return np.ascontiguousarray(a, dtype=np.float32)

    params = th.init_params(torch.Generator().manual_seed(seed), cfg)
    return th.map_leaves(params, to_jax)


def _cfgs(**kw):
    return JModelConfig(**SMALL, **kw), TModelConfig(**SMALL, **kw)


def _inputs(jcfg, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, N, N, jcfg.in_channels)).astype(np.float32)
    states = tuple(
        rng.standard_normal(np.shape(s)).astype(np.float32)
        for s in jh.init_states(batch, N, jcfg)
    )
    return x, states


def _run_both(jcfg, tcfg, seed=0):
    # scale the tiny xavier(0.02) conv weights so every level matters
    jp = jax_layout_params(tcfg, seed, conv_scale=20.0)
    tp = from_jax_params(jp, device="cpu")
    x, states = _inputs(jcfg, seed)
    jout, jst = jax.jit(jh.apply, static_argnames="cfg")(jp, x, states, cfg=jcfg)
    tout, tst = th.apply(tp, torch.from_numpy(x),
                         tuple(torch.from_numpy(s) for s in states), cfg=tcfg)
    return (np.asarray(jout), np.asarray(jh.flatten_states(jst)),
            tout.numpy(), th.flatten_states(tst).numpy())


def _close(got, ref, rel):
    np.testing.assert_allclose(got, ref, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("up_mode", ["dilated", "subpixel"])
def test_apply_xla_highest(up_mode):
    jcfg, tcfg = _cfgs(precision="highest", up_mode=up_mode)
    jout, jflat, tout, tflat = _run_both(jcfg, tcfg)
    assert tout.shape == (2, N, N, 2)
    _close(tout, jout, 1e-4)
    _close(tflat, jflat, 1e-4)


@pytest.mark.parametrize("activation", ["prelu", "relu"])
def test_apply_pallas_default(activation):
    kw = dict(precision="default", double_conv_mode="pallas",
              up_mode="subpixel", activation_function=activation)
    jcfg, tcfg = _cfgs(**kw)
    jout, jflat, tout, tflat = _run_both(jcfg, tcfg, seed=1)
    _close(tout, jout, 2e-2)
    _close(tflat, jflat, 2e-2)


def test_apply_prepared_k1_weights():
    """`apply` on the params that `prepare_k1` made gives the bits of the
    unprepared params, and both agree with the JAX package."""
    jcfg, tcfg = _cfgs(precision="default", double_conv_mode="pallas",
                       up_mode="subpixel")
    jp = jax_layout_params(tcfg, 2, conv_scale=20.0)
    tp = from_jax_params(jp, device="cpu")
    prepared = th.prepare_k1(tp, tcfg)
    assert th.K1_KEY in prepared["inc"] and th.K1_KEY in prepared["decode"][0]
    assert prepared["decode"][0][th.K1_KEY].ce == 2  # the outc head folded in
    assert all(th.K1_KEY in blk["conv_signal"] for blk in prepared["enc"])
    x, states = _inputs(jcfg, 2)
    tx = torch.from_numpy(x)
    ts = tuple(torch.from_numpy(s) for s in states)
    out_p, st_p = th.apply(prepared, tx, ts, cfg=tcfg)
    out_u, st_u = th.apply(tp, tx, ts, cfg=tcfg)
    torch.testing.assert_close(out_p, out_u, rtol=0, atol=0)
    torch.testing.assert_close(th.flatten_states(st_p), th.flatten_states(st_u),
                               rtol=0, atol=0)
    jout, jst = jax.jit(jh.apply, static_argnames="cfg")(jp, x, states, cfg=jcfg)
    _close(out_p.numpy(), np.asarray(jout), 2e-2)
    _close(th.flatten_states(st_p).numpy(), np.asarray(jh.flatten_states(jst)), 2e-2)


def test_pallas_mode_routes_every_double_conv(monkeypatch):
    """All 2*depth + 2 + depth DoubleConvs of a step reach the kernel
    wrapper, the last with the outc head folded in."""
    from helmnet_tpu_torch.ops import double_conv as dc

    calls = []
    real = dc.fused_double_conv

    def spy(params, x):
        calls.append(("post" in params, tuple(t.shape[-1] for t in x)))
        return real(params, x)

    monkeypatch.setattr(th, "fused_double_conv", spy)
    cfg = TModelConfig(precision="default", double_conv_mode="pallas")
    params = th.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros(1, 32, 32, cfg.in_channels)
    th.apply(params, x, th.init_states(1, 32, cfg), cfg=cfg)
    assert len(calls) == 14
    assert calls[-1] == (True, (8, 8))
    assert sum(post for post, _ in calls) == 1


def test_pallas_mode_does_not_fall_back_on_wide_models(monkeypatch):
    """A width K1 does not take goes to the cuDNN convs by its shape before
    any launch, as JAX's 'pallas' mode goes to XLA: no call reaches the
    kernel wrapper, `prepare_k1` converts nothing, and the output is the
    'xla' mode's to the bit. The wrapper itself still raises on it."""
    from helmnet_tpu_torch.ops import double_conv as dc

    calls = []
    monkeypatch.setattr(th, "fused_double_conv",
                        lambda p, x: calls.append(p) or dc.fused_double_conv(p, x))
    cfg = TModelConfig(features=24, depth=2, state_depth=2,
                       precision="default", double_conv_mode="pallas")
    params = th.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 16, 16, cfg.in_channels, generator=torch.Generator().manual_seed(1))
    states = th.init_states(1, 16, cfg)
    prepared = th.prepare_k1(params, cfg)
    assert th.K1_KEY not in prepared["inc"]
    assert all(th.K1_KEY not in p for p in prepared["decode"])
    out, _ = th.apply(prepared, x, states, cfg=cfg)
    assert calls == []
    xla = dataclasses.replace(cfg, double_conv_mode="xla")
    torch.testing.assert_close(out, th.apply(params, x, states, cfg=xla)[0],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported"):
        dc.fused_double_conv(params["inc"], (x,))


def test_pallas_mode_at_32_features_matches_jax():
    """A 'pallas' HybridNet at 32 features: JAX's `pix_supported` takes
    none of its DoubleConvs (more than 16 channels), so JAX runs them all
    on XLA, and the port all on cuDNN's convs (the CPU's here); 'xla'
    mode's tolerance, 1e-4 * max|ref|."""
    kw = dict(SMALL, features=32, precision="default", double_conv_mode="pallas")
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    jp = jax_layout_params(tcfg)
    x, states = _inputs(jcfg, seed=5)
    jout, jst = jax.jit(jh.apply, static_argnames="cfg")(jp, x, states, cfg=jcfg)
    tout, tst = th.apply(from_jax_params(jp, device="cpu"), torch.from_numpy(x),
                         tuple(torch.from_numpy(s) for s in states), cfg=tcfg)
    _close(tout.numpy(), np.asarray(jout), 1e-4)
    _close(th.flatten_states(tst).numpy(), np.asarray(jh.flatten_states(jst)), 1e-4)


def test_flatten_round_trip_and_layout():
    jcfg, tcfg = _cfgs()
    _, states = _inputs(jcfg, seed=3)
    flat = th.flatten_states(tuple(torch.from_numpy(s) for s in states))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jh.flatten_states(states)))
    assert flat.shape == (2, 2, th.total_state_length(N, tcfg))
    back = th.unflatten_states(flat, N, tcfg)
    for b, s in zip(back, states):
        np.testing.assert_array_equal(b.numpy(), s)


def test_shapes_and_counts_match_jax():
    jcfg, tcfg = JModelConfig(), TModelConfig()
    assert th.states_dimension((96, 64), 4) == jh.states_dimension((96, 64), 4)
    assert th.total_state_length(96, tcfg) == jh.total_state_length(96, jcfg)
    jshapes = jax.eval_shape(lambda k: jh.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    tp = th.init_params(torch.Generator().manual_seed(0), tcfg)
    assert th.count_params(tp) == jh.count_params(jshapes) == 48_160
    for s, js in zip(th.init_states(3, 96, tcfg), jh.init_states(3, 96, jcfg)):
        assert tuple(s.shape) == tuple(js.shape) and not s.any()


def test_registry():
    from helmnet_tpu_torch.models import resnet as tr

    assert get_architecture("custom_unet") is th
    assert get_architecture("resnet") is tr
    with pytest.raises(NotImplementedError, match="vit"):
        get_architecture("vit")


def test_depth_and_state_depth_variants():
    """state_depth < depth leaves the deeper encoders stateless."""
    kw = dict(features=8, depth=3, state_depth=1, state_channels=2,
              precision="highest")
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    jout, jflat, tout, tflat = _run_both(jcfg, tcfg, seed=4)
    _close(tout, jout, 1e-4)
    _close(tflat, jflat, 1e-4)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)

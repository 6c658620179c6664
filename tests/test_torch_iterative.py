"""The slice as a whole: the port's learned solver against the JAX
package's, on the CPU, with the trained weights of
trained_models/round1_best_epoch890.npz at 32^2.

- 'pallas' mode, 4 iterations: rtol 0.05 on the rmse trace
  (tests/test_pallas_pixconv.py:125-127; the JAX side runs its Pallas
  kernel in interpret mode, the port its plain version);
- 'xla'/'highest' mode, 20 iterations and `IterativeSolver.forward`:
  rtol 1e-3.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from helmnet_tpu.core import config as jconf
from helmnet_tpu.models import hybridnet as jh
from helmnet_tpu.solvers import iterative as jit_
from helmnet_tpu_torch.core import config as tconf
from helmnet_tpu_torch.solvers import iterative as tit
from helmnet_tpu_torch.weights import load_params_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "trained_models", "round1_best_epoch890.npz")
N, B = 32, 2


def _config(mod, **model_kw):
    return mod.Config(
        max_iterations=50,
        geometry=mod.GeometryConfig(domain_size=N, pml_size=4, sigma_max=2.0),
        model=mod.ModelConfig(up_mode="subpixel", **model_kw),
        source=mod.SourceConfig(amplitude=10.0, location=(26, 16)),
    )


def _jax_params(jcfg):
    """The JAX package's `load_params_npz` without its op-by-op init."""
    shapes = jax.eval_shape(lambda k: jh.init_params(k, jcfg.model),
                            jax.random.PRNGKey(0))
    treedef = jax.tree_util.tree_structure(shapes)
    with np.load(NPZ) as f:
        leaves = [f[f"p{i}"] for i in range(treedef.num_leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _solvers(**model_kw):
    jcfg, tcfg = _config(jconf, **model_kw), _config(tconf, **model_kw)
    js = jit_.IterativeSolver(jcfg, params=_jax_params(jcfg))
    ts = tit.IterativeSolver(tcfg, params=load_params_npz(NPZ, tcfg, device="cpu"),
                             device="cpu")
    return js, ts


def _sos(seed=0):
    rng = np.random.default_rng(seed)
    sos = np.ones((B, N, N), np.float32)
    sos[:, 10:20, 8:22] = 1.0 + rng.random((B, 10, 14)).astype(np.float32)
    return sos


def _rollouts(js, ts, iters, **kw):
    src = np.broadcast_to(np.asarray(js.source), (B, N, N, 2))
    sos = _sos()
    ref = jit_.rollout(js.params, js.op, src, sos, cfg=js.cfg,
                       num_iterations=iters, **kw)
    got = tit.rollout(ts.params, ts.op, src.copy(), sos, cfg=ts.cfg,
                      num_iterations=iters, device="cpu", **kw)
    return ref, got


def test_rollout_pallas_mode():
    js, ts = _solvers(precision="default", double_conv_mode="pallas")
    ref, got = _rollouts(js, ts, 4)
    assert got["rmse"].shape == (4, B)
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(ref["rmse"]),
                               rtol=0.05, atol=1e-8)


def test_rollout_prepares_k1_once(monkeypatch):
    """`rollout` in 'pallas' mode converts the K1 weights once, before the
    loop, and gives the same rmse with params prepared by the caller and
    without; both agree with the JAX package."""
    from helmnet_tpu_torch.models import hybridnet as th

    js, ts = _solvers(precision="default", double_conv_mode="pallas")
    calls = []
    real = th.prepare_k1
    monkeypatch.setattr(th, "prepare_k1",
                        lambda p, cfg: calls.append(1) or real(p, cfg))
    ref, got = _rollouts(js, ts, 3)
    assert len(calls) == 1
    src = np.broadcast_to(np.asarray(js.source), (B, N, N, 2)).copy()
    again = tit.rollout(th.prepare_k1(ts.params, ts.cfg.model), ts.op, src,
                        _sos(), cfg=ts.cfg, num_iterations=3, device="cpu")
    torch.testing.assert_close(again["rmse"], got["rmse"], rtol=0, atol=0)
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(ref["rmse"]),
                               rtol=0.05, atol=1e-8)


def test_rollout_xla_highest_20_iterations():
    js, ts = _solvers(precision="highest")
    ref, got = _rollouts(js, ts, 20, collect=("rmse", "wavefields", "best"),
                         decimate=5)
    rmse = got["rmse"].numpy()
    np.testing.assert_allclose(rmse, np.asarray(ref["rmse"]), rtol=1e-3)
    assert rmse[-1].max() < rmse[0].min()  # the trained solver converges
    assert got["wavefields"].shape == (4, B, N, N, 2)
    for key in ("wavefields", "wavefield", "residual", "best_wavefield"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), r,
                                   atol=1e-3 * np.abs(r).max())
    np.testing.assert_allclose(got["best_rmse"].numpy(),
                               np.asarray(ref["best_rmse"]), rtol=1e-3)


def test_forward_wrappers():
    """normalize_source, best_iterate and chunk_iterations=2, with a
    rescaled user source map."""
    js, ts = _solvers(precision="highest")
    src = 3.0 * np.asarray(js.source)
    js.set_source_maps(src)
    ts.set_source_maps(src)
    kw = dict(num_iterations=6, collect=("rmse", "wavefields"), decimate=2,
              normalize_source=True, best_iterate=True, chunk_iterations=2)
    ref = js.forward(_sos(1), **kw)
    got = ts.forward(_sos(1), **kw)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(ref["rmse"]),
                               rtol=1e-3)
    np.testing.assert_allclose(got["best_rmse"].numpy(),
                               np.asarray(ref["best_rmse"]), rtol=1e-3)
    for key in ("wavefield", "final_wavefield", "wavefields", "residual"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), r,
                                   atol=1e-3 * np.abs(r).max())


def test_forward_restart_on_divergence():
    js, ts = _solvers(precision="highest")
    kw = dict(num_iterations=4, chunk_iterations=2, restart_on_divergence=True,
              restart_factor=0.5)  # every chunk end restarts every sample
    ref = js.forward(_sos(2), **kw)
    got = ts.forward(_sos(2), **kw)
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(ref["rmse"]),
                               rtol=1e-3)


def test_warm_start_and_states_trace():
    _, ts = _solvers(precision="highest")
    src = ts.source.expand(B, -1, -1, -1)
    sos = _sos(3)
    run = lambda n, **kw: tit.rollout(ts.params, ts.op, src, sos, cfg=ts.cfg,
                                      num_iterations=n, device="cpu", **kw)
    whole = run(4, collect=("rmse", "states"))
    assert whole["states"].shape == (4, B, 2, 32 * 32 + 16 * 16 + 8 * 8 + 4 * 4)
    first = run(2)
    second = run(2, init=(first["wavefield"], first["states"]))
    torch.testing.assert_close(torch.cat([first["rmse"], second["rmse"]]),
                               whole["rmse"], rtol=1e-5, atol=0)


def test_best_iterate_is_nan_safe():
    _, ts = _solvers(precision="highest")
    src = ts.source.expand(B, -1, -1, -1).clone()
    src[0, 0, 0, 0] = float("nan")  # sample 0 diverges to NaN at once
    out = tit.rollout(ts.params, ts.op, src, _sos(4), cfg=ts.cfg,
                      num_iterations=3, collect=("rmse", "best"), device="cpu")
    rmse = out["rmse"].numpy()
    assert np.isnan(rmse[:, 0]).all() and np.isfinite(rmse[:, 1]).all()
    assert out["best_rmse"][0] == float("inf")
    assert not out["best_wavefield"][0].any()
    assert out["best_rmse"][1] == rmse[:, 1].min()


def test_solver_geometry():
    _, ts = _solvers()
    with pytest.raises(ValueError, match="divisible"):
        ts.set_domain_size(40)
    ts.set_domain_size((48, 32), source_location=(30, 10))
    assert ts.source.shape == (1, 48, 32, 2) and ts.op.height == 48
    assert ts.source[0, 30, 10, 0] == ts.source.abs().max()
    ts.set_source_maps(torch.zeros(2, 2, 48, 32))  # torch layout [B, 2, H, W]
    assert ts.source.shape == (2, 48, 32, 2)
    k_sq, wf = ts.get_initials(np.full((48, 32), 2.0, np.float32)[None])
    assert float(k_sq.max()) == 0.25 and wf.shape == (1, 48, 32, 2)
    assert dataclasses.asdict(ts.cfg.geometry)["domain_size"] == 48

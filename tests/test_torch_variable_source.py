"""`rollout_variable_source` in the port against the JAX package's, on the
CPU: 3 sources switching at iterations [0, 4, 9] over 12 iterations at
32^2, batch 2, the tpu_r2c weights. The tolerances of
tests/test_torch_iterative.py: rtol 1e-3 in 'xla'/'highest' mode, rtol
0.05 on the rmse in 'pallas' mode (JAX's Pallas kernel in interpret mode,
the port's plain K1)."""

import numpy as np
import pytest

from helmnet_tpu.ops.source import point_source_map
from helmnet_tpu.ops.spectral import make_operator as jmake_operator
from helmnet_tpu.solvers import iterative as jit_
from helmnet_tpu_torch.ops.spectral import make_operator
from helmnet_tpu_torch.solvers import iterative as tit
from tests.torch_solver_cases import N, PML, configs, r2c_params
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

SWITCH = [0, 4, 9]
ITERS, B = 12, 2


def _inputs():
    locs = [(N - 8, N // 2), (8, 10), (16, 24)]
    maps = np.stack([np.asarray(point_source_map(N, N, loc, 10.0)) for loc in locs])
    sources = np.repeat(maps[:, None], B, axis=1)  # [K, B, H, W, 2]
    rng = np.random.default_rng(1)
    sos = np.ones((B, N, N), np.float32)
    sos[:, 10:20, 8:22] = 1.0 + rng.random((B, 10, 14)).astype(np.float32)
    return sources.astype(np.float32), sos


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_matches_jax(mode):
    model = (dict(precision="highest", double_conv_mode="xla") if mode == "xla"
             else dict(precision="default", double_conv_mode="pallas"))
    jcfg, tcfg = configs(up_mode="subpixel", **model)
    jparams, tparams = r2c_params(jcfg, tcfg)
    sources, sos = _inputs()
    kw = dict(num_iterations=ITERS, collect=("rmse", "wavefields", "residuals"),
              decimate=4)
    ref = jit_.rollout_variable_source(
        jparams, jmake_operator(N, N, PML, 2.0, 1.0), sources, np.asarray(SWITCH),
        sos, cfg=jcfg, **kw)
    got = tit.rollout_variable_source(
        tparams, make_operator(N, N, PML, 2.0, 1.0, device="cpu"), sources,
        np.asarray(SWITCH), sos, cfg=tcfg, device="cpu", **kw)
    assert got["rmse"].shape == (ITERS, B)
    assert got["wavefields"].shape == (ITERS // 4, B, N, N, 2)
    rtol = 1e-3 if mode == "xla" else 0.05
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(ref["rmse"]), rtol=rtol)
    if mode == "xla":
        for key in ("wavefield", "residual", "wavefields", "residuals"):
            want = np.asarray(ref[key])
            np.testing.assert_allclose(got[key].numpy(), want, rtol=rtol,
                                       atol=rtol * np.abs(want).max())


def test_switch_recomputes_the_residual():
    """At a switch the residual is the new source's before the step: with
    the same source at every slot the rollout equals the plain one, and a
    switch to a zero source changes the rmse from that iteration on."""
    _, tcfg = configs(up_mode="subpixel", precision="highest", double_conv_mode="xla")
    tparams = r2c_params(*configs(up_mode="subpixel"))[1]
    sources, sos = _inputs()
    op = make_operator(N, N, PML, 2.0, 1.0, device="cpu")
    same = np.repeat(sources[:1], 3, axis=0)
    kw = dict(cfg=tcfg, num_iterations=ITERS, device="cpu")
    plain = tit.rollout(tparams, op, same[0], sos, **kw)["rmse"].numpy()
    fixed = tit.rollout_variable_source(tparams, op, same, SWITCH, sos, **kw)
    np.testing.assert_allclose(fixed["rmse"].numpy(), plain, rtol=1e-6)
    off = same.copy()
    off[1] = 0.0
    moved = tit.rollout_variable_source(tparams, op, off, SWITCH, sos, **kw)["rmse"]
    np.testing.assert_allclose(moved.numpy()[:4], plain[:4], rtol=1e-6)
    assert not np.allclose(moved.numpy()[4], plain[4], rtol=1e-3)

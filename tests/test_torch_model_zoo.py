"""The port's model zoo against the JAX package's on the CPU, on the
same seeded weights (numpy normal draws in JAX's layout, carried to the
port by `weights.from_jax_params`): `blocks.res_double_conv`,
`models/resnet.py` (apply, state packing, a registry rollout, the params
npz round trip) and `models/convgru.py`. All at 'highest' precision:
rtol 1e-5 with atol 1e-5 of the output's scale for one network call,
rtol 1e-3 on a rollout's rmse (tests/test_torch_iterative.py's rollout
tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.core import config as jconf
from helmnet_tpu.models import blocks as jb
from helmnet_tpu.models import convgru as jgru
from helmnet_tpu.models import resnet as jres
from helmnet_tpu.ops.source import point_source_map
from helmnet_tpu.ops.spectral import make_operator as jmake_operator
from helmnet_tpu.solvers.iterative import rollout as jrollout
from helmnet_tpu.train.checkpoint import save_params_npz
from helmnet_tpu_torch.core import config as tconf
from helmnet_tpu_torch.models import blocks as tb
from helmnet_tpu_torch.models import convgru as tgru
from helmnet_tpu_torch.models import hybridnet as th
from helmnet_tpu_torch.models import resnet as tres
from helmnet_tpu_torch.models.registry import get_architecture
from helmnet_tpu_torch.ops.spectral import make_operator as tmake_operator
from helmnet_tpu_torch.solvers.iterative import rollout as trollout
from helmnet_tpu_torch.weights import from_jax_params, leaf_paths, load_params_npz
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

N = 32


def _configs(**model_kw):
    def make(mod):
        return mod.Config(
            geometry=mod.GeometryConfig(domain_size=N, pml_size=4),
            model=mod.ModelConfig(architecture="resnet", depth=3, features=8,
                                  precision="highest", **model_kw),
            source=mod.SourceConfig(location=(26, 16)),
        )

    return make(jconf), make(tconf)


def _seeded(tree, seed, scale=0.15):
    """JAX's tree with every leaf redrawn from a seeded normal (PReLU
    slopes kept): weights large enough, and asymmetric, for the outputs
    to test every tap."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) if "act" in jax.tree_util.keystr(p)
        else (scale * rng.standard_normal(a.shape)).astype(np.float32), tree)


def _both(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree), from_jax_params(tree, device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_res_double_conv():
    tree = _seeded(jb.init_double_conv(jax.random.PRNGKey(1), 8, 8, "prelu",
                                       cmid=16), seed=1)
    jp, tp = _both(tree)
    x = _x(2, (2, 12, 12, 8))
    want = jb.res_double_conv(jp, jnp.asarray(x), "prelu", "highest")
    got = tb.res_double_conv(tp, torch.from_numpy(x), "prelu", "highest")
    _close(got, want)
    # the skip is the input itself
    _close(got - torch.from_numpy(x), jb.double_conv(jp, jnp.asarray(x), "prelu",
                                                      "highest"))


def test_resnet_apply_and_states():
    jcfg, tcfg = _configs()
    tree = _seeded(jres.init_params(jax.random.PRNGKey(0), jcfg.model), seed=3)
    jp, tp = _both(tree)
    x = _x(4, (2, N, N, 6))
    state = _x(5, (2, N, N, 2))
    want, wstates = jres.apply(jp, jnp.asarray(x), (jnp.asarray(state),), cfg=jcfg.model)
    got, gstates = tres.apply(tp, torch.from_numpy(x), (torch.from_numpy(state),),
                              cfg=tcfg.model)
    assert got.shape == (2, N, N, 2) and len(gstates) == 1
    _close(got, want)
    _close(gstates[0], wstates[0])
    flat = tres.flatten_states(gstates)
    _close(flat, jres.flatten_states(wstates))
    assert torch.equal(tres.unflatten_states(flat, N, tcfg.model)[0], gstates[0])
    assert tres.total_state_length((N, 16), tcfg.model) == N * 16
    zeros = tres.init_states(3, (N, 16), tcfg.model)
    assert zeros[0].shape == jres.init_states(3, (N, 16), jcfg.model)[0].shape
    assert not zeros[0].any()
    assert th.count_params(tres.init_params(torch.Generator().manual_seed(0),
                                            tcfg.model)) == sum(
        a.size for a in jax.tree_util.tree_leaves(tree))


def test_resnet_rollout_via_registry():
    """A registry rollout of the resnet in both packages, in 'pallas' mode
    too: the resnet never reaches K1, as JAX's never reaches Pallas."""
    for mode in ("xla", "pallas"):
        jcfg, tcfg = _configs(double_conv_mode=mode)
        tree = _seeded(jres.init_params(jax.random.PRNGKey(0), jcfg.model), seed=6,
                       scale=0.05)
        jp, tp = _both(tree)
        assert get_architecture("resnet") is tres
        assert tres.prepare_params(tp, tcfg.model) is tp  # no K1 weights made
        src = point_source_map(N, N, (26, 16), 10.0)[None]
        sos = np.ones((1, N, N), np.float32)
        sos[0, 10:20, 8:24] = 1.4
        want = jrollout(jp, jmake_operator(N, N, 4, 2.0, 1.0), jnp.asarray(src),
                        jnp.asarray(sos), cfg=jcfg, num_iterations=5)
        got = trollout(tp, tmake_operator(N, N, 4, 2.0, 1.0, device="cpu"), src, sos,
                       cfg=tcfg, num_iterations=5, device="cpu")
        assert bool(torch.isfinite(got["rmse"]).all())
        _close(got["rmse"], want["rmse"], rtol=1e-3)
        _close(got["wavefield"], want["wavefield"], rtol=1e-3)


def test_resnet_npz_round_trip(tmp_path):
    """JAX's flat npz of resnet params reads into the port through the
    registry template, every 7x7 HWIO leaf in OIHW; checked on a kernel
    with one off-centre tap."""
    jcfg, tcfg = _configs()
    tree = _seeded(jres.init_params(jax.random.PRNGKey(0), jcfg.model), seed=7)
    tree["inc"]["w"] = np.zeros_like(tree["inc"]["w"])
    tree["inc"]["w"][0, 5, 3, 6] = 1.0  # kh 0, kw 5, in 3, out 6 (HWIO)
    path = tmp_path / "resnet.npz"
    save_params_npz(str(path), tree)
    got = load_params_npz(str(path), tcfg, device="cpu")
    assert leaf_paths(tcfg)[:5] == ["blocks[0].act.a", "blocks[0].c1.b",
                                    "blocks[0].c1.w", "blocks[0].c2.b",
                                    "blocks[0].c2.w"]
    w = got["inc"]["w"]
    assert w.shape == (8, 8, 7, 7) and w[6, 3, 0, 5] == 1.0 and w.sum() == 1.0
    ref = from_jax_params(tree, device="cpu")
    for (p, a), (q, b) in zip(th.iter_leaves(got), th.iter_leaves(ref)):
        assert p == q and torch.equal(a, b), p
    x = _x(8, (1, N, N, 6))
    state = tres.init_states(1, N, tcfg.model)
    want, _ = jres.apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                         (jnp.zeros((1, N, N, 2)),), cfg=jcfg.model)
    _close(tres.apply(got, torch.from_numpy(x), state, cfg=tcfg.model)[0], want)


def test_convgru():
    tree = _seeded(jgru.init_convgru(jax.random.PRNGKey(2), 8, 2), seed=9, scale=0.3)
    jp, tp = _both(tree)
    x, h = _x(10, (2, 16, 16, 8)), _x(11, (2, 16, 16, 2))
    want = jgru.convgru(jp, jnp.asarray(x), jnp.asarray(h), precision="highest")
    got = tgru.convgru(tp, torch.from_numpy(x), torch.from_numpy(h), precision="highest")
    assert got.shape == h.shape
    _close(got, want)
    # the port's own init has JAX's shapes, in OIHW
    own = tgru.init_convgru(torch.Generator().manual_seed(0), 8, 2, k=5)
    for name in ("update_gate", "reset_gate", "out_gate"):
        assert own[name]["w"].shape == (2, 10, 5, 5)
    assert tgru.convgru(own, torch.from_numpy(x), torch.from_numpy(h)).shape == h.shape


def test_unknown_architecture():
    with pytest.raises(NotImplementedError, match="transformer"):
        get_architecture("transformer")

"""The port's 3D learned solver against the JAX package's, on the CPU:

- each block of `models/blocks3d.py` (conv3d, strided down conv, both
  transposed-conv forms, double_conv3d) on JAX-initialised weights carried
  across by `weights.from_jax_params3d`, within 1e-5 max|ref|, and the
  layout converters round trip;
- `hybridnet3d.apply` in both up modes (outputs and new states within
  1e-5 max|ref|), the state shapes and the flatten round trip;
- `rollout3d` / `IterativeSolver3D.forward`: rmse within rtol 1e-3 over 4
  iterations (tests/test_torch_iterative.py's rollout tolerance); chunked
  against unchunked and the best iterate (tests/test_model3d.py:106-112,
  130-134);
- `weights.load_params3d_npz` on both committed npz files, leaf for leaf
  equal to JAX's loader, and the committed copies of the 3D weights and
  validation volumes equal to their sources;
- tpu3d_a at full width (48^3, depth 3, features 16), batch 1, 2
  iterations on a validation volume, within rtol 1e-3 of JAX.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.core.config import Config as JConfig
from helmnet_tpu.core.config import GeometryConfig as JGeometry
from helmnet_tpu.core.config import ModelConfig as JModel
from helmnet_tpu.models import blocks3d as jb
from helmnet_tpu.models import hybridnet3d as jh
from helmnet_tpu.solvers.iterative3d import IterativeSolver3D as JSolver
from helmnet_tpu.train.loop3d import load_params3d_npz as jload
from helmnet_tpu_torch.core.config import Config as TConfig
from helmnet_tpu_torch.core.config import GeometryConfig as TGeometry
from helmnet_tpu_torch.core.config import ModelConfig as TModel
from helmnet_tpu_torch.models import blocks3d as tb
from helmnet_tpu_torch.models import hybridnet3d as th
from helmnet_tpu_torch.solvers.iterative3d import IterativeSolver3D as TSolver
from helmnet_tpu_torch.solvers.iterative3d import rollout3d
from helmnet_tpu_torch.weights import from_jax_params3d, load_params3d_npz
from tests.torch_solver_cases import ROOT, one_torch_thread  # noqa: F401

NPZ = {"tpu3d_a": (os.path.join(ROOT, "trained_models", "tpu3d_a_ep80.npz"), 48,
                   os.path.join(ROOT, "checkpoints", "tpu3d_a", "params3d_ep80.npz")),
       "tpu3d_het": (os.path.join(ROOT, "trained_models", "tpu3d_het_ep49.npz"), 64,
                     os.path.join(ROOT, "checkpoints", "tpu3d_het", "params3d_ep49.npz"))}
VAL = {tag: os.path.join(ROOT, "datasets", "val3d", f"{tag}_val.npz") for tag in NPZ}


def configs(domain=16, depth=2, features=4, up_mode="dilated"):
    """(JAX Config, port Config): tests/test_model3d.py's cfg3d."""
    def make(Config, Geometry, Model):
        return Config(geometry=Geometry(domain_size=domain, pml_size=3),
                      model=Model(depth=depth, state_depth=depth, features=features,
                                  in_channels=7, precision="highest", up_mode=up_mode))

    return make(JConfig, JGeometry, JModel), make(TConfig, TGeometry, TModel)


def trained_configs(domain):
    """The tpu3d runs' config: the default with depth 3, features 16."""
    def make(Config):
        cfg = Config()
        return cfg.replace(
            geometry=dataclasses.replace(cfg.geometry, domain_size=domain),
            model=dataclasses.replace(cfg.model, depth=3, state_depth=3, features=16,
                                      in_channels=7))

    return make(JConfig), make(TConfig)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs()
    jp = jh.init_params(jax.random.PRNGKey(0), jcfg.model)
    return jcfg, tcfg, jp, from_jax_params3d(_np_tree(jp), device="cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 4), (1, 0, 1)])
def test_conv3d(stride, padding, k):
    jp = jb.init_conv3d(jax.random.PRNGKey(2), k, 3, 5)
    tp = from_jax_params3d(_np_tree(jp), device="cpu")
    x = _x((2, 8, 6, 10, 3))
    ref = jb.conv3d(jp, jnp.asarray(x), stride=stride, padding=padding)
    got = tb.conv3d(tp, torch.from_numpy(x), stride=stride, padding=padding)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("subpixel", [False, True], ids=["dilated", "subpixel"])
def test_conv_transpose3d(subpixel):
    jp = jb.init_conv_transpose3d(jax.random.PRNGKey(3), 4, 3, 5)
    tp = from_jax_params3d({"up": [_np_tree(jp)]}, device="cpu")["up"][0]
    x = _x((2, 6, 4, 8, 3), seed=4)
    ref = jb.conv_transpose3d(jp, jnp.asarray(x), stride=2, padding=1)
    fn = tb.conv_transpose3d_subpixel if subpixel else tb.conv_transpose3d
    got = fn(tp, torch.from_numpy(x), stride=2, padding=1)
    assert tuple(got.shape) == ref.shape == (2, 12, 8, 16, 5)
    _close(got, ref)


def test_double_conv3d():
    jp = jb.init_double_conv3d(jax.random.PRNGKey(5), 6, 4, "prelu")
    tp = from_jax_params3d(_np_tree(jp), device="cpu")
    x = _x((1, 8, 8, 8, 6), seed=6)
    _close(tb.double_conv3d(tp, torch.from_numpy(x), "prelu"),
           jb.double_conv3d(jp, jnp.asarray(x), "prelu"))


def test_layout_converters_round_trip():
    w = _x((3, 3, 3, 4, 5))
    back = tb.torch_conv3d_to_dhwio(tb.dhwio_to_torch_conv3d(w))
    np.testing.assert_array_equal(back, w)
    back = tb.torch_convtranspose3d_to_dhwio(tb.dhwio_to_torch_convtranspose3d(w))
    np.testing.assert_array_equal(back, w)
    assert tb.dhwio_to_torch_conv3d(w).shape == (5, 4, 3, 3, 3)
    assert tb.dhwio_to_torch_convtranspose3d(w).shape == (4, 5, 3, 3, 3)


@pytest.mark.parametrize("up_mode", ["dilated", "subpixel"])
def test_apply_against_jax(model, up_mode):
    jcfg, tcfg, jp, tp = model
    jm = dataclasses.replace(jcfg.model, up_mode=up_mode)
    tm = dataclasses.replace(tcfg.model, up_mode=up_mode)
    x = _x((2, 16, 16, 16, 7), seed=7)
    states = [_x(tuple(s.shape), seed=8 + i)
              for i, s in enumerate(jh.init_states(2, 16, jcfg.model))]
    ref, ref_states = jh.apply(jp, jnp.asarray(x), [jnp.asarray(s) for s in states], cfg=jm)
    got, got_states = th.apply(tp, torch.from_numpy(x),
                               [torch.from_numpy(s) for s in states], cfg=tm)
    _close(got, ref)
    assert len(got_states) == len(ref_states) == 2
    for a, b in zip(got_states, ref_states):
        _close(a, b)


def test_states_and_flatten(model):
    jcfg, tcfg, jp, tp = model
    assert th.states_dimension3d(16, 2) == jh.states_dimension3d(16, 2)
    assert th.states_dimension3d((8, 16, 12), 2) == [(8, 16, 12), (4, 8, 6)]
    assert th.count_params(tp) == jh.count_params(jp)
    states = th.init_states(2, 16, tcfg.model)
    assert [tuple(s.shape) for s in states] == [(2, 16, 16, 16, 2), (2, 8, 8, 8, 2)]
    rand = tuple(torch.from_numpy(_x(tuple(s.shape), seed=20 + i))
                 for i, s in enumerate(states))
    flat = th.flatten_states(rand)
    assert tuple(flat.shape) == (2, 2, 16**3 + 8**3)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jh.flatten_states([jnp.asarray(s.numpy()) for s in rand])))
    for a, b in zip(th.unflatten_states(flat, 16, tcfg.model), rand):
        assert torch.equal(a, b)
    assert th.total_state_length(16, tcfg.model) == 16**3 + 8**3


def _sos(b=1, n=16, seed=7):
    return (1.0 + 0.3 * np.random.default_rng(seed).random((b, n, n, n))).astype(np.float32)


def test_forward_against_jax(model):
    jcfg, tcfg, jp, tp = model
    sos = _sos(2)
    ref = JSolver(jcfg, params=jp).forward(sos, num_iterations=4)
    got = TSolver(tcfg, params=tp, device="cpu").forward(sos, num_iterations=4)
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(ref["rmse"]), rtol=1e-3)
    np.testing.assert_allclose(got["best_rmse"].numpy(), np.asarray(ref["best_rmse"]),
                               rtol=1e-3)
    assert tuple(got["wavefield"].shape) == (2, 16, 16, 16, 2)
    assert set(got) == set(ref)


def test_zero_field_residual_is_the_source(model):
    _, tcfg, _, tp = model
    solver = TSolver(tcfg, params=tp, device="cpu")
    k_sq, wf = solver.get_initials(np.ones((1, 16, 16, 16), np.float32))
    assert torch.equal(solver.get_residual(wf, k_sq), -solver.source)
    with pytest.raises(ValueError, match="divisible"):
        solver.set_domain_size(18)
    solver.set_domain_size((8, 16, 12), source_location=(2, 3, 4))
    assert tuple(solver.source.shape) == (1, 8, 16, 12, 2)
    assert solver.source[0, 2, 3, 4, 0] == tcfg.source.amplitude


def test_chunked_matches_unchunked(model):
    _, tcfg, _, tp = model
    solver = TSolver(tcfg, params=tp, device="cpu")
    sos = _sos()
    full = solver.forward(sos, num_iterations=6, best_iterate=False)
    chunked = solver.forward(sos, num_iterations=6, chunk_iterations=2,
                             best_iterate=False)
    np.testing.assert_allclose(chunked["rmse"].numpy(), full["rmse"].numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(chunked["wavefield"].numpy(), full["wavefield"].numpy(),
                               rtol=1e-4, atol=1e-6)
    best = solver.forward(sos, num_iterations=6, chunk_iterations=3)
    np.testing.assert_allclose(best["best_rmse"].numpy(), full["rmse"].numpy().min(0),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="chunk_iterations"):
        solver.forward(sos, num_iterations=6, chunk_iterations=4)


def test_best_iterate_tracks_minimum_and_skips_nan(model):
    _, tcfg, _, tp = model
    solver = TSolver(tcfg, params=tp, device="cpu")
    sos = torch.ones((2, 16, 16, 16))
    src = solver.source.expand(2, -1, -1, -1, -1)
    out = rollout3d(tp, solver.op, src, sos, cfg=solver.cfg, num_iterations=5,
                    collect=("rmse", "best"), device="cpu")
    np.testing.assert_allclose(out["best_rmse"].numpy(), out["rmse"].numpy().min(0),
                               rtol=1e-6)
    # a NaN trajectory keeps its (infinite) starting best, not NaN
    sos[1, 0, 0, 0] = float("nan")
    out = rollout3d(tp, solver.op, src, sos, cfg=solver.cfg, num_iterations=2,
                    collect=("best",), device="cpu")
    assert torch.isnan(out["residual"][1]).any() and not torch.isnan(out["best_rmse"]).any()
    assert "rmse" not in out


@pytest.mark.parametrize("tag", sorted(NPZ))
def test_load_params3d_npz_against_jax(tag):
    path, n, _ = NPZ[tag]
    jcfg, tcfg = trained_configs(n)
    ref = jload(path, jcfg)
    got = load_params3d_npz(path, tcfg, device="cpu")
    # the JAX tree read into the port's layout, leaf for leaf
    want = from_jax_params3d(_np_tree(ref), device="cpu")
    paths = [p for p, _ in th.iter_leaves(got)]
    assert paths == [p for p, _ in th.iter_leaves(want)] and len(paths) == 69
    for (p, a), (_, b) in zip(th.iter_leaves(got), th.iter_leaves(want)):
        assert torch.equal(a, b), p
    # a ModelConfig works too, and a wrong model raises
    assert torch.equal(load_params3d_npz(path, tcfg.model, device="cpu")["outc"]["w"],
                       got["outc"]["w"])
    with pytest.raises(ValueError, match="69"):
        load_params3d_npz(path, dataclasses.replace(tcfg.model, depth=2), device="cpu")


@pytest.mark.parametrize("tag", sorted(NPZ))
def test_committed_copies_equal_their_sources(tag):
    path, n, source = NPZ[tag]
    if not os.path.exists(source):
        pytest.skip(f"{source} is not present")
    with open(path, "rb") as a, open(source, "rb") as b:
        assert a.read() == b.read()
    with np.load(VAL[tag]) as got, \
            np.load(os.path.join(ROOT, "datasets", tag, "maps3d.npz")) as ref:
        assert got.files == ["val"]
        assert got["val"].shape == (16, n, n, n) and got["val"].dtype == np.float32
        np.testing.assert_array_equal(got["val"], ref["val"])


def test_tpu3d_a_full_width_against_jax():
    """The trained tpu3d_a model at its own size, 2 steps on validation
    volume 0 with the centre source (the solver's default)."""
    path, n, _ = NPZ["tpu3d_a"]
    jcfg, tcfg = trained_configs(n)
    with np.load(VAL["tpu3d_a"]) as f:
        sos = f["val"][:1]
    ref = JSolver(jcfg, params=jload(path, jcfg)).forward(sos, num_iterations=2)
    got = TSolver.from_params_npz(path, tcfg, device="cpu").forward(sos, num_iterations=2)
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(ref["rmse"]), rtol=1e-3)
    w = np.asarray(ref["wavefield"])
    np.testing.assert_allclose(got["wavefield"].numpy(), w, atol=1e-3 * np.abs(w).max())


def test_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSolver(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_params3d_npz(NPZ["tpu3d_a"][0], trained_configs(48)[1])

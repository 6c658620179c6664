"""The port's 3D training path (`data/ellipsoids3d.py`,
`train/loop3d.Trainer3D`) against the JAX package's, on the CPU, at
tests/test_train3d.py:30-45's tiny config (16^3, depth 2, features 4,
buffer 8, batch 4, 3 unrolled steps):

- `make_shell3d` / `make_dataset3d` / `split_and_save3d` bit-equal to JAX's;
- the filled buffer equal to JAX's (same source draws, same fresh
  experiences), one step's loss (rel 1e-3) and every grad leaf (atol
  2e-3 max|ref| + rtol 2e-3, tests/test_parity.py:182-190) against JAX's
  on the same batch, and one mega-step's loss, restarts and write-back
  against JAX's on the same draws;
- the buffer semantics of tests/test_train3d.py:76-89, remat against no
  remat (:188-206), save -> JAX's `load_params3d_npz`, top-k and
  restore_best (:92-120), the resume state, validate, and the non-finite
  loss guard.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.core.config import Config as JConfig
from helmnet_tpu.data import ellipsoids3d as jdata
from helmnet_tpu.models import hybridnet3d as jhn
from helmnet_tpu.solvers.iterative3d import SolverCarry3D as JCarry
from helmnet_tpu.solvers.iterative3d import n_steps3d as jn_steps3d
from helmnet_tpu.train.loop3d import Trainer3D as JTrainer
from helmnet_tpu.train.loop3d import load_params3d_npz as jload
from helmnet_tpu_torch.core.config import Config as TConfig
from helmnet_tpu_torch.data import ellipsoids3d as tdata
from helmnet_tpu_torch.models import hybridnet3d as thn
from helmnet_tpu_torch.train.loop3d import FIELDS, Trainer3D
from helmnet_tpu_torch.weights import from_jax_params3d
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

LOSS_RTOL, GRAD_RTOL = 1e-3, 2e-3


def tiny_cfg(Config, **training_over):
    """tests/test_train3d.py:24."""
    cfg = Config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, depth=2, state_depth=2, features=4,
                                  state_channels=2, in_channels=7),
        training=dataclasses.replace(cfg.training, buffer_size=8, train_batch_size=4,
                                     unrolling_steps=3, learning_rate=1e-3,
                                     **training_over),
        geometry=dataclasses.replace(cfg.geometry, domain_size=16, pml_size=4,
                                     sigma_max=2.0),
    )


@pytest.fixture(scope="module")
def volumes():
    return tdata.make_dataset3d(8, 16, seed=3)


@pytest.fixture(scope="module")
def jparams():
    """Seeded random weights in JAX's tree (PReLU slopes 0.25; the tree from
    `jax.eval_shape`, without JAX's op-by-op init), and the port's copy."""
    shapes = jax.eval_shape(lambda k: jhn.init_params(k, tiny_cfg(JConfig).model),
                            jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full(a.shape, 0.25, np.float32)
        if "act" in jax.tree_util.keystr(path)
        else (0.1 * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    return p, from_jax_params3d(p, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"interior_heterogeneity": 0.8}], ids=["shell", "het"])
def test_dataset_bit_equal(kw):
    got = tdata.make_dataset3d(3, 16, seed=3, **kw)
    want = jdata.make_dataset3d(3, 16, seed=3, **kw)
    assert got.dtype == np.float32 and got.shape == (3, 16, 16, 16)
    np.testing.assert_array_equal(got, want)
    a = tdata.make_shell3d(np.random.default_rng(9), 12, n_harmonics=2, **kw)
    np.testing.assert_array_equal(a, jdata.make_shell3d(np.random.default_rng(9), 12,
                                                        n_harmonics=2, **kw))


def test_split_and_save_bit_equal(tmp_path):
    tdata.split_and_save3d(str(tmp_path / "port"), 4, 2, 2, imsize=8, seed=1)
    jdata.split_and_save3d(str(tmp_path / "jax"), 4, 2, 2, imsize=8, seed=1)
    for name in ("trainset", "validation", "testset"):
        with np.load(tmp_path / "port" / f"{name}.npz") as a, \
                np.load(tmp_path / "jax" / f"{name}.npz") as b:
            np.testing.assert_array_equal(a["maps"], b["maps"])


def _jax_batch(buf, idx):
    return {k: buf[k][jnp.asarray(idx)] for k in FIELDS}


def test_step_against_jax(volumes, jparams):
    """The same filled buffer, then one step's loss and grads on one batch,
    then one mega-step on the same draws."""
    jp, tp = jparams
    jcfg = tiny_cfg(JConfig, p_random_source=0.5)
    tcfg = tiny_cfg(TConfig, p_random_source=0.5)
    jtr = JTrainer(jcfg, params=jax.tree_util.tree_map(jnp.asarray, jp))  # it donates
    ttr = Trainer3D(tcfg, params=tp, device="cpu")
    jtr.fill_buffer(volumes)
    ttr.fill_buffer(volumes)
    np.testing.assert_array_equal(ttr.src_pool.numpy(), np.asarray(jtr.src_pool))
    for k in FIELDS:
        ref = np.asarray(jtr._buf[k])
        np.testing.assert_allclose(ttr._buf[k].numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1), err_msg=k)

    idx = np.array([6, 1, 3, 4])
    jb = _jax_batch(jtr._buf, idx)

    def jloss(p):
        carry = JCarry(jb["wavefield"], jb["residual"],
                       jhn.unflatten_states(jb["states"], (16, 16, 16), jcfg.model))
        _, ys = jn_steps3d(p, jtr.op, jb["source"], jb["k_sq"], carry, cfg=jcfg,
                           num_steps=3)
        return jcfg.training.loss_amplify * jnp.mean(ys["residuals"] ** 2)

    ref_loss, ref_grads = jax.value_and_grad(jloss)(jp)
    batch = {k: ttr._buf[k][torch.as_tensor(idx)] for k in FIELDS}
    loss, _ = ttr.unrolled_loss(batch)
    leaves = [t for _, t in thn.iter_leaves(ttr.params)]
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    want = from_jax_params3d(jax.tree_util.tree_map(np.asarray, ref_grads), device="cpu")
    for (path, w), g in zip(thn.iter_leaves(want), grads):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=path)

    # one mega-step each on the host RNG's draws (the same generator, order)
    jtr.epoch = ttr.epoch = 1
    js = jtr.training_epoch(n_batches=1)
    ts = ttr.training_epoch(n_batches=1)
    assert abs(ts["train_loss_mean"] - js["train_loss_mean"]) <= \
        LOSS_RTOL * abs(js["train_loss_mean"])
    assert ts["new_sos"] == js["new_sos"] and ts["maxiter"] == js["maxiter"]
    np.testing.assert_array_equal(ttr._buf["iteration"].numpy(),
                                  np.asarray(jtr._buf["iteration"]))
    for k in ("wavefield", "residual", "source"):
        ref = np.asarray(jtr._buf[k])
        np.testing.assert_allclose(ttr._buf[k].numpy(), ref,
                                   atol=1e-3 * np.abs(ref).max(), err_msg=k)


def test_buffer_semantics(volumes, jparams):
    """tests/test_train3d.py:76-89."""
    tr = Trainer3D(tiny_cfg(TConfig, p_random_source=0.5), params=jparams[1], device="cpu")
    tr.fill_buffer(volumes)
    assert tr._buf["iteration"].tolist() == [10 * i for i in range(8)]
    assert tr._buf["iteration"].dtype == torch.int32
    tr.epoch = 1
    stats = tr.training_epoch(n_batches=2)
    maxiter = tr.cfg.training.curriculum_slope + 1
    assert (tr._buf["iteration"] < max(maxiter, 80)).all()
    assert torch.isfinite(tr._buf["wavefield"]).all()
    assert torch.isfinite(tr._buf["residual"]).all()
    assert np.isfinite(stats["train_loss_mean"]) and np.isfinite(stats["grad_norm_mean"])
    assert stats["global_step"] == 2 and tr.epoch == 2


def test_remat_matches(volumes, jparams):
    """tests/test_train3d.py:188-206."""
    a = Trainer3D(tiny_cfg(TConfig), params=jparams[1], device="cpu")
    b = Trainer3D(tiny_cfg(TConfig, remat=True), params=jparams[1], device="cpu")
    a.fill_buffer(volumes)
    b.fill_buffer(volumes)
    sa, sb = a.training_epoch(2), b.training_epoch(2)
    assert sb["train_loss_mean"] == pytest.approx(sa["train_loss_mean"], rel=1e-5)
    for (path, x), (_, y) in zip(thn.iter_leaves(a.params), thn.iter_leaves(b.params)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), atol=1e-6,
                                   err_msg=path)


def test_save_loads_in_jax(tmp_path, jparams):
    tr = Trainer3D(tiny_cfg(TConfig), params=jparams[1], device="cpu")
    path = tr.save(str(tmp_path), "x")
    assert path.endswith("params3d_x.npz")
    loaded = jload(path, tiny_cfg(JConfig))
    back = from_jax_params3d(jax.tree_util.tree_map(np.asarray, loaded), device="cpu")
    for (path_, a), (_, b) in zip(thn.iter_leaves(tr.params), thn.iter_leaves(back)):
        assert torch.equal(a.detach(), b), path_
    for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(jparams[0])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_validate_topk_and_restore(tmp_path, volumes, jparams):
    """tests/test_train3d.py:92-120 and :123-160."""
    tr = Trainer3D(tiny_cfg(TConfig, p_random_source=0.5), params=jparams[1], device="cpu")
    tr.fill_buffer(volumes)
    v = tr.validate(volumes[:4], num_iterations=3, batch_size=2)
    assert v["val_n"] == 4 and np.isfinite(v["val_median"])
    d = str(tmp_path)
    for epoch, val in ((5, 0.5), (6, 0.3), (7, 0.9)):
        tr.epoch = epoch
        tr.save_topk(d, val, k=2)
    with open(os.path.join(d, "manifest3d.json")) as f:
        assert [e["epoch"] for e in json.load(f)["top"]] == [6, 5]
    assert os.path.exists(os.path.join(d, "params3d_last.npz"))
    assert not os.path.exists(os.path.join(d, "params3d_ep7.npz"))
    other = Trainer3D(tiny_cfg(TConfig), generator=torch.Generator().manual_seed(4),
                      device="cpu")
    assert other.restore_best(d)
    for (p, a), (_, b) in zip(thn.iter_leaves(tr.params), thn.iter_leaves(other.params)):
        assert torch.equal(a.detach(), b.detach()), p
    assert not other.restore_best(os.path.join(d, "absent"))

    # the resume state: params, Adam moments, counters and scheduler
    tr.training_epoch(n_batches=2)
    tr.scheduler.step(0.7)
    tr.scheduler.step(0.9)
    tr.save_state(d)
    again = Trainer3D(tiny_cfg(TConfig), generator=torch.Generator().manual_seed(5),
                      device="cpu")
    assert again.restore(d)
    assert (again.epoch, again.global_step) == (tr.epoch, tr.global_step)
    s, t = again.scheduler, tr.scheduler
    assert (s.lr, s.best, s.bad_epochs) == (t.lr, t.best, t.bad_epochs)
    for (p, a), (_, b) in zip(thn.iter_leaves(tr.params), thn.iter_leaves(again.params)):
        assert torch.equal(a.detach(), b.detach()), p
    sa, sb = tr.optimizer.state_dict()["state"], again.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][key], sb[i][key])
    assert not again.restore(os.path.join(d, "absent"))


def test_fit_and_nan_guard(tmp_path, volumes, jparams):
    tr = Trainer3D(tiny_cfg(TConfig), params=jparams[1], device="cpu",
                   log_dir=str(tmp_path / "logs"))
    hist = tr.fit(volumes, val_maps=volumes[:2], epochs=2, ckpt_dir=str(tmp_path / "ck"),
                  val_every=2, val_iterations=2, n_batches=1)
    assert [h["epoch"] for h in hist] == [0, 1] and "val_median" in hist[1]
    assert os.path.exists(tmp_path / "ck" / "manifest3d.json")
    tr.close()
    with open(tmp_path / "logs" / "train3d_log.jsonl") as f:
        assert len(f.read().splitlines()) == 3
    with torch.no_grad():
        tr.params["outc"]["b"].fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite"):
        tr.training_epoch(n_batches=1)


def test_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer3D(tiny_cfg(TConfig))

"""The port's trainer on its own, on the CPU, at the JAX package's
`tiny_config` (tests/test_training.py:20): the device buffer against the
host buffer (tests/test_device_buffer.py:47-119), checkpoints and top-k
(tests/test_checkpoint_resume.py:11-80), the params npz read by the JAX
package's loader, the refusals, and `cli/train --smoke`.

- device buffer: the first step on the same draw as the host path's, loss
  rel 1e-5; the sparse source pool against the dense one, sources atol
  3e-6 * amplitude and loss rel 1e-4;
- the npz: exact, leaf by leaf.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from helmnet_tpu.core.config import Config as JConfig
from helmnet_tpu.models.registry import get_architecture as jget_architecture
from helmnet_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from helmnet_tpu_torch.core import config as tconf
from helmnet_tpu_torch.data.ellipses import make_dataset
from helmnet_tpu_torch.models import hybridnet as th
from helmnet_tpu_torch.train import checkpoint as tckpt
from helmnet_tpu_torch.train import loop as tloop
from helmnet_tpu_torch.train.device_buffer import FIELDS
from helmnet_tpu_torch.train.replay import ExperienceBatch
from helmnet_tpu_torch.weights import from_jax_params, load_params_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "trained_models", "round1_best_epoch890.npz")
N, B = 32, 4


def tiny_config(**training):
    """tests/test_training.py:20, in the port's config classes."""
    return tconf.Config(
        max_iterations=50,
        geometry=tconf.GeometryConfig(domain_size=N, pml_size=4, sigma_max=2.0),
        model=tconf.ModelConfig(features=8, depth=4, state_depth=4, state_channels=2),
        source=tconf.SourceConfig(amplitude=10.0, location=(26, 16)),
        training=tconf.TrainingConfig(
            buffer_size=16, train_batch_size=B, unrolling_steps=3,
            learning_rate=3e-3, minimum_learning_rate=1e-4, **training,
        ),
    )



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are tiny: one intra-op thread is faster than a pool,
    and a pool per test worker oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def params():
    return load_params_npz(NPZ, tiny_config(), device="cpu")


@pytest.fixture(scope="module")
def maps():
    return make_dataset(8, N, seed=0)


def trainer(params, **kw):
    cfg = kw.pop("cfg", None) or tiny_config()
    return tloop.Trainer(cfg, params=params, device="cpu", **kw)


def test_device_buffer_first_step_matches_host(params, maps):
    MAXITER = 110  # keeps two of the four slots drawn, restarts two
    th_, td = trainer(params), trainer(params, device_buffer=True)
    th_.fill_buffer(maps)
    td.fill_buffer(maps)
    assert td.buffer is None and td._dev_buf["iteration"].dtype == torch.int32
    for key in FIELDS:
        np.testing.assert_array_equal(td._dev_buf[key].numpy(),
                                      getattr(th_.buffer, key), err_msg=key)
    idx = np.random.default_rng(7).choice(16, B, replace=False)
    host = th_.buffer
    batch = ExperienceBatch(
        *(torch.as_tensor(getattr(host, k)[idx]) for k in FIELDS),
        indices=idx,
    )
    mh, evolved = th_._train_step(batch, 1)
    zeros = torch.zeros(B, dtype=torch.long)
    md = td._mega_step(td._dev_buf, td.op, td.src_pool, td._sos_pool,
                       torch.as_tensor(idx), zeros, zeros, 1, MAXITER)
    assert float(md["loss"]) == pytest.approx(float(mh["loss"]), rel=1e-5)
    assert float(md["grad_norm"]) == pytest.approx(float(mh["grad_norm"]), rel=1e-5)
    # the gate: slot i starts at age 10 i (80, 100, 120 and 140 here); kept
    # iff res^2 < 1 and age + 2 < MAXITER
    ages = host.iteration[idx]
    keep = (evolved["res_sq_mean"].numpy() < 1.0) & (ages + 2 < MAXITER)
    assert keep.any() and (~keep).any(), ages
    assert int(md["restarts"]) == int((~keep).sum())
    buf = td._dev_buf
    np.testing.assert_array_equal(buf["iteration"][idx].numpy(),
                                  np.where(keep, ages + 2, 0))
    wf = evolved["wavefield"].numpy()
    got = buf["wavefield"][idx].numpy()
    np.testing.assert_allclose(got[keep], wf[keep], atol=1e-5 * np.abs(wf).max(), rtol=0)
    assert not got[~keep].any()  # fresh restarts start from a zero field
    np.testing.assert_array_equal(buf["k_sq"][idx][~keep].numpy(),
                                  ((1.0 / td._sos_pool[0]) ** 2).expand(
                                      int((~keep).sum()), N, N).numpy())


def test_sparse_source_pool_matches_dense(params, maps):
    cfgs = {sparse: tiny_config(p_random_source=1.0, sparse_source_pool=sparse)
            for sparse in (True, False)}
    ts, td = (trainer(params, cfg=cfgs[s], device_buffer=True) for s in (True, False))
    for t in (ts, td):
        t.fill_buffer(maps)
    assert ts.src_pool.ndim == 2 and ts.src_pool.shape[1] == 2
    assert ts.src_pool.shape[0] == td.src_pool.shape[0] > 10
    src_s, src_d = ts._dev_buf["source"], td._dev_buf["source"]
    torch.testing.assert_close(src_s, src_d, atol=3e-6 * 10.0, rtol=0)
    # p_random_source = 1: circle sources, not only the training source
    fixed = torch.as_tensor(td.source_map)
    assert bool(((src_d - fixed).abs().amax(dim=(1, 2, 3)) > 0).any())
    args = (torch.arange(B), torch.zeros(B, dtype=torch.long),
            torch.zeros(B, dtype=torch.long), 1, 50)
    ms = ts._mega_step(ts._dev_buf, ts.op, ts.src_pool, ts._sos_pool, *args)
    md = td._mega_step(td._dev_buf, td.op, td.src_pool, td._sos_pool, *args)
    assert float(ms["loss"]) == pytest.approx(float(md["loss"]), rel=1e-4)


def test_sparse_pool_rejects_extended_sources(params):
    cfg = tiny_config(p_extended_source=0.5, sparse_source_pool=True)
    with pytest.raises(ValueError, match="dense pool"):
        trainer(params, cfg=cfg, device_buffer=True)


def test_source_curriculum(params):
    """tests/test_training.py:183-213: the dense pool (training source,
    circle points, 256 segments), the sampled mix, and validation sources
    with a share of segments."""
    cfg = tiny_config(p_random_source=0.3, p_extended_source=0.4)
    t = trainer(params, cfg=cfg)
    n_pt = t._n_point_sources
    assert tuple(t.src_pool.shape) == (n_pt + 256, N, N, 2)
    np.testing.assert_array_equal(t.src_pool[0].numpy(), t.source_map)
    idx = t._sample_src_idx(4000)
    assert abs((idx >= n_pt).mean() - 0.4) < 0.05
    assert abs(((idx >= 1) & (idx < n_pt)).mean() - 0.3) < 0.05
    assert abs((idx == 0).mean() - 0.3) < 0.05
    src = trainer(params).make_val_sources(8, extended_frac=0.5)
    assert src.shape == (8, N, N, 2)
    amp = np.abs(src[..., 0])
    support = (amp > 0.5 * amp.max(axis=(1, 2), keepdims=True)).sum((1, 2))
    assert (support[:4] > 4).all() and (support[4:] <= 4).all(), support


def test_non_finite_epoch_loss_raises(params):
    t = trainer(params)
    with pytest.raises(FloatingPointError, match="non-finite"):
        t._finish_epoch([1.0, float("nan")], [1.0, 1.0], 0, 1, 0.0)
    assert t.epoch == 0


def test_fit_device_buffer_topk_prunes(params, maps, tmp_path):
    """tests/test_checkpoint_resume.py:68-80: fit() with val_every and top_k
    leaves at most k + 1 checkpoints; device epochs train and age."""
    t = trainer(params, device_buffer=True)
    hist = t.fit(maps, val_maps=maps[:2], num_epochs=4, val_every=1,
                 val_iterations=5, ckpt_dir=str(tmp_path), top_k=2)
    assert [h["maxiter"] for h in hist] == [1, 21, 41, 50]
    assert np.isfinite([h["train_loss_mean"] for h in hist]).all()
    assert all(np.isfinite(h["val_loss"]) for h in hist)
    assert int(t._dev_buf["iteration"].max()) >= 1
    kept = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert 1 <= len(kept) <= 3


def test_save_restore_roundtrip(params, maps, tmp_path):
    t1 = trainer(params)
    t1.fill_buffer(maps)
    t1.training_epoch(maps)
    t1.save(str(tmp_path))
    saved = {p: v.detach().clone() for p, v in th.iter_leaves(t1.params)}
    adam = copy.deepcopy(t1.optimizer.state_dict()["state"])
    t1.training_epoch(maps)  # t1 moves on

    t2 = trainer(params)
    assert t2.restore(str(tmp_path))
    assert (t2.epoch, t2.global_step) == (1, 2)
    for path, v in th.iter_leaves(t2.params):
        assert torch.equal(v, saved[path]), path
        assert v.requires_grad
    for i, st in t2.optimizer.state_dict()["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], adam[i][key]), (i, key)
    t2.fill_buffer(maps)
    assert np.isfinite(t2.training_epoch(maps)["train_loss_mean"])


def test_restore_empty_dir(params, tmp_path):
    assert not trainer(params).restore(str(tmp_path))


def test_topk_checkpointing(params, tmp_path):
    """tests/test_checkpoint_resume.py:38-66: keep the 2 best val_loss steps
    plus the latest, prune the rest; restore(best=True) takes the lowest
    val_loss with its scheduler state; a non-finite val_loss scores 1e30."""
    t = trainer(params)
    directory = str(tmp_path)
    for epoch, vl in [(1, 0.5), (2, 0.2), (3, 0.1), (4, 0.9), (5, 0.8)]:
        t.epoch = epoch
        t.scheduler.lr = 1e-3 / epoch
        t.save_topk(directory, vl, k=2)
    kept = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_"))
    assert kept == [2, 3, 5]
    assert tckpt.best_step(directory) == 3
    assert tckpt.latest_step(directory) == 5
    t2 = trainer(params)
    assert t2.restore(directory, best=True)
    assert t2.epoch == 3
    assert t2.scheduler.lr == 1e-3 / 3
    t.epoch = 6
    t.save_topk(directory, float("nan"), k=2)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["scores"]["6"] == 1e30 and manifest["last"] == 6
    assert sorted(manifest["scores"]) == ["2", "3", "6"]
    assert tckpt.manifest_extra(directory, 6)["lr"] == 1e-3 / 5


def test_params_npz_round_trip_into_jax(params, tmp_path, monkeypatch):
    """port -> save_params_npz -> the JAX package's load_params_npz gives the
    same leaves; the file equals the JAX export it came from. The JAX
    loader reads only the tree structure of its template
    (`arch.init_params`), so the template is traced abstractly
    (`jax.eval_shape`: the same tree) instead of drawn op by op."""
    arch = jget_architecture(JConfig().model.architecture)
    monkeypatch.setattr(arch, "init_params",
                        lambda key, cfg, _init=arch.init_params:
                        jax.eval_shape(lambda k: _init(k, cfg), key))
    path = str(tmp_path / "port.npz")
    moved = th.map_leaves(params, lambda _, t: t + 0.25)
    tckpt.save_params_npz(path, moved)
    jparams = jax.tree.map(np.asarray, jax_load_params_npz(path, JConfig()))
    back = from_jax_params(jparams, device="cpu")
    for (p, a), (q, b) in zip(th.iter_leaves(back), th.iter_leaves(moved)):
        assert p == q
        assert torch.equal(a, b), p
    tckpt.save_params_npz(path, params)
    with np.load(path) as got, np.load(NPZ) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pallas_mode_refused_before_anything_is_made(params, monkeypatch):
    def made(*a, **k):
        raise AssertionError("the trainer made something before refusing")

    for name in ("resolve_device", "make_operator", "make_optimizer", "ReplayBuffer"):
        monkeypatch.setattr(tloop, name, made)
    cfg = tiny_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, double_conv_mode="pallas"))
    with pytest.raises(ValueError, match="no backward") as err:
        tloop.Trainer(cfg, params=params, device="cpu")
    assert "JAX package cannot differentiate" in str(err.value)


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"sanitize": True}],
                         ids=["mesh", "sanitize"])
def test_unported_options_raise(params, kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        trainer(params, **kw)


def test_trainer_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.Trainer(tiny_config())


def test_cli_smoke(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "helmnet_tpu_torch.cli.train", "--smoke",
         "--device", "cpu", "--epochs", "3"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SMOKE PASS" in proc.stdout
    with open(tmp_path / "logs" / "train_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records if "train_loss_mean" in r] == [0, 1, 2]
    assert any("val_loss" in r for r in records)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flag", ["--platform", "--device"])
def test_cli_platform_is_another_name_for_device(monkeypatch, flag):
    """A command line written for the JAX CLI (`--platform cpu --smoke`)
    reaches the same Trainer device as the port's `--device cpu`; with no
    flag the device stays the port's default (None: cuda, raising without a
    card)."""
    from helmnet_tpu_torch.cli import train as train_cli

    seen = []

    def fake_trainer(cfg, log_dir=None, device=None):
        seen.append(device)
        raise _Stop

    monkeypatch.setattr(tloop, "Trainer", fake_trainer)
    with pytest.raises(_Stop):
        train_cli.main([flag, "cpu", "--smoke"])
    with pytest.raises(_Stop):
        train_cli.main(["--smoke"])
    assert seen == ["cpu", None]

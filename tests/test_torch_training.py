"""The training slice against the JAX package, on the CPU, at the JAX
package's `tiny_config` (tests/test_training.py:20: 32^2, full width,
buffer 16, batch 4, 3 unrolled steps). Both trainers start from the same
JAX params (the trained weights of trained_models/round1_best_epoch890.npz,
carried across by `weights.from_jax_params`) with fresh optimizer state;
the JAX side is computed once, in a module-scoped fixture.

Tolerances, from the JAX package's tests:
- BPTT through `n_steps` (2 steps, loss 1e4 * mean(residuals^2)): loss
  rel 1e-3, every grad leaf atol 2e-3 * max|ref| and rtol 2e-3
  (tests/test_parity.py:182-190);
- remat against no remat: loss rel 1e-6, updated params atol 1e-7
  (tests/test_training.py:229-252);
- the optimizer (3 steps on identical grads, the plateau scheduler
  lowering the lr between steps 2 and 3): updated params rtol 1e-6, with
  an atol of 1e-6 * max|ref| per leaf for the elements that cross zero
  (optax's f32 bias corrections 1 - b^t are off by up to 2.4e-7 relative,
  torch's are computed in f64);
- one train step: loss and rel_loss rel 1e-4, grad_norm rel 1e-3,
  evolved fields atol 1e-5 * max|ref|;
- two host-path epochs: per-epoch loss rtol 1e-3; new_sos, maxiter and
  the buffer's ages equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helmnet_tpu.data.ellipses import make_dataset
from helmnet_tpu.models import hybridnet as jh
from helmnet_tpu.models.registry import get_architecture as jget_architecture
from helmnet_tpu.solvers import iterative as jit_
from helmnet_tpu.train import loop as jloop
from helmnet_tpu.train.replay import ExperienceBatch as JBatch
from helmnet_tpu_torch.core import config as tconf
from helmnet_tpu_torch.models import hybridnet as th
from helmnet_tpu_torch.solvers import iterative as tit
from helmnet_tpu_torch.train import loop as tloop
from helmnet_tpu_torch.train.device_buffer import FIELDS
from helmnet_tpu_torch.train.replay import ExperienceBatch
from helmnet_tpu_torch.weights import from_jax_params
from tests.test_training import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "trained_models", "round1_best_epoch890.npz")
N, B, PICK = 32, 4, 1


def port_config(jcfg):
    """The port's Config with the same fields as a JAX Config."""
    return tconf.Config(
        max_iterations=jcfg.max_iterations,
        operator_mode=jcfg.operator_mode,
        geometry=tconf.GeometryConfig(**dataclasses.asdict(jcfg.geometry)),
        model=tconf.ModelConfig(**dataclasses.asdict(jcfg.model)),
        source=tconf.SourceConfig(**dataclasses.asdict(jcfg.source)),
        training=tconf.TrainingConfig(**dataclasses.asdict(jcfg.training)),
    )


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def trained_params(jcfg):
    """The JAX params tree of trained_models/round1_best_epoch890.npz
    (the tiny config's model is the default one), as numpy."""
    shapes = jax.eval_shape(lambda k: jh.init_params(k, jcfg.model),
                            jax.random.PRNGKey(0))
    treedef = jax.tree_util.tree_structure(shapes)
    with np.load(NPZ) as f:
        leaves = [f[f"p{i}"] for i in range(treedef.num_leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are tiny: one intra-op thread is faster than a pool,
    and a pool per test worker oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def ref():
    """The JAX side, computed once: params, a filled buffer, one train step
    on a fixed draw, the 2-step value_and_grad on it, and two epochs."""
    jcfg = tiny_config()
    params_np = trained_params(jcfg)
    params = jax.tree.map(jnp.asarray, params_np)
    maps = make_dataset(8, N, seed=0)
    jt = jloop.Trainer(jcfg, params=params)
    jt.fill_buffer(maps)
    filled = {k: getattr(jt.buffer, k).copy()
              for k in FIELDS}
    idx = np.random.default_rng(7).choice(jcfg.training.buffer_size, B, replace=False)
    batch = JBatch(**{k: v[idx] for k, v in filled.items()}, indices=idx)
    dev = JBatch(*[jnp.asarray(a) for a in batch])
    copy = jax.tree.map(jnp.copy, params)  # _train_step donates its params
    _, _, metrics, evolved = jt._train_step(copy, jt.optimizer.init(copy), jt.op,
                                            dev, PICK)

    arch = jget_architecture(jcfg.model.architecture)

    def loss_fn(p):
        carry = jit_.SolverCarry(dev.wavefield, dev.residual,
                                 arch.unflatten_states(dev.states, (N, N), jcfg.model))
        _, ys = jit_.n_steps(p, jt.op, dev.source, dev.k_sq, carry, cfg=jcfg,
                             num_steps=2)
        return 1e4 * jnp.mean(ys["residuals"] ** 2)

    loss2, grads2 = jax.value_and_grad(loss_fn)(params)
    epochs = [jt.training_epoch(maps) for _ in range(2)]
    return dict(
        cfg=port_config(jcfg), params=params_np, maps=maps, filled=filled,
        batch=batch, metrics=as_numpy(metrics), evolved=as_numpy(evolved),
        loss2=float(loss2), grads2=as_numpy(grads2), epochs=epochs,
        ages=jt.buffer.iteration.copy(),
    )


def port_trainer(ref, **kw):
    return tloop.Trainer(ref["cfg"], params=from_jax_params(ref["params"], device="cpu"),
                         device="cpu", **kw)


def port_batch(ref) -> ExperienceBatch:
    b = ref["batch"]
    return ExperienceBatch(*(torch.as_tensor(a) for a in b[:-1]), b.indices)


def test_n_steps_value_and_grad_match_jax(ref):
    cfg = ref["cfg"]
    params = th.map_leaves(from_jax_params(ref["params"], device="cpu"),
                           lambda _, t: t.requires_grad_(True))
    tt = tloop.Trainer(cfg, params=params, device="cpu")
    b = port_batch(ref)
    carry = tit.SolverCarry(b.wavefield, b.residual,
                            th.unflatten_states(b.states, (N, N), cfg.model))
    _, ys = tit.n_steps(params, tt.op, b.source, b.k_sq, carry, cfg=cfg, num_steps=2)
    assert ys["residuals"].shape == (2, B, N, N, 2)
    assert ys["states"].shape == (2,) + tuple(b.states.shape)
    loss = 1e4 * torch.mean(ys["residuals"] ** 2)
    leaves = [t for _, t in th.iter_leaves(params)]
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(ref["loss2"], rel=1e-3)
    refs = from_jax_params(ref["grads2"], device="cpu")
    n = 0
    for (path, r), g in zip(th.iter_leaves(refs), grads):
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, atol=2e-3 * scale, rtol=2e-3, msg=path)
        n += 1
    assert n == 88


def test_remat_matches_no_remat(ref):
    cfg = ref["cfg"]
    cfg_r = cfg.replace(training=dataclasses.replace(cfg.training, remat=True))
    t0 = port_trainer(ref)
    t1 = tloop.Trainer(cfg_r, params=from_jax_params(ref["params"], device="cpu"),
                       device="cpu")
    m0, _ = t0._train_step(port_batch(ref), PICK)
    m1, _ = t1._train_step(port_batch(ref), PICK)
    assert float(m1["loss"]) == pytest.approx(float(m0["loss"]), rel=1e-6)
    for (path, a), (_, b) in zip(th.iter_leaves(t0.params), th.iter_leaves(t1.params)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0, msg=path)


def test_train_step_matches_jax(ref):
    tt = port_trainer(ref)
    metrics, evolved = tt._train_step(port_batch(ref), PICK)
    m = ref["metrics"]
    assert float(metrics["loss"]) == pytest.approx(float(m["loss"]), rel=1e-4)
    assert float(metrics["rel_loss"]) == pytest.approx(float(m["rel_loss"]), rel=1e-4)
    assert float(metrics["grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=1e-3)
    for key in ("wavefield", "states", "residual", "res_sq_mean"):
        r = ref["evolved"][key]
        np.testing.assert_allclose(evolved[key].numpy(), r,
                                   atol=1e-5 * np.abs(r).max(), rtol=0, err_msg=key)
    # every leaf was updated: a grad reached each one
    for path, leaf in th.iter_leaves(tt.params):
        assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all()), path


def test_two_host_epochs_match_jax_trainer(ref):
    tt = port_trainer(ref)
    tt.fill_buffer(ref["maps"])
    for key, r in ref["filled"].items():
        got = getattr(tt.buffer, key)
        np.testing.assert_allclose(got, r, atol=1e-6 * max(np.abs(r).max(), 1),
                                   rtol=0, err_msg=key)
    stats = [tt.training_epoch(ref["maps"]) for _ in range(2)]
    for got, want in zip(stats, ref["epochs"]):
        assert got["train_loss_mean"] == pytest.approx(want["train_loss_mean"], rel=1e-3)
        for key in ("epoch", "maxiter", "new_sos", "lr", "global_step"):
            assert got[key] == want[key], key
    assert [s["maxiter"] for s in stats] == [1, 21]
    np.testing.assert_array_equal(tt.buffer.iteration, ref["ages"])
    assert np.isfinite(tt.buffer.wavefield).all()


def test_optimizer_and_plateau_match_optax(ref):
    """Identical grads (some beyond the clip) into the port's Adam and the
    JAX package's optax chain for 3 steps; the plateau scheduler halves the
    lr between steps 2 and 3."""
    jcfg = tiny_config()
    cfg = ref["cfg"]
    jparams = jax.tree.map(jnp.asarray, ref["params"])
    opt = jloop.make_optimizer(jcfg)
    state = opt.init(jparams)
    update = jax.jit(opt.update)
    tparams = th.map_leaves(from_jax_params(ref["params"], device="cpu"),
                            lambda _, t: t.requires_grad_(True))
    topt = tloop.make_optimizer(cfg, tparams)
    sched_j = jloop.PlateauScheduler(cfg.training.learning_rate, 0.5, 0, 1e-5)
    sched_t = tloop.PlateauScheduler(cfg.training.learning_rate, 0.5, 0, 1e-5)
    rng = np.random.default_rng(3)
    for step, metric in enumerate((1.0, 2.0, None)):
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.8).astype(np.float32), ref["params"])
        updates, state = update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = from_jax_params(grads, device="cpu")
        for (_, leaf), (_, g) in zip(th.iter_leaves(tparams), th.iter_leaves(tgrads)):
            leaf.grad = g
        norm = tloop.apply_gradients(topt, cfg.training.gradient_clip)
        assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-5)
        if metric is not None:
            lr = sched_j.step(metric)
            assert sched_t.step(metric) == lr
            state.hyperparams["learning_rate"] = jnp.asarray(lr)
            tloop.set_learning_rate(topt, lr)
    assert sched_t.lr == cfg.training.learning_rate / 2
    want = from_jax_params(as_numpy(jparams), device="cpu")
    for (path, a), (_, b) in zip(th.iter_leaves(tparams), th.iter_leaves(want)):
        torch.testing.assert_close(a.detach(), b, rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()), msg=path)


@pytest.mark.parametrize("mod", [tloop, jloop], ids=["port", "jax"])
def test_plateau_scheduler_cases(mod):
    """tests/test_training.py:62-70, for both packages."""
    s = mod.PlateauScheduler(1e-3, 0.5, patience=2, min_lr=1e-4)
    assert s.step(1.0) == 1e-3  # improvement
    for _ in range(2):
        assert s.step(2.0) == 1e-3  # within patience
    assert s.step(2.0) == 5e-4  # exceeded patience -> halved
    for _ in range(10):
        s.step(2.0)
    assert s.lr == 1e-4  # floored at min_lr


@pytest.mark.parametrize("args,kw,want", [
    ((0, 1000), {}, 1000),
    ((400, 1000), {}, 1000),
    ((950, 1000), {"warm_started": True}, 1950),
    ((950, 1000), {"epoch_budget": 300}, 1250),
    ((950, 1000), {"warm_started": True, "epoch_budget": 300}, 1250),
])
def test_resolve_epoch_cap_cases(args, kw, want):
    """tests/test_training.py:73-102, for both packages."""
    assert tloop.resolve_epoch_cap(*args, **kw) == want
    assert jloop.resolve_epoch_cap(*args, **kw) == want

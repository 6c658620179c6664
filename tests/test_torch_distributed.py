"""The port's distribution on gloo ranks of this CPU against the JAX
package's sharded functions on the conftest's 8 virtual CPU devices, from
the same numpy-seeded inputs.

The port's side runs in processes started with torch.multiprocessing
(tests/torch_dist_workers.py, no JAX there): once on 4 ranks for the
operators and a data=4 trainer, once on 2 for a data=2 trainer. Each rank
computes its shard; rank 0 gathers (`multihost.fetch_global`) and writes
the global results. Tolerances, from the JAX package's tests:
- the halo stencil residual atol 1e-5, its norm rtol 1e-6
  (tests/test_stencil_distributed.py:81, 89);
- the slab FFT Laplacian and residual atol 2e-4 (:126, :137);
- the z-slab residual, every method, atol 1e-5 * max|ref|, its norm rtol
  1e-6 (tests/test_slab3d.py:52, 60);
- a data-parallel train step against the single-process port Trainer: the
  loss rel 1e-5, the updated params atol 1e-6 and the evolved wavefield
  atol 1e-5 (tests/test_sharded_training.py:55-63); one epoch: the loss
  rel 1e-5 and the written-back wavefield atol 1e-5, the ages equal;
- against JAX's `Trainer(mesh=make_mesh(ParallelConfig(data=2)))`: the
  step's loss and rel_loss rel 1e-4, grad norm rel 1e-3 and evolved fields
  atol 1e-5 * max|ref| (the port's single-process bounds against JAX,
  tests/test_torch_training.py), the epoch's loss rtol 1e-3 and
  written-back wavefield atol 1e-5.
A two-process `cli/train --multihost` run ends as JAX's
tests/test_multihost.py's does, and only rank 0 writes its checkpoint.

The spatial partition (distributed/spatial.py) runs in the same 4 ranks:
- every conv kind through `spatial=` on the (1, 2, 2), (1, 4, 1) and
  (1, 1, 4) meshes, at tiles down to one row (halos wider than a tile),
  against the one-process conv: output and gradients to 1e-5 of the
  reference's largest value (f32 sums in another order);
- a (data=1, y=2, x=2) train step and epoch against the single-process
  port Trainer with the data-parallel bounds above, and against JAX's
  `Trainer(mesh=make_mesh(ParallelConfig(1, 2, 2), devices[:4]))` with
  the bounds held against JAX's data=2 mesh;
- a 4-step rollout on that mesh against the single-process rollout
  (wavefield atol 1e-5 * max|ref|, rmse rtol 1e-5).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from helmnet_tpu.core.config import ParallelConfig as JParallel
from helmnet_tpu.core.meshes import make_mesh as jmake_mesh
from helmnet_tpu.core.meshes import make_mesh3d as jmake_mesh3d
from helmnet_tpu.data.ellipses import make_dataset
from helmnet_tpu.distributed import dfft as jdfft
from helmnet_tpu.distributed import halo as jhalo
from helmnet_tpu.distributed import slab3d as jslab
from helmnet_tpu.ops.spectral import make_operator as jmake_operator
from helmnet_tpu.ops.spectral3d import make_operator3d as jmake_operator3d
from helmnet_tpu.ops.stencil import make_stencil_operator as jmake_stencil
from helmnet_tpu.train import loop as jloop
from helmnet_tpu.train.replay import ExperienceBatch as JBatch
from helmnet_tpu_torch.core.config import ParallelConfig
from helmnet_tpu_torch.core.meshes import (Mesh, Sharding, data_sharding, make_mesh,
                                           replicated, shard_batch, spatial_sharding)
from helmnet_tpu_torch.distributed import multihost
from tests import torch_dist_workers as workers
from tests.test_torch_training import port_config, trained_params
from tests.test_training import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("wavefield", "states", "k_sq", "residual", "source", "iteration")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every input of both sides, made from numpy seeds, and the npz the
    ranks read them from."""
    n, f32 = 32, np.float32
    inp = {
        "halo_u": _rng(1).standard_normal((4, n, n, 2)).astype(f32),
        "halo_k": _rng(101).uniform(0.5, 1.2, (4, n, n)).astype(f32),
        "halo_s": _rng(102).standard_normal((4, n, n, 2)).astype(f32),
        "norm_res": _rng(2).standard_normal((4, n, n, 2)).astype(f32),
        "fft_u": _rng(5).standard_normal((4, 64, 64, 2)).astype(f32),
        "fft_k": _rng(105).uniform(0.5, 1.2, (4, 64, 64)).astype(f32),
        "fft_s": _rng(106).standard_normal((4, 64, 64, 2)).astype(f32),
        "slab_u": _rng(11).standard_normal((2, 24, 24, 24, 2)).astype(f32),
        "slab_k": _rng(111).uniform(0.5, 1.2, (2, 24, 24, 24)).astype(f32),
        "slab_s": _rng(112).standard_normal((2, 24, 24, 24, 2)).astype(f32),
        "slab_norm_res": _rng(12).standard_normal((2, 16, 16, 16, 2)).astype(f32),
        "maps": make_dataset(8, n, seed=0),
        "rollout_maps": make_dataset(4, n, seed=4),
        "rollout_source": _rng(8).standard_normal((4, n, n, 2)).astype(f32),
    }
    # the train step's batch: a fixed draw of a buffer filled by JAX's
    # Trainer (the port's fills the same, tests/test_torch_training.py)
    jcfg = tiny_config()
    jt = jloop.Trainer(jcfg, params=jax.tree.map(jnp.asarray, trained_params(jcfg)))
    jt.fill_buffer(inp["maps"])
    idx = _rng(7).choice(jcfg.training.buffer_size, 4, replace=False)
    for k in FIELDS:
        inp[f"batch_{k}"] = getattr(jt.buffer, k)[idx].copy()
    inp["batch_indices"] = idx
    path = str(tmp_path_factory.mktemp("dist") / "inputs.npz")
    np.savez(path, **inp)
    return inp, path


def _spawn(task, world, inputs, tmp_path_factory):
    out = str(tmp_path_factory.mktemp(task) / "out.npz")
    workers.spawn(task, world, inputs[1], out)
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def ops(inputs, tmp_path_factory):
    return _spawn("ops", 4, inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def train2(inputs, tmp_path_factory):
    return _spawn("train", 2, inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def port_single(inputs):
    torch.set_num_threads(1)
    return workers.train_results(None, inputs[0])


def _jax_mesh_run(inp, mesh):
    """JAX's Trainer on `mesh` of the virtual devices: the step on the
    stored batch and one epoch from a filled buffer."""
    jcfg = tiny_config()
    params = trained_params(jcfg)
    jt = jloop.Trainer(jcfg, params=jax.tree.map(jnp.asarray, params), mesh=mesh)
    batch = JBatch(*(jnp.asarray(inp[f"batch_{k}"]) for k in FIELDS),
                   jnp.asarray(inp["batch_indices"]))
    copy = jax.tree.map(jnp.asarray, params)  # _train_step donates its params
    _, _, metrics, evolved = jt._train_step(
        copy, jt.optimizer.init(copy), jt.op, jloop.shard_experience(mesh, batch),
        workers.PICK)
    je = jloop.Trainer(jcfg, params=jax.tree.map(jnp.asarray, params), mesh=mesh)
    je.fill_buffer(inp["maps"])
    stats = je.training_epoch(inp["maps"])
    return {
        "loss": float(metrics["loss"]), "rel_loss": float(metrics["rel_loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "wavefield": np.asarray(evolved["wavefield"]),
        "residual": np.asarray(evolved["residual"]),
        "epoch_loss": stats["train_loss_mean"],
        "epoch_wavefield": je.buffer.wavefield.copy(),
        "epoch_iteration": je.buffer.iteration.copy(),
    }


@pytest.fixture(scope="module")
def jax_data2(inputs):
    return _jax_mesh_run(inputs[0], jmake_mesh(JParallel(data=2)))


@pytest.fixture(scope="module")
def jax_spatial(inputs):
    return _jax_mesh_run(inputs[0], jmake_mesh(JParallel(data=1, y=2, x=2),
                                               devices=jax.devices()[:4]))


def _global(arr, mesh, spec):
    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P(*spec)))


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


def test_halo_stencil_residual_matches_jax(ops, inputs):
    inp = inputs[0]
    mesh = jmake_mesh(JParallel(data=2, y=2, x=2))
    st = jmake_stencil(32, 32, 4, 2.0, 1.0, order=4)
    res = jhalo.make_sharded_stencil_residual(mesh, st)
    ref = np.asarray(res(*jhalo.spatial_put(
        mesh, tuple(jnp.asarray(inp[k]) for k in ("halo_u", "halo_k", "halo_s")))))
    np.testing.assert_allclose(ops["halo_residual"], ref, atol=1e-5)


def test_halo_norm_matches_jax(ops, inputs):
    mesh = jmake_mesh(JParallel(data=2, y=2, x=2))
    norm = jhalo.make_sharded_residual_norm(mesh)
    ref = np.asarray(norm(jhalo.spatial_put(mesh, jnp.asarray(inputs[0]["norm_res"]))))
    np.testing.assert_allclose(ops["halo_norm"], ref, rtol=1e-6)


def test_slab_fft_matches_jax(ops, inputs):
    inp = inputs[0]
    mesh = jmake_mesh(JParallel(data=2, y=4, x=1))
    op = jmake_operator(64, 64, 8, 2.0, 1.0)
    u = _global(inp["fft_u"], mesh, ("data", "y", None, None))
    lap = np.asarray(jdfft.make_sharded_laplacian_fft(mesh, op)(u))
    np.testing.assert_allclose(ops["fft_laplacian"], lap, atol=2e-4)
    res = np.asarray(jdfft.make_sharded_residual_fft(mesh, op)(
        u, _global(inp["fft_k"], mesh, ("data", "y", None)),
        _global(inp["fft_s"], mesh, ("data", "y", None, None))))
    np.testing.assert_allclose(ops["fft_residual"], res, atol=2e-4)


@pytest.mark.parametrize("method", ["transpose", "scatter", "overlap"])
def test_slab3d_matches_jax(ops, inputs, method):
    inp = inputs[0]
    mesh = jmake_mesh3d(data=2, z=4)
    op = jmake_operator3d(24, 24, 24, 4, 2.0, 1.0)
    args = jslab.slab_put(mesh, tuple(jnp.asarray(inp[k])
                                      for k in ("slab_u", "slab_k", "slab_s")))
    ref = np.asarray(jslab.make_sharded_residual3d(mesh, op, method=method)(*args))
    np.testing.assert_allclose(ops[f"slab_{method}"], ref,
                               atol=1e-5 * np.abs(ref).max())


def test_slab3d_norm_matches_jax(ops, inputs):
    mesh = jmake_mesh3d(data=2, z=4)
    norm = jslab.make_sharded_residual_norm3d(mesh)
    ref = np.asarray(norm(jslab.slab_put(mesh, jnp.asarray(inputs[0]["slab_norm_res"]))))
    np.testing.assert_allclose(ops["slab_norm"], ref, rtol=1e-6)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_data_axis_must_divide_by_the_host_count(ops):
    assert "must be divisible by the process count (4 hosts)" in str(ops["host_check"])


def test_single_process_mesh():
    """Without a process group the mesh is this process: one rank, no
    groups, every sharding the whole tensor; a larger mesh raises, as the
    JAX package's does."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "y": 1, "x": 1} and mesh.groups == (None,) * 3
    t = torch.arange(24.0).reshape(2, 3, 4)
    for s in (data_sharding(mesh), spatial_sharding(mesh), replicated(mesh)):
        assert torch.equal(s(t), t)
        np.testing.assert_array_equal(multihost.fetch_global(s(t), s), t.numpy())
    assert torch.equal(shard_batch(mesh, {"a": t})["a"], t)
    assert shard_batch(None, t) is t
    assert multihost.is_primary() and multihost.process_count() == 1
    multihost.barrier()  # a no-op for one process
    with pytest.raises(ValueError, match="mesh needs 2 devices, only 1 available"):
        make_mesh(ParallelConfig(data=2), device="cpu")


def test_mesh_layout_and_shards():
    """Rank r of a (2, 2, 3) mesh sits at its row-major coordinates; a
    sharding takes its block of each split dimension."""
    mesh = Mesh(("data", "y", "x"), (2, 2, 3), 9, (None,) * 3, torch.device("cpu"))
    assert mesh.coords() == (1, 1, 0) and mesh.index("x") == 0
    assert mesh.rank_at((1, 1, 0)) == 9
    assert mesh.neighbor("x", -1) == 11 and mesh.neighbor("y", 1) == 6
    t = torch.arange(4 * 6 * 9).reshape(4, 6, 9)
    got = Sharding(mesh, ("data", "y", "x"))(t)
    assert torch.equal(got, t[2:4, 3:6, 0:3])
    with pytest.raises(ValueError, match="not divisible"):
        Sharding(mesh, ("x",))(t[:2])


# ---------------------------------------------------------------------------
# data-parallel training
# ---------------------------------------------------------------------------


def test_worker_config_is_the_tiny_config():
    assert workers.tiny_config() == port_config(tiny_config())


def _run(results, prefix):
    return {k[len(prefix):]: v for k, v in results.items() if k.startswith(prefix)}


def _step_matches(got, one, ref):
    assert float(got["step_loss"]) == pytest.approx(one["step_loss"], rel=1e-5)
    np.testing.assert_allclose(got["step_outc_b"], one["step_outc_b"], atol=1e-6)
    np.testing.assert_allclose(got["step_wavefield"], one["step_wavefield"], atol=1e-5)
    assert float(got["step_loss"]) == pytest.approx(ref["loss"], rel=1e-4)
    assert float(got["step_rel_loss"]) == pytest.approx(ref["rel_loss"], rel=1e-4)
    assert float(got["step_grad_norm"]) == pytest.approx(ref["grad_norm"], rel=1e-3)
    for key in ("wavefield", "residual"):
        np.testing.assert_allclose(got[f"step_{key}"], ref[key],
                                   atol=1e-5 * np.abs(ref[key]).max(), err_msg=key)


def _epoch_matches(got, one, ref):
    assert float(got["epoch_loss"]) == pytest.approx(one["epoch_loss"], rel=1e-5)
    assert int(got["epoch_new_sos"]) == one["epoch_new_sos"]
    np.testing.assert_array_equal(got["epoch_iteration"], one["epoch_iteration"])
    np.testing.assert_allclose(got["epoch_wavefield"], one["epoch_wavefield"], atol=1e-5)
    assert float(got["epoch_loss"]) == pytest.approx(ref["epoch_loss"], rel=1e-3)
    np.testing.assert_array_equal(got["epoch_iteration"], ref["epoch_iteration"])
    np.testing.assert_allclose(got["epoch_wavefield"], ref["epoch_wavefield"], atol=1e-5)


@pytest.mark.parametrize("data", [2, 4])
def test_data_parallel_step_matches(data, ops, train2, port_single, jax_data2):
    _step_matches(_run(ops if data == 4 else train2, f"data{data}_"), port_single,
                  jax_data2)


@pytest.mark.parametrize("data", [2, 4])
def test_data_parallel_epoch_matches(data, ops, train2, port_single, jax_data2):
    _epoch_matches(_run(ops if data == 4 else train2, f"data{data}_"), port_single,
                   jax_data2)


# ---------------------------------------------------------------------------
# the spatial partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1x2x2", "1x4x1", "1x1x4"])
@pytest.mark.parametrize("kind", [k[0] for k in workers.CONV_KINDS])
def test_halo_pad_matches_one_process_conv(kind, mesh, ops):
    """Output, input gradient and weight gradient (columns) of each tile
    size (rows), down to one-row tiles whose halos span several tiles."""
    errs = ops[f"halo_{kind}_{mesh}"]
    assert errs.shape[1] == 4 and np.all(errs < 1e-5), errs


def test_spatial_step_matches(ops, port_single, jax_spatial):
    _step_matches(_run(ops, "spatial_"), port_single, jax_spatial)


def test_spatial_epoch_matches(ops, port_single, jax_spatial):
    _epoch_matches(_run(ops, "spatial_"), port_single, jax_spatial)


def test_spatial_rollout_matches(ops, inputs):
    from helmnet_tpu_torch.ops.spectral import make_operator
    from helmnet_tpu_torch.solvers.iterative import rollout
    from helmnet_tpu_torch.weights import load_params_npz

    inp, cfg = inputs[0], workers.tiny_config()
    g = cfg.geometry
    op = make_operator(g.domain_size, g.domain_size, g.pml_size, g.sigma_max,
                       cfg.k0, device="cpu")
    ref = rollout(load_params_npz(workers.NPZ, cfg, device="cpu"), op,
                  inp["rollout_source"], inp["rollout_maps"], cfg=cfg,
                  num_iterations=4, device="cpu")
    want = ref["wavefield"].numpy()
    np.testing.assert_allclose(ops["rollout_wavefield"], want,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(ops["rollout_rmse"], ref["rmse"].numpy(), rtol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_multihost_two_processes(tmp_path):
    """Two processes of `cli/train --multihost` form one gloo group of two
    ranks (data=2), train the same run (equal losses on both), and rank 0
    alone writes the log and the checkpoint."""
    np.savez(tmp_path / "maps.npz", maps=make_dataset(8, 32, seed=3))
    cfg = port_config(tiny_config()).to_json()
    cfg["medium"]["train_set"] = cfg["medium"]["validation_set"] = str(tmp_path / "maps.npz")
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "helmnet_tpu_torch.cli.train", "--parameters",
             str(tmp_path / "cfg.json"), "--device", "cpu", "--epochs", "2",
             "--val-every", "1", "--val-iterations", "5",
             "--log-dir", str(tmp_path / f"logs{pid}"),
             "--ckpt-dir", str(tmp_path / f"ckpt{pid}"), "--multihost",
             "--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--process-id", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
    losses = [[line.split()[3] for line in out.splitlines() if line.startswith("epoch")]
              for out in outs]
    assert len(losses[0]) == 2 and losses[0] == losses[1], outs
    assert "mesh: {'data': 2, 'y': 1, 'x': 1} on 2 ranks (gloo)" in outs[0]
    from helmnet_tpu_torch.train.checkpoint import latest_step

    assert latest_step(str(tmp_path / "ckpt0")) == 2
    assert not (tmp_path / "ckpt1").exists() or not any((tmp_path / "ckpt1").iterdir())
    assert (tmp_path / "logs0" / "train_log.jsonl").exists()
    assert not (tmp_path / "logs1").exists()


def _fake_mesh(sizes):
    """Rank 0 of a mesh of `sizes` with no process group: enough for every
    check made before a step."""
    return Mesh(("data", "y", "x"), sizes, 0, (None,) * 3, torch.device("cpu"))


def test_spatial_rollout_refuses_pallas_mode():
    """K1 pads each tile with zeros inside the kernel, so 'pallas' mode
    refuses a spatial partition."""
    from helmnet_tpu_torch.distributed.spatial import Spatial
    from helmnet_tpu_torch.models import hybridnet as th
    from helmnet_tpu_torch.weights import load_params_npz

    cfg = workers.tiny_config()
    model = dataclasses.replace(cfg.model, double_conv_mode="pallas",
                                precision="default")
    sp = Spatial(_fake_mesh((1, 2, 1)), 32, 32, 4)
    x = torch.zeros((1, 16, 32, model.in_channels))
    states = th.init_states(1, (16, 32), model)
    with pytest.raises(ValueError, match="cannot run on a grid split"):
        th.apply(load_params_npz(workers.NPZ, cfg, device="cpu"), x, states,
                 cfg=model, spatial=sp)


def test_dryrun_two_ranks():
    """`python -m helmnet_tpu_torch.dryrun --ranks 2` (two gloo ranks on
    this CPU) prints every OK line of the JAX package's dry run."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "helmnet_tpu_torch.dryrun", "--ranks", "2"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for line in ("entry() run OK: [(1, 96, 96, 2), (1, 96, 96, 2)]",
                 "[dryrun] mesh {'data': 1, 'y': 2, 'x': 1} on 2 ranks (cpu)",
                 "[dryrun] sharded train_step OK", "[dryrun] halo-exchange stencil "
                 "residual OK", "[dryrun] distributed slab-FFT laplacian OK",
                 "[dryrun] sharded rollout OK", "[dryrun] 3D z-slab residual OK",
                 "[dryrun] 3D z-slab OVERLAP residual OK", "dryrun_multichip OK"):
        assert line in proc.stdout, (line, proc.stdout)

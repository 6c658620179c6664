"""The spatial partition (distributed/spatial.py) where the JAX package's
GSPMD runs what the partition once refused: the fft operator on tiles,
the resnet, UNet levels that do not split evenly, and GMRES on a split
grid. The port runs on 4 gloo ranks of this CPU (tests/torch_dist_workers.py,
task "spatial", started in a thread so that the JAX side and the
one-process references run meanwhile); the JAX package runs its mesh
`Trainer` on 4 of the conftest's virtual devices. Every input is made from
numpy seeds. Bounds:
- the fft Laplacian on tiles against the one-process `laplacian_fft`, on
  the (1, 2, 2), (1, 4, 1) and (1, 1, 4) meshes at a grid whose pencils
  split (all-to-all) and one whose do not (all-gather): value atol 2e-4
  (tests/test_stencil_distributed.py:126), input gradient 1e-5 of the
  reference's largest value (the halo tests' bound);
- a train step and an epoch with the fft operator and with the resnet on
  (1, 2, 2), and with the tiny config on (1, 4, 1), whose 2-row level 4
  does not split over y = 4: tests/test_torch_distributed.py's
  `_step_matches` / `_epoch_matches` against the one-process port and
  JAX's mesh `Trainer`, and the evolved states atol 1e-5 * max|ref|
  against both;
- at 48^2 on (1, 4, 1), where the state of level 3 is whole along y, the
  same against the one-process port;
- GMRES on tests/test_stencil_distributed.py:148-158's 64^2 problem on
  (1, 2, 2), restart 60, 15 restarts, tol 1e-6, with the matmul, the fft
  and the order-4 stencil operator, against the one-process port and
  (spectral operators) JAX's `solve_helmholtz`: the final residual at
  most 10x the reference's and 1e-2 of the initial one, x within atol
  3e-2 * max|ref| (that test's bounds). The split solve orthogonalises
  by CGS2, the unsplit ones by MGS: their trajectories differ in
  rounding, as the JAX test's sharded one does;
- the CSLP inverse on tiles (`make_shifted_laplace_inverse(...,
  spatial=)`) on the three meshes, at a grid whose pencils split and one
  whose do not, with kref 'mean' and 'max', on the 64^2 problem's medium
  and its twin with a fast block: the gathered result against the
  one-process port's inverse and JAX's on the whole grid, atol 1e-5 *
  max|ref|, and each rank's kref^2 against the grid's mean (float64) or
  max, rtol 1e-6, and JAX's, whose f32 mean is itself about 1.45e-6 off
  the exact one. The media are chosen so that a tile-local kref fails
  (checked);
- GMRES with the CSLP preconditioner on the 64^2 problem on (1, 2, 2),
  restart 30, 5 restarts, with the matmul and the fft operator: the
  bounds above against the one-process port and JAX's `solve_helmholtz`,
  and every cycle's residual within a factor 2 of the one-process run's.
  A right preconditioner changes the rate, not the solution, so the
  inverse cases above are what hold the preconditioner itself.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.core.config import ParallelConfig as JParallel
from helmnet_tpu.core.meshes import make_mesh as jmake_mesh
from helmnet_tpu.data.ellipses import make_dataset
from helmnet_tpu.models import resnet as jres
from helmnet_tpu.ops.spectral import make_operator as jmake_operator
from helmnet_tpu.solvers import gmres as jgmres
from helmnet_tpu.solvers import precond as jprecond
from helmnet_tpu.train import loop as jloop
from helmnet_tpu.train.checkpoint import save_params_npz
from helmnet_tpu.train.replay import ExperienceBatch as JBatch
from helmnet_tpu_torch.distributed.spatial import Spatial
from helmnet_tpu_torch.ops.spectral import make_operator
from helmnet_tpu_torch.solvers.precond import make_shifted_laplace_inverse
from helmnet_tpu_torch.train import loop as tloop
from tests import torch_dist_workers as workers
from tests.test_torch_distributed import (FIELDS, _epoch_matches, _fake_mesh, _run,
                                          _step_matches)
from tests.test_torch_training import port_config, trained_params
from tests.test_training import tiny_config

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")

MESHES = dict(workers.SPATIAL_TRAIN)
JAX_CASES = ("fft", "resnet", "uneven")  # held against JAX's mesh Trainer too


def _rng(seed):
    return np.random.default_rng(seed)


def _resnet_params(jcfg):
    """A seeded resnet params tree (JAX layout, numpy): JAX's init with
    every leaf but the PReLU slopes redrawn from a seeded normal."""
    tree = jres.init_params(jax.random.PRNGKey(0), jcfg.model)
    rng = _rng(3)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) if "act" in jax.tree_util.keystr(p)
        else (0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)


def _jax_batch(jcfg, params, maps, inp, key):
    """A fixed draw of 4 experiences of a buffer filled by JAX's Trainer,
    into `inp` under `key`."""
    jt = jloop.Trainer(jcfg, params=jax.tree.map(jnp.asarray, params))
    jt.fill_buffer(maps)
    idx = _rng(7).choice(jcfg.training.buffer_size, 4, replace=False)
    for k in FIELDS:
        inp[f"{key}_{k}"] = getattr(jt.buffer, k)[idx].copy()
    inp[f"{key}_indices"] = idx


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every input of both sides and the npz the ranks read them from;
    (inputs, path, the JAX params of each case)."""
    tmp = tmp_path_factory.mktemp("spatial_cases")
    base = tiny_config()
    inp = {"maps": make_dataset(8, 32, seed=0),
           "uneven48_maps": make_dataset(8, 48, seed=1)}
    params = {case: trained_params(base) for case in MESHES}
    params["resnet"] = _resnet_params(workers.case_config(base, "resnet"))
    inp["resnet_params_npz"] = str(tmp / "resnet.npz")
    save_params_npz(inp["resnet_params_npz"], params["resnet"])
    _jax_batch(base, params["uneven"], inp["maps"], inp, "batch")
    _jax_batch(workers.case_config(base, "resnet"), params["resnet"], inp["maps"], inp,
               "resnet_batch")
    _jax_batch(workers.case_config(base, "uneven48"), params["uneven48"],
               inp["uneven48_maps"], inp, "uneven48_batch")
    path = str(tmp / "inputs.npz")
    np.savez(path, **inp)
    return inp, path, params


@pytest.fixture(scope="module")
def started(inputs, tmp_path_factory):
    """The 4 ranks, running in a thread from here on."""
    out = str(tmp_path_factory.mktemp("spatial_ranks") / "out.npz")
    box = {}

    def run():
        try:
            workers.spawn("spatial", 4, inputs[1], out)
        except Exception as e:  # re-raised by `ops`
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, box, out


def _jax_run(inp, case, params):
    """JAX's Trainer on the case's mesh of 4 virtual devices: the step on
    the stored batch and one epoch from a filled buffer."""
    jcfg = workers.case_config(tiny_config(), case)
    mesh = jmake_mesh(JParallel(*MESHES[case]), devices=jax.devices()[:4])
    key = "resnet_batch" if case == "resnet" else "batch"
    jt = jloop.Trainer(jcfg, params=jax.tree.map(jnp.asarray, params), mesh=mesh)
    batch = JBatch(*(jnp.asarray(inp[f"{key}_{k}"]) for k in FIELDS),
                   jnp.asarray(inp[f"{key}_indices"]))
    copy = jax.tree.map(jnp.asarray, params)  # _train_step donates its params
    _, _, metrics, evolved = jt._train_step(
        copy, jt.optimizer.init(copy), jt.op, jloop.shard_experience(mesh, batch),
        workers.PICK)
    # the step above left jt's own params and state alone: its epoch
    # reuses the compiled step
    jt.fill_buffer(inp["maps"])
    stats = jt.training_epoch(inp["maps"])
    return {
        "loss": float(metrics["loss"]), "rel_loss": float(metrics["rel_loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "wavefield": np.asarray(evolved["wavefield"]),
        "residual": np.asarray(evolved["residual"]),
        "states": np.asarray(evolved["states"]),
        "epoch_loss": stats["train_loss_mean"],
        "epoch_wavefield": jt.buffer.wavefield.copy(),
        "epoch_iteration": jt.buffer.iteration.copy(),
    }


def _jax_gmres(mode, precond="none"):
    _, k_sq, src = workers.gmres_problem()
    n = workers.GMRES_N
    restart, cycles = workers.GMRES_RUNS[precond]
    res = jgmres.solve_helmholtz(jmake_operator(n, n, 8, 2.0, 1.0), jnp.asarray(k_sq),
                                 jnp.asarray(src), mode=mode, restart=restart,
                                 max_restarts=cycles, tol=1e-6, precond=precond)
    return np.asarray(res.x), np.asarray(res.residual_norms)


@pytest.fixture(scope="module")
def refs(inputs, started):
    """The JAX runs and the one-process port runs, made while the ranks
    run: {"jax": {case: run}, "one": {case: run}, "jax_gmres": {mode:
    (x, norms)}, "one_gmres": {mode: (x, norms)}}, and the same for the
    CSLP solves under "jax_cslp" and "one_cslp"."""
    inp, _, params = inputs
    out = {"jax": {case: _jax_run(inp, case, params[case]) for case in JAX_CASES},
           "jax_gmres": {mode: _jax_gmres(mode) for mode in ("matmul", "fft")},
           "jax_cslp": {mode: _jax_gmres(mode, "shifted_laplace")
                        for mode in workers.CSLP_MODES}}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out["one"] = {case: workers.train_results(None, inp, case) for case in MESHES}
        out["one_gmres"] = {mode: workers.gmres_solve(mode)
                            for mode in workers.GMRES_MODES}
        out["one_cslp"] = {mode: workers.gmres_solve(mode, precond="shifted_laplace")
                           for mode in workers.CSLP_MODES}
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def ops(started, refs):
    """The ranks' gathered results, once they end."""
    thread, box, out = started
    thread.join(timeout=900)
    assert not thread.is_alive(), "the gloo ranks did not finish in 900 s"
    if "error" in box:
        raise box["error"]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def _states_match(got, want):
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the fft operator on tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1x2x2", "1x4x1", "1x1x4"])
def test_fft_laplacian_on_tiles(mesh, ops):
    """Rows: the grid whose pencils split, then the one whose do not;
    columns: value max|err|, input-gradient max|err| / max|ref|."""
    errs = ops[f"fft_{mesh}"]
    assert errs.shape == (2, 2), errs
    assert np.all(errs[:, 0] <= 2e-4) and np.all(errs[:, 1] <= 1e-5), errs


# ---------------------------------------------------------------------------
# training on a split grid
# ---------------------------------------------------------------------------


def test_case_configs_agree():
    """Each spatial case's config is the same in both packages."""
    for case in MESHES:
        assert workers.case_config(workers.tiny_config(), case) == port_config(
            workers.case_config(tiny_config(), case)), case


@pytest.mark.parametrize("case", JAX_CASES)
def test_spatial_case_step_matches(case, ops, refs):
    got = _run(ops, f"{case}_")
    _step_matches(got, refs["one"][case], refs["jax"][case])
    _states_match(got["step_states"], refs["one"][case]["step_states"])
    _states_match(got["step_states"], refs["jax"][case]["states"])


@pytest.mark.parametrize("case", JAX_CASES)
def test_spatial_case_epoch_matches(case, ops, refs):
    _epoch_matches(_run(ops, f"{case}_"), refs["one"][case], refs["jax"][case])


def test_whole_state_level_matches_one_process(ops, refs):
    """48^2 on (1, 4, 1): levels 3 and 4 run whole along y and level 3's
    state is held whole on each rank; the step's loss, params, evolved
    wavefield and states and the epoch against the one-process port."""
    got, one = _run(ops, "uneven48_"), refs["one"]["uneven48"]
    assert float(got["step_loss"]) == pytest.approx(one["step_loss"], rel=1e-5)
    assert float(got["step_grad_norm"]) == pytest.approx(one["step_grad_norm"], rel=1e-5)
    np.testing.assert_allclose(got["step_outc_b"], one["step_outc_b"], atol=1e-6)
    np.testing.assert_allclose(got["step_wavefield"], one["step_wavefield"], atol=1e-5)
    _states_match(got["step_states"], one["step_states"])
    assert float(got["epoch_loss"]) == pytest.approx(one["epoch_loss"], rel=1e-5)
    np.testing.assert_array_equal(got["epoch_iteration"], one["epoch_iteration"])
    np.testing.assert_allclose(got["epoch_wavefield"], one["epoch_wavefield"], atol=1e-5)


def test_spatial_accepts_levels_that_do_not_split():
    """96^2 at depth 4 on y = 4: level 4 (6 rows) runs whole along y, level
    3 (12 rows) splits; the Trainer takes the mesh. What the unsplit UNet
    cannot run, or a field that does not split, still raises."""
    sp = Spatial(_fake_mesh((1, 4, 1)), 96, 96, 4)
    assert (sp.level(3).ny, sp.level(3).tile_h) == (4, 3)
    assert (sp.level(4).ny, sp.level(4).tile_h, sp.level(4).nx) == (1, 6, 1)
    cfg = port_config(tiny_config())
    cfg = cfg.replace(geometry=dataclasses.replace(cfg.geometry, domain_size=96))
    t = tloop.Trainer(cfg, mesh=_fake_mesh((1, 4, 1)), device="cpu")
    assert t.spatial.level(4).ny == 1
    with pytest.raises(ValueError, match="not a multiple of 2\\^4"):
        Spatial(_fake_mesh((1, 2, 1)), 40, 32, 4)
    with pytest.raises(ValueError, match="does not split evenly over 3 ranks"):
        Spatial(_fake_mesh((1, 1, 3)), 32, 32, 4)


# ---------------------------------------------------------------------------
# GMRES on a split grid
# ---------------------------------------------------------------------------


def _solve_matches(x, norms, refs_here):
    """test_stencil_distributed.py's bounds for a split GMRES solve."""
    assert norms[-1] <= norms[0] * 1e-2, norms
    for rx, rn in refs_here:
        assert norms[-1] <= rn[-1] * 10, (norms, rn)
        np.testing.assert_allclose(x, rx, atol=3e-2 * np.abs(rx).max())


@pytest.mark.parametrize("mode", workers.GMRES_MODES)
def test_gmres_on_split_grid(mode, ops, refs):
    refs_here = [refs["one_gmres"][mode]]
    if mode in refs["jax_gmres"]:
        refs_here.append(refs["jax_gmres"][mode])
    _solve_matches(ops[f"gmres_{mode}_x"], ops[f"gmres_{mode}_norms"], refs_here)


@pytest.mark.parametrize("mode", workers.CSLP_MODES)
def test_cslp_gmres_on_split_grid(mode, ops, refs):
    """The CSLP-preconditioned solve on (1, 2, 2): the bounds of the
    unpreconditioned one, and each cycle's true residual within a factor
    2 of the one-process run's."""
    norms = ops[f"cslp_gmres_{mode}_norms"]
    one_x, one_norms = refs["one_cslp"][mode]
    _solve_matches(ops[f"cslp_gmres_{mode}_x"], norms,
                   [(one_x, one_norms), refs["jax_cslp"][mode]])
    ratio = norms / one_norms
    assert np.all((ratio <= 2) & (ratio >= 0.5)), (norms, one_norms)


# ---------------------------------------------------------------------------
# the CSLP inverse on tiles
# ---------------------------------------------------------------------------


def _tiles(a, ny, nx):
    """The ny x nx tiles of a [..., h, w] array, [..., ny, nx, h/ny, w/nx]."""
    h, w = a.shape[-2:]
    t = a.reshape(a.shape[:-2] + (ny, h // ny, nx, w // nx))
    return np.moveaxis(t, -3, -2)


def test_cslp_cases_take_both_routes_and_tell_local_kref():
    """CSLP_CASES' first grid of each mesh takes the all-to-all route on
    every pencil it splits, its second the all-gather route; on some tile
    the first medium's mean and the second's max differ from the grid's by
    more than 10%, so a tile-local kref fails the inverse's test."""
    mean_gap = max_gap = 0.0
    for (_, ny, nx), grids in workers.CSLP_CASES:
        for route, (h, w) in enumerate(grids):
            th, tw = h // ny, w // nx
            # x-pencils split the tile's rows over nx, y-pencils its columns over ny
            splits = [size % n == 0 for size, n in ((th, nx), (tw, ny)) if n > 1]
            assert splits and all(s == (route == 0) for s in splits), (ny, nx, h, w)
            k_sq, _ = workers.cslp_inputs(h, w)
            tiles = _tiles(k_sq, ny, nx)
            mean_gap = max(mean_gap, np.abs(tiles[0].mean((-2, -1)) / k_sq[0].mean() - 1).max())
            max_gap = max(max_gap, np.abs(tiles[1].max((-2, -1)) / k_sq[1].max() - 1).max())
    assert mean_gap > 0.1 and max_gap > 0.1, (mean_gap, max_gap)


@pytest.mark.parametrize("kref", workers.CSLP_KREFS)
@pytest.mark.parametrize("route", [0, 1], ids=["all_to_all", "all_gather"])
@pytest.mark.parametrize("mesh", ["1x2x2", "1x4x1", "1x1x4"])
def test_cslp_inverse_on_tiles(mesh, route, kref, ops):
    """The split inverse, gathered, against the one-process port's and
    JAX's on the whole grid (atol 1e-5 * max|ref|), and every rank's
    kref^2 against the grid's exact one (float64, rtol 1e-6) and JAX's
    (rtol 1e-6 beyond JAX's own distance from the exact one), for both
    media."""
    grids = dict(("x".join(map(str, sizes)), g) for sizes, g in workers.CSLP_CASES)
    h, w = grids[mesh][route]
    key = f"cslp_{mesh}_{route}_{kref}"
    k_sq, v = workers.cslp_inputs(h, w)
    one = make_shifted_laplace_inverse(
        make_operator(h, w, 8, 2.0, 1.0, dense=False, device="cpu"),
        torch.from_numpy(k_sq), kref=kref)(torch.from_numpy(v)).numpy()
    jop = jmake_operator(h, w, 8, 2.0, 1.0)
    jax_x = np.stack([np.asarray(jprecond.make_shifted_laplace_inverse(
        jop, jnp.asarray(k), kref=kref)(jnp.asarray(v[:, b])))
        for b, k in enumerate(k_sq)], axis=1)
    jax_kref2 = np.asarray([jnp.mean(k) if kref == "mean" else jnp.max(k) for k in k_sq])
    exact = k_sq.astype(np.float64).mean((-2, -1)) if kref == "mean" else k_sq.max((-2, -1))
    got = ops[f"{key}_x"]
    assert got.shape == v.shape
    for ref in (one, jax_x):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    kref2 = ops[f"{key}_kref2"]
    assert kref2.shape == (4, 2)
    np.testing.assert_allclose(kref2, np.broadcast_to(exact, kref2.shape), rtol=1e-6)
    # JAX's f32 mean carries its own rounding: about 1.45e-6 of the exact
    # mean of the first medium on the CPU (numpy's and torch's, 1e-7)
    jax_off = np.abs(jax_kref2 / exact - 1)
    assert np.all(np.abs(kref2 / jax_kref2 - 1) <= 1e-6 + jax_off), (kref2, jax_kref2)

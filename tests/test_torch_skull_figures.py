"""The port's skull, DICOM and absorption modules against the JAX
package's (bit for bit on the same inputs; DICOM files written by either
package read back the same in both), the skull problem through both
learned solvers with the round-1 weights (128^2, 20 iterations, rtol 1e-3
on the rmse trace, as tests/test_torch_iterative.py holds 'xla' mode),
every figure of eval/figures.py and eval/plots.py drawn to a temporary
directory, and `cli/produce_figures` end to end on 2 maps at 96^2."""

import os

import jax
import numpy as np
import pytest
import torch

from helmnet_tpu.core import config as jconf
from helmnet_tpu.data import absorption as jabs
from helmnet_tpu.data import dicom as jdicom
from helmnet_tpu.data import skull as jskull
from helmnet_tpu.models import hybridnet as jh
from helmnet_tpu.solvers import iterative as jit_
from helmnet_tpu_torch.core import config as tconf
from helmnet_tpu_torch.data import absorption as tabs
from helmnet_tpu_torch.data import dicom as tdicom
from helmnet_tpu_torch.data import skull as tskull
from helmnet_tpu_torch.solvers import iterative as tit
from helmnet_tpu_torch.weights import load_params_npz
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "trained_models", "round1_best_epoch890.npz")
ERROR_DISTRIBUTIONS = "distribution_errors_global.png"


def _equal(a, b):
    """Bit-equal numpy results (dataclasses field by field)."""
    if hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _equal(getattr(a, f), getattr(b, f))
        return
    if isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# skull pipeline and absorption, bit for bit
# ---------------------------------------------------------------------------


HU = np.array([-1000.0, -200.0, 0.0, 40.0, 700.0, 1500.0, 3000.0])


@pytest.mark.parametrize("name, args", [
    ("hounsfield_to_density", (HU,)),
    ("density_to_sos", (np.linspace(1.0, 2500.0, 9),)),
    ("synthetic_skull_ct", (96, 3)),
    ("make_arc_source", ((64, 64), (60, 32), 10.0, (32, 32), 2.0)),
    ("skull_example_problem", (128, 0)),
])
def test_skull_functions_bit_equal(name, args):
    _equal(getattr(tskull, name)(*args), getattr(jskull, name)(*args))


def test_clean_mask_and_medium_bit_equal():
    m = np.zeros((32, 32), bool)
    m[5:20, 5:20] = True
    m[10:12, 10:12] = False  # hole
    m[28, 28] = True  # speck
    c = tskull.clean_mask(m)
    _equal(c, jskull.clean_mask(m))
    assert c[10, 10] and not c[28, 28]
    hu = jskull.synthetic_skull_ct(128, seed=0)
    med = tskull.ct_to_medium(hu)
    _equal(med, jskull.ct_to_medium(hu))
    assert med.sos.min() >= 1.0 - 1e-6 and med.sos.max() <= 2.0 + 1e-6
    assert med.sos[med.skull_mask].mean() > med.sos[~med.skull_mask].mean()


A0 = np.array([[0.2, 2.0], [8.0, 15.0]])
Y = np.array([[1.1, 1.3], [1.9, 1.2]])
C0 = np.array([[1500.0, 1800.0], [2800.0, 3000.0]])


@pytest.mark.parametrize("name, args", [
    ("db2neper", (A0, Y)),
    ("neper2db", (A0, Y)),
    ("absorbed_power_law", (A0 * 1e-3, 2.0, C0, 2 * np.pi * 5e5)),
    ("fit_power_law_params", (A0, Y, C0, 500e3, 2.0)),
    ("fit_power_law_params", (1e-4, 1.5, 1500.0, 100e3, 2.0)),
])
def test_absorption_bit_equal(name, args):
    _equal(getattr(tabs, name)(*args), getattr(jabs, name)(*args))


def test_absorption_fit_reproduces_the_power_law():
    f_ref, y_ref = 500e3, 2.0
    a0_fit = tabs.fit_power_law_params(A0, Y, C0, f_ref, y_ref)
    w = 2 * np.pi * f_ref
    desired = tabs.db2neper(A0, Y) * w**Y
    actual = tabs.absorbed_power_law(tabs.db2neper(a0_fit, y_ref), y_ref, C0, w)
    np.testing.assert_allclose(actual, desired, rtol=1e-10)
    with pytest.raises(ValueError):
        tabs.fit_power_law_params(1.0, 1.5, 1500.0, 1e6, 1.0)


# ---------------------------------------------------------------------------
# DICOM across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer, reader", [(tdicom, jdicom), (jdicom, tdicom)],
                         ids=["port_writes", "jax_writes"])
def test_dicom_across_packages(tmp_path, writer, reader):
    hu = jskull.synthetic_skull_ct(64, seed=1)
    path = str(tmp_path / "slice.dcm")
    writer.write_dicom_ct(path, hu)
    back = reader.read_dicom_hu(path)
    _equal(back, writer.read_dicom_hu(path))
    np.testing.assert_allclose(back, np.round(hu + 1024) - 1024, atol=0.5)
    other = str(tmp_path / "other.dcm")
    reader.write_dicom_ct(other, hu)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()  # the same bytes from either writer
    _equal(tskull.medium_from_dicom(path), jskull.medium_from_dicom(path))


def test_dicom_series_and_refusal(tmp_path):
    for inst, val in ((3, 30.0), (1, 10.0), (2, 20.0)):
        jdicom.write_dicom_ct(str(tmp_path / f"s{inst}.dcm"), np.full((8, 8), val),
                              instance=inst)
    vol = tdicom.load_ct_series(str(tmp_path))
    _equal(vol, jdicom.load_ct_series(str(tmp_path)))
    np.testing.assert_allclose(vol[:, 0, 0], [10.0, 20.0, 30.0], atol=0.5)
    p = tmp_path / "x.dcm"
    p.write_bytes(b"\x00" * 200)
    with pytest.raises(ValueError):
        tdicom.read_dicom_hu(str(p))


# ---------------------------------------------------------------------------
# the skull problem through both learned solvers
# ---------------------------------------------------------------------------


def _config(mod, n):
    return mod.Config(
        max_iterations=50,
        geometry=mod.GeometryConfig(domain_size=n, pml_size=4, sigma_max=2.0),
        model=mod.ModelConfig(up_mode="subpixel", precision="highest"),
        source=mod.SourceConfig(amplitude=10.0, location=(n - 6, n // 2)),
    )


def _jax_params(jcfg):
    """The JAX package's `load_params_npz` without its op-by-op init."""
    shapes = jax.eval_shape(lambda k: jh.init_params(k, jcfg.model),
                            jax.random.PRNGKey(0))
    treedef = jax.tree_util.tree_structure(shapes)
    with np.load(NPZ) as f:
        leaves = [f[f"p{i}"] for i in range(treedef.num_leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def test_skull_problem_through_both_solvers():
    n = 128
    sos, source = tskull.skull_example_problem(n)
    jcfg, tcfg = _config(jconf, n), _config(tconf, n)
    js = jit_.IterativeSolver(jcfg, params=_jax_params(jcfg))
    js.set_domain_size(n, source_map=source[None])
    ts = tit.IterativeSolver(tcfg, params=load_params_npz(NPZ, tcfg, device="cpu"),
                             device="cpu")
    ts.set_domain_size(n, source_map=source[None])
    ref = js.forward(sos[None], num_iterations=20)
    got = ts.forward(sos[None], num_iterations=20)
    r = got["rmse"][:, 0].numpy()
    np.testing.assert_allclose(r, np.asarray(ref["rmse"])[:, 0], rtol=1e-3)
    assert np.isfinite(r).all() and r[-1] < r[0]


# ---------------------------------------------------------------------------
# figures (drawn here only: the card's machine has no matplotlib)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_solver():
    cfg = _config(tconf, 32)
    return tit.IterativeSolver(cfg, params=load_params_npz(NPZ, cfg, device="cpu"),
                               device="cpu")


def _drawn(path, size=1000):
    assert os.path.exists(path) and os.path.getsize(path) > size, path


def test_figures_render(tmp_path):
    pytest.importorskip("matplotlib")
    from helmnet_tpu_torch.eval import figures

    rng = np.random.default_rng(3)
    out = str(tmp_path)
    rmse = np.abs(rng.standard_normal((10, 50))) * np.exp(-np.arange(50) / 10)[None] + 1e-6
    _drawn(figures.fig_residual_rmse(rmse, out))
    _drawn(figures.fig_testset_mosaic(rng.standard_normal((8, 32, 32, 2)), rows=2,
                                      cols=4, out_dir=out))
    _drawn(figures.fig_error_histograms(np.abs(rng.standard_normal(100)) * 0.01, out))
    n, t = 12, 20
    res = np.abs(rng.standard_normal((n, t))) * np.exp(-np.arange(t) / 4)[None] + 1e-6
    linf = res * (0.5 + rng.random((n, t)))
    _drawn(figures.fig_error_vs_residual(res, linf, out))
    gm = np.abs(rng.standard_normal((n, 6))) * np.exp(-np.arange(6))[None] + 1e-8
    _drawn(figures.fig_residual_and_error_overlay(res, linf, gm, gm * 2.0,
                                                  total_iterations=t, out_dir=out))
    _drawn(figures.fig_error_histograms_boxplot(linf[:, -1], res[:, -1],
                                                linf[:, -1] * 0.1, res[:, -1] * 0.1,
                                                out_dir=out))


def test_solver_figures_render(tmp_path, small_solver):
    pytest.importorskip("matplotlib")
    from helmnet_tpu_torch.eval import figures, plots
    from helmnet_tpu_torch.eval.harness import compare_solvers

    sos = np.ones((32, 32), np.float32)
    sos[12:20, 8:24] = 1.5
    cmp = compare_solvers(small_solver, sos, num_iterations=20, decimate=5,
                          gmres_restart=20, gmres_max_restarts=5, gmres_tol=1e-6,
                          pml_crop=4)
    _drawn(figures.fig_example(cmp, sos, str(tmp_path)), 10000)
    _drawn(figures.fig_large_example(small_solver, str(tmp_path), size=64,
                                     iterations=4))
    plt = plots._plt()
    fig, ax = plt.subplots()
    plots.show_magnitude_db(cmp.model_wavefield, ax=ax, title="|u| dB")
    path = str(tmp_path / "vector.pdf")
    plots.rasterize_and_save(path, fig=fig)
    plt.close(fig)
    _drawn(path)


def test_cli_produce_figures(tmp_path, capsys):
    """The CLI on 2 generated maps at 96^2 (the default config's grid), 20
    iterations; every figure lands in --out. The f64 truth histograms
    (about 15 s a map at 96^2 on this CPU) are left to
    `test_truth_errors_and_their_figure`, at 32^2. `--orbax` and a
    directory checkpoint are refused."""
    pytest.importorskip("matplotlib")
    from helmnet_tpu_torch.cli import produce_figures
    from helmnet_tpu_torch.weights import ORBAX_REFUSAL

    out = tmp_path / "figs"
    rc = produce_figures.main([
        "--checkpoint", NPZ, "--out", str(out), "--num-samples", "2",
        "--iterations", "20", "--examples", "1", "--no-truth-histograms",
        "--platform", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    names = ("residual_rmse_testset.png", "testset_mosaic.png", "example_0.png",
             "linf_histogram.png", "error_vs_residual.png",
             "residual_and_linf_traces.png")
    for name in names:
        _drawn(str(out / name))
    assert sorted(p.name for p in out.iterdir()) == sorted(names)
    assert "l_inf vs GMRES: median" in text
    for argv in (["--orbax", str(tmp_path)], ["--checkpoint", str(tmp_path)]):
        with pytest.raises(SystemExit, match="export_orbax_npz"):
            produce_figures.main(argv + ["--platform", "cpu"])
    assert "export_orbax_npz" in ORBAX_REFUSAL


def test_skull_solve_helper(small_solver):
    """`produce_figures --skull`'s solve (skull_example_problem with its arc
    source through set_domain_size(size, source_map=...)), cut to 64^2 and
    4 iterations here."""
    from helmnet_tpu_torch.cli.produce_figures import skull_solve

    sos, out = skull_solve(small_solver, 64, 4)
    want_sos, want_src = tskull.skull_example_problem(64)
    _equal(sos, want_sos)
    np.testing.assert_array_equal(small_solver.source[0].numpy(), want_src)
    assert out["rmse"].shape == (4, 1) and torch.isfinite(out["rmse"]).all()


def test_truth_errors_and_their_figure(tmp_path, small_solver):
    """The CLI's f64 ground-truth comparison (`truth_errors`, the refined
    solve to 1e-10) on 2 maps at 32^2, and its figure."""
    pytest.importorskip("matplotlib")
    from helmnet_tpu_torch.cli.produce_figures import truth_errors
    from helmnet_tpu_torch.data.ellipses import make_dataset
    from helmnet_tpu_torch.eval import figures
    from helmnet_tpu_torch.eval.harness import compare_solvers

    small_solver.set_domain_size(32)
    maps = make_dataset(2, 32, seed=5)
    cmps = [compare_solvers(small_solver, m, num_iterations=20, decimate=5,
                            gmres_restart=20, gmres_max_restarts=10, gmres_tol=1e-7,
                            pml_crop=4) for m in maps]
    lm, rm, lg, rg = truth_errors(small_solver, maps, cmps)
    assert len(lm) == 2 and np.all(np.isfinite(lm + rm + lg + rg))
    assert max(lg) < min(lm)  # converged GMRES beats 20 learned steps
    _drawn(figures.fig_error_histograms_boxplot(
        np.array(lm), np.array(rm), np.array(lg), np.array(rg), out_dir=str(tmp_path)))
    assert os.path.exists(tmp_path / ERROR_DISTRIBUTIONS)

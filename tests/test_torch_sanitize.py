"""The port's sanitizers (helmnet_tpu_torch/core/sanitize.py): the six
cases of tests/test_sanitize.py on the port, the hand kernels' wrappers
naming a NaN of their outputs (on the CPU, their plain versions), the
`debug_nans` context, and a sanitized train step that raises before the
optimizer changes anything."""

import copy
import functools

import numpy as np
import pytest
import torch

from helmnet_tpu_torch import check_finite, checked, debug_nans, solve_helmholtz_checked
from helmnet_tpu_torch.models.hybridnet import iter_leaves
from helmnet_tpu_torch.ops.spectral import make_operator
from helmnet_tpu_torch.train.loop import Trainer
from tests.test_sanitize import tiny_config as jax_tiny_config
from tests.test_torch_training import port_config
from tests.torch_solver_cases import one_torch_thread  # noqa: F401


def tiny_config():
    return port_config(jax_tiny_config())


def test_checked_raises_on_nan_with_location():
    @checked
    def f(x):
        return torch.log(x) * 2.0  # log(-1) -> nan

    with pytest.raises(FloatingPointError) as ei:
        f(torch.tensor([-1.0]))
    msg = str(ei.value)
    assert "nan" in msg.lower() and "aten.log" in msg
    assert "test_torch_sanitize.py" in msg  # the innermost frame outside torch


def test_checked_passes_clean_values_through():
    @checked
    def f(x):
        return torch.log(x) * 2.0

    np.testing.assert_allclose(f(torch.tensor([1.0])).numpy(), [0.0])


def test_check_finite_user_invariant():
    def f(tree):
        check_finite(tree, "params")
        return {k: v * 2 for k, v in tree.items()}

    cf = checked(f, jit=True)
    bad = {"w": torch.tensor([1.0, float("inf")]), "b": torch.zeros(2)}
    with pytest.raises(FloatingPointError, match="non-finite values in params"):
        cf(bad)
    good = {"w": torch.ones(2), "b": torch.zeros(2)}
    np.testing.assert_allclose(cf(good)["w"].numpy(), [2.0, 2.0])
    # outside a sanitizer the invariant refuses to no-op
    with pytest.raises(RuntimeError, match="nothing would check it"):
        f(good)


def test_solve_helmholtz_checked_catches_bad_medium():
    n = 24
    op = make_operator(n, n, 6, 2.0, 1.0, device="cpu")
    src = np.zeros((n, n, 2), np.float32)
    src[12, 12, 0] = 1.0
    k_sq = np.ones((n, n), np.float32)
    # clean solve works through the instrumented path
    res = solve_helmholtz_checked(op, k_sq, src, restart=8, max_restarts=4,
                                  device="cpu")
    assert bool(torch.isfinite(res.x).all())
    # a NaN medium raises, naming the op and where it ran
    bad = k_sq.copy()
    bad[5, 5] = np.nan
    with pytest.raises(FloatingPointError) as ei:
        solve_helmholtz_checked(op, bad, src, restart=8, max_restarts=4,
                                device="cpu")
    assert "nan produced by aten." in str(ei.value)
    assert "helmnet_tpu_torch/" in str(ei.value)


def _poisoned_batch(tr):
    batch = tr.buffer.sample(tr.cfg.training.train_batch_size)
    wf = batch.wavefield.copy()
    wf[0, 8, 8, 0] = np.nan
    return tr._to_device(batch._replace(wavefield=wf))


def test_trainer_sanitize_flag_raises_on_injected_nan():
    cfg = tiny_config()
    tr = Trainer(cfg, sanitize=True, device="cpu")
    tr.fill_buffer(np.ones((4, 16, 16), np.float32))
    # the poisoned step raises at the first NaN-making op, not with a NaN loss
    with pytest.raises(FloatingPointError) as ei:
        tr._train_step(_poisoned_batch(tr), 0)
    assert "nan" in str(ei.value).lower() and "aten." in str(ei.value)


def test_trainer_sanitize_clean_step_matches_default():
    cfg = tiny_config()
    tr_a = Trainer(cfg, sanitize=True, device="cpu")
    tr_b = Trainer(cfg, sanitize=False, device="cpu")
    tr_a.fill_buffer(np.ones((4, 16, 16), np.float32))
    batch = tr_a._to_device(tr_a.buffer.sample(cfg.training.train_batch_size))
    m_a, e_a = tr_a._train_step(batch, 0)
    m_b, e_b = tr_b._train_step(batch, 0)
    for k in m_a:
        assert float(m_a[k]) == float(m_b[k]), k
    assert torch.equal(e_a["wavefield"], e_b["wavefield"])


def test_sanitized_step_that_raises_changes_nothing():
    """The check runs after backward() and before Adam's step: a poisoned
    step leaves the params and the optimizer state as the last clean step
    left them."""
    cfg = tiny_config()
    tr = Trainer(cfg, sanitize=True, device="cpu")
    tr.fill_buffer(np.ones((4, 16, 16), np.float32))
    tr._train_step(tr._to_device(tr.buffer.sample(2)), 0)  # a clean step
    params = {p: t.detach().clone() for p, t in iter_leaves(tr.params)}
    state = copy.deepcopy(tr.optimizer.state_dict())
    with pytest.raises(FloatingPointError):
        tr._train_step(_poisoned_batch(tr), 0)
    for p, t in iter_leaves(tr.params):
        assert torch.equal(t.detach(), params[p]), p
    after = tr.optimizer.state_dict()
    assert after["param_groups"] == state["param_groups"]
    for i, s in state["state"].items():
        for k, v in s.items():
            assert torch.equal(after["state"][i][k], v), (i, k)


def _k1_nan():
    from helmnet_tpu_torch.models.blocks import init_double_conv
    from helmnet_tpu_torch.ops.double_conv import fused_double_conv

    p = init_double_conv(torch.Generator().manual_seed(0), 6, 8, "prelu")
    x = torch.zeros((1, 8, 8, 6))
    x[0, 3, 3, 0] = float("nan")
    return functools.partial(fused_double_conv, p, x)


def _k3_nan():
    from helmnet_tpu_torch.models.blocks import init_double_conv
    from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv

    p = init_double_conv(torch.Generator().manual_seed(0), 16, 16, "prelu")
    x = torch.zeros((1, 8, 8, 16))
    x[0, 3, 3, 0] = float("nan")
    return lambda: packed_double_conv(p, x)


def _k2_nan(entry, **kw):
    def make():
        from helmnet_tpu_torch.ops import stencil_residual as sr
        from helmnet_tpu_torch.ops.stencil import make_stencil_operator

        op = make_stencil_operator(16, 16, 4, 2.0, 1.0, order=4, device="cpu")
        u = torch.ones((2, 16, 16))
        k = torch.ones((2, 16, 16))
        k[1, 5, 5] = float("nan")  # planted before the check, as a NaN medium
        return lambda: getattr(sr, entry)(op, u, u, k, **kw)

    return make


@pytest.mark.parametrize("make, name", [
    (_k1_nan, "K1 (fused_double_conv"),
    (_k3_nan, "K3 (packed_double_conv"),
    (_k2_nan("residual_planes"), "K2a (residual_planes"),
    (_k2_nan("residual_planes_tiled", tile_h=8), "K2b (residual_planes_tiled"),
    (_k2_nan("residual_planes_mxu", tile_h=8), "K2c (residual_planes_mxu"),
], ids=["K1", "K3", "K2a", "K2b", "K2c"])
def test_kernel_wrapper_names_its_nan(make, name):
    """A NaN reaching a hand kernel is named by the kernel, not by an op
    inside its plain version (the CPU route) or by a later op; the same
    wrapper raises nothing without a sanitizer."""
    run = make()
    out = run()  # unchecked: the NaN just propagates
    assert not all(bool(torch.isfinite(t).all()) for t in
                   (out if isinstance(out, tuple) else (out,)))
    with pytest.raises(FloatingPointError) as ei:
        checked(run)()
    assert f"nan passed to {name}" in str(ei.value)


def test_kernel_wrapper_names_a_nan_it_makes(monkeypatch):
    """A NaN born inside a kernel (its inputs finite) is named by the
    kernel's output check."""
    from helmnet_tpu_torch.ops import double_conv as k1

    plain = k1.double_conv_plain
    monkeypatch.setattr(k1, "double_conv_plain",
                        lambda p, parts: plain(p, parts) * float("nan"))
    p, x = _k1_nan().args
    clean = torch.zeros_like(x)
    with pytest.raises(FloatingPointError, match=r"nan produced by K1 \(fused_double_conv"):
        checked(lambda: k1.fused_double_conv(p, clean))()


def test_debug_nans_context():
    a, z = torch.tensor([1.0]), torch.tensor([0.0])
    with debug_nans():
        with pytest.raises(FloatingPointError, match="inf produced by aten.div"):
            a / z
        with debug_nans(False):
            assert torch.isinf(a / z).all()  # turned off for this block
        # an inf carried on from the inputs is not where it was made
        torch.where(torch.tensor([True]), torch.tensor([float("inf")]), a)
    assert torch.isinf(a / z).all()  # off outside the block

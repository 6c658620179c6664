"""The plain reference against `helmnet_tpu_torch` at tiny sizes on the
CPU: the operator's tables and residual, and whole solves through the
port's cuDNN path (f32) and its K1 path (the kernel's plain version on
the CPU, bf16 roundings); the operand roundings; the seeded inputs."""

import dataclasses

import pytest
import torch

from helmnet_tpu_torch.core.config import Config, GeometryConfig, SourceConfig
from helmnet_tpu_torch.ops.spectral import helmholtz_residual, make_operator
from helmnet_tpu_torch.ops.spectral3d import helmholtz_residual3d, make_operator3d
from helmnet_tpu_torch.solvers.iterative import IterativeSolver
from helmnet_tpu_torch.solvers.iterative3d import IterativeSolver3D
from portbench import inputs, spec
from portbench.reference.physics import Operator
from portbench.reference.rounding import round_to
from portbench.reference.solve import solve
from portbench.reference.unet import load_weights

CPU = torch.device("cpu")
W2D = spec.ROOT / "trained_models" / "tpu_r2c_best.npz"
W3D = spec.ROOT / "trained_models" / "tpu3d_a_ep80.npz"
MODEL2D = dict(depth=4, state_depth=4, state_channels=2, resample=dict(pad=3))
MODEL3D = dict(depth=3, state_depth=3, state_channels=2, resample=dict(pad=1))


def _prec(dc="f32", other="f32"):
    return dict(double_convs=dc, head=dc, resample_convs=other, operator=other)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_operator_tables_and_residual():
    g = torch.Generator().manual_seed(0)
    op = Operator((24, 24), 6, 2.0, 1.0, CPU)
    port = make_operator(24, 24, 6, 2.0, 1.0, device="cpu")
    for mine, theirs in ((op.mats[0][0], port.ay_r), (op.mats[0][1], port.ay_i),
                         (op.mats[1][0], port.ax_r), (op.mats[1][1], port.ax_i),
                         (op.sigmas, port.sigmas)):
        assert _rel(mine, theirs) < 1e-6
    u, s = torch.randn(2, 24, 24, 2, generator=g), torch.randn(2, 24, 24, 2, generator=g)
    k2 = 1 + torch.rand(2, 24, 24, generator=g)
    assert _rel(op.residual(u, k2, s), helmholtz_residual(port, u, k2, s, "matmul")) < 1e-5

    op3 = Operator((12, 12, 12), 3, 2.0, 1.0, CPU)
    port3 = make_operator3d(12, 12, 12, 3, 2.0, 1.0, device="cpu")
    assert _rel(op3.sigmas, port3.sigmas) == 0.0
    u, s = torch.randn(2, 12, 12, 12, 2, generator=g), torch.randn(2, 12, 12, 12, 2, generator=g)
    k2 = 1 + torch.rand(2, 12, 12, 12, generator=g)
    assert _rel(op3.residual(u, k2, s), helmholtz_residual3d(port3, u, k2, s)) < 1e-5


def _solver2d(mode: str, n: int, loc):
    cfg = Config(geometry=GeometryConfig(n, 8, 2.0), source=SourceConfig(location=loc))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, double_conv_mode=mode,
                                                up_mode="subpixel"))
    return IterativeSolver.from_params_npz(str(W2D), cfg, device="cpu")


@pytest.mark.parametrize("mode,prec,tol", [("xla", "f32", 2e-6), ("pallas", "bf16", 2e-2)])
def test_solve2d_against_port(mode, prec, tol):
    """f32: the cuDNN path to rounding. bf16: K1's plain version rounds as
    the reference does, and a rounding that tips the other way moves a
    value by a bf16 step, so the bound is wider."""
    n, loc = 32, (20, 16)
    sos = inputs.ellipse_maps(inputs.rng_for(3), 3, n, CPU)
    src = inputs.point_source((n, n), loc, 10.0, 0.0, CPU)
    solver = _solver2d(mode, n, loc)
    solver.set_source_maps(src)
    out = solver.forward(sos, num_iterations=6)
    op = Operator((n, n), 8, 2.0, 1.0, CPU)
    wf, hist = solve(load_weights(W2D, 4, 4, CPU), MODEL2D, op, sos,
                     src[None].expand(3, n, n, 2), iterations=6, omega=1.0,
                     amplitude=10.0, precision=_prec(prec))
    assert _rel(out["final_wavefield"], wf) < tol
    assert float(((out["rmse"] - hist).abs() / hist).max()) < tol


def test_solve3d_against_port():
    n = 16
    cfg = Config(geometry=GeometryConfig(n, 4, 2.0))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, depth=3, state_depth=3,
                                                features=16, in_channels=7))
    solver = IterativeSolver3D.from_params_npz(str(W3D), cfg, device="cpu")
    sos = inputs.shell_volumes(inputs.rng_for(4), 2, n, CPU)
    src = inputs.point_source((n, n, n), (10, 8, 8), 10.0, 0.0, CPU)
    solver.set_source_maps(src)
    out = solver.forward(sos, num_iterations=4)
    op = Operator((n, n, n), 4, 2.0, 1.0, CPU)
    wf, hist = solve(load_weights(W3D, 3, 3, CPU), MODEL3D, op, sos,
                     src[None].expand(2, n, n, n, 2), iterations=4, omega=1.0,
                     precision=_prec())
    assert _rel(out["final_wavefield"], wf) < 2e-6
    assert float(((out["rmse"] - hist).abs() / hist).max()) < 2e-6


def test_roundings():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-10), 3.0e-5, 0.0])
    # TF32 keeps 10 mantissa bits, ties to even
    t = round_to(x, "tf32").tolist()
    assert t[:4] + t[5:] == [1.0, 1.0, 1 + 2**-9, -(1 + 2**-10), 0.0]
    assert t[4] == pytest.approx(3.0e-5, rel=2**-10)
    assert torch.equal(round_to(x, "bf16"), x.to(torch.bfloat16).float())
    y = torch.tensor([1e4, -3.0, 0.5])
    f8 = round_to(y, "fp8")
    assert f8[0].item() == pytest.approx(1e4, rel=1e-6)  # the scale keeps amax
    assert 0 < abs(f8[1].item() + 3.0) < 0.2
    assert torch.equal(round_to(y, "f32"), y)
    with pytest.raises(ValueError):
        round_to(y, "fp4")


def test_inputs_seeded():
    a = inputs.ellipse_maps(inputs.rng_for(2**31 + 5), 4, 48, CPU)
    b = inputs.ellipse_maps(inputs.rng_for(2**31 + 5), 4, 48, CPU)
    c = inputs.ellipse_maps(inputs.rng_for(2**31 + 6), 4, 48, CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    ring = a[a != 1.0]
    assert ring.numel() > 0 and float(ring.min()) >= 1.5 and float(ring.max()) <= 2.0
    v = inputs.shell_volumes(inputs.rng_for(-7), 2, 16, CPU)
    assert v.shape == (2, 16, 16, 16) and float(v.max()) > 1.5
    assert inputs.rng_for(-1).integers(1 << 30) == inputs.rng_for(2**64 - 1).integers(1 << 30)

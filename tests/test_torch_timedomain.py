"""The port's 2D time-domain CW solver (`solvers/timedomain.solve_cw`)
against the JAX package's on the CPU: 32^2, roundtrips 2 (906 and 1358
leapfrog steps), homogeneous and with a slab. The step count and the
float32 time step must be equal; the phasor agrees within 1e-4 of its
largest magnitude (two f32 FFT libraries' round-off, carried through
about a thousand steps; measured about 1e-6)."""

import numpy as np
import pytest
import torch

from helmnet_tpu.ops.source import point_source_amplitude
from helmnet_tpu.solvers import timedomain as jtd
from helmnet_tpu_torch.solvers import timedomain as ttd
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

N = 32
KW = dict(omega=1.0, cfl=0.1, roundtrips=2, record_periods=3, sponge_width=8,
          sponge_strength=1.0)


def _problem(slab: bool):
    sos = np.ones((N, N), np.float32)
    if slab:
        sos[12:17, 9:23] = 1.5
    return sos, point_source_amplitude(N, N, (20, 16), 1.0)


@pytest.mark.parametrize("slab", [False, True], ids=["homogeneous", "slab"])
def test_solve_cw_against_jax(slab):
    sos, amp = _problem(slab)
    want = jtd.solve_cw(sos, amp, **KW)
    got = ttd.solve_cw(sos, amp, device="cpu", **KW)
    assert got.num_steps == int(want.num_steps) == (1358 if slab else 906)
    assert got.dt == float(want.dt)
    ref = np.asarray(want.phasor)
    assert got.phasor.shape == (N, N, 2) and got.phasor.dtype == torch.float32
    np.testing.assert_allclose(got.phasor.numpy(), ref, atol=1e-4 * np.abs(ref).max())


def test_sponge_and_inputs():
    np.testing.assert_array_equal(ttd._sponge_sigma(24, 40, 6, 1.5),
                                  jtd._sponge_sigma(24, 40, 6, 1.5))
    # a tensor sos map runs as its numpy copy does
    sos, amp = _problem(True)
    kw = dict(KW, roundtrips=1)
    a = ttd.solve_cw(sos, amp, device="cpu", **kw)
    b = ttd.solve_cw(torch.from_numpy(sos), torch.from_numpy(amp), device="cpu", **kw)
    assert a.num_steps == b.num_steps
    assert torch.equal(a.phasor, b.phasor)


def test_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sos, amp = _problem(False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttd.solve_cw(sos, amp, **KW)

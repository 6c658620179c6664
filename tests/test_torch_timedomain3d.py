"""The port's 3D time-domain CW solver (`solve_cw3d`,
`solve_cw3d_chunked`) against the JAX package's, on the CPU, at 16^3 with
tests/test_timedomain3d.py:72-86's slab problem and a homogeneous one: the
step counts and the float32 time step equal, the phasor within rtol 2e-5,
atol 2e-6 (:83-86) of JAX's in units of its largest magnitude, and the
chunked form equal to the monolithic one to the bit."""

import numpy as np
import pytest
import torch

from helmnet_tpu.solvers import timedomain as jtd
from helmnet_tpu_torch.solvers import timedomain as ttd
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

KW = dict(omega=1.0, cfl=0.2, roundtrips=3, record_periods=2, sponge_width=4,
          sponge_strength=1.0)


def _problem(slab: bool):
    sos = np.ones((16, 16, 16), np.float32)
    if slab:
        sos[6:10, 5:11, 5:11] = 1.4
    amp = np.zeros((16, 16, 16), np.float32)
    amp[11, 8, 8] = 1.0
    return sos, amp


@pytest.mark.parametrize("slab", [False, True], ids=["homogeneous", "slab"])
def test_solve_cw3d_against_jax(slab):
    sos, amp = _problem(slab)
    want = jtd.solve_cw3d(sos, amp, **KW)
    got = ttd.solve_cw3d(sos, amp, device="cpu", **KW)
    assert got.num_steps == int(want.num_steps)
    assert got.dt == float(want.dt)
    ref = np.asarray(want.phasor)
    assert got.phasor.shape == (16, 16, 16, 2) and got.phasor.dtype == torch.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.phasor.numpy() / scale, ref / scale, rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("chunk", [37, 10**6])
def test_chunked_equals_monolithic(chunk, capsys):
    sos, amp = _problem(True)
    mono = ttd.solve_cw3d(sos, amp, device="cpu", **KW)
    chunked = ttd.solve_cw3d_chunked(sos, amp, chunk_steps=chunk, verbose=True,
                                     device="cpu", **KW)
    assert chunked.num_steps == mono.num_steps and chunked.dt == mono.dt
    assert torch.equal(chunked.phasor, mono.phasor)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith(f"  cw3d[{mono.num_steps}/{mono.num_steps}]")
    jax_chunked = jtd.solve_cw3d_chunked(sos, amp, chunk_steps=37, **KW)
    assert int(jax_chunked.num_steps) == mono.num_steps


def test_sponge_and_device(monkeypatch):
    np.testing.assert_array_equal(ttd._sponge_sigma3d(10, 12, 14, 3, 1.5),
                                  jtd._sponge_sigma3d(10, 12, 14, 3, 1.5))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sos, amp = _problem(False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttd.solve_cw3d(sos, amp, **KW)

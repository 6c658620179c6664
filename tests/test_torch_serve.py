"""The port's serving layer (`helmnet_tpu_torch/serve.py`,
`cli/serve.py`) on the CPU: the eight cases of tests/test_serve.py on
the port's service, plus the served wavefield and rmse against the JAX
package's `SolverService` with the same weights (carried by
`weights.from_jax_params`), within tests/test_torch_iterative.py's
rollout tolerance ('highest' precision: rtol 1e-3 on the rmse, atol
1e-3 * max|u| on the wavefield).

Every `result()` takes a timeout and every service is shut down in
`finally`, so a fault fails a test instead of hanging the run."""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from helmnet_tpu_torch.core import config as tconf
from helmnet_tpu_torch.serve import ServeConfig, SolverService
from helmnet_tpu_torch.solvers.iterative import IterativeSolver
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

TIMEOUT = 300  # seconds for any one future or HTTP call


def tiny_config(**model_kw):
    """tests/test_training.tiny_config's model and geometry, in the port's
    config module."""
    return tconf.Config(
        max_iterations=50,
        geometry=tconf.GeometryConfig(domain_size=32, pml_size=4, sigma_max=2.0),
        model=tconf.ModelConfig(features=8, depth=4, state_depth=4,
                                state_channels=2, **model_kw),
        source=tconf.SourceConfig(amplitude=10.0, location=(26, 16)),
    )


def _solver():
    return IterativeSolver(tiny_config(), device="cpu")


def make_service(**kw):
    cfg = ServeConfig(
        max_batch=kw.pop("max_batch", 4),
        chunk_iterations=kw.pop("chunk_iterations", 8),
        default_iterations=kw.pop("default_iterations", 16),
        **kw,
    )
    return SolverService(_solver(), cfg)


def _np(t):
    return t.cpu().numpy()


class TestSolverService:
    def test_solve_matches_direct_forward(self):
        """A served solve returns what a direct forward of the same padded
        batch returns (same params, same source, same iteration count)."""
        service = make_service()
        rng = np.random.default_rng(0)
        sos = 1.0 + 0.5 * rng.random((32, 32)).astype(np.float32)
        try:
            out = service.solve(sos, iterations=16, timeout=TIMEOUT)
            ref = _solver().forward(np.repeat(sos[None], 4, axis=0),
                                    num_iterations=16, chunk_iterations=8)
            assert isinstance(out["wavefield"], np.ndarray)
            np.testing.assert_allclose(out["wavefield"], _np(ref["wavefield"])[0],
                                       atol=1e-5)
            np.testing.assert_allclose(out["rmse"], _np(ref["rmse"])[:, 0], rtol=1e-4)
            assert out["best_rmse"] == pytest.approx(float(ref["best_rmse"][0]),
                                                     rel=1e-5)
            assert out["iterations"] == 16
        finally:
            service.shutdown()

    def test_batching_and_padding(self):
        """Concurrent same-shape requests coalesce into one padded batch and
        each slot returns its own answer (checked against independent
        direct forwards with the same per-request sources)."""
        service = make_service(batch_window_s=0.2)
        rng = np.random.default_rng(1)
        sos = 1.0 + 0.5 * rng.random((32, 32)).astype(np.float32)
        locs = [(20, 16), (22, 16), (24, 18)]
        try:
            futs = [service.submit(sos, source_location=loc, iterations=8)
                    for loc in locs]
            outs = [f.result(timeout=TIMEOUT) for f in futs]
            solver = _solver()
            for loc, out in zip(locs, outs):
                solver.set_sources([loc])
                ref = solver.forward(sos[None], num_iterations=8, chunk_iterations=8)
                np.testing.assert_allclose(out["rmse"], _np(ref["rmse"])[:, 0],
                                           rtol=1e-4)
                np.testing.assert_allclose(out["wavefield"],
                                           _np(ref["wavefield"])[0], atol=1e-5)
            stats = service.stats()
            assert stats["completed"] == 3
            # 3 requests in a max_batch=4 bucket: 1 batch, 1 padded slot,
            # unless the window split them (allowed but rare)
            assert stats["batches"] <= 2
            assert stats["padded_slots"] >= 1
        finally:
            service.shutdown()

    def test_iteration_rounding(self):
        """Requested iterations round UP to a chunk multiple."""
        service = make_service()
        try:
            out = service.solve(np.ones((32, 32), np.float32), iterations=9,
                                timeout=TIMEOUT)
            assert out["iterations"] == 16  # ceil(9/8)*8
            assert out["rmse"].shape == (16,)
        finally:
            service.shutdown()

    def test_validation_fails_fast(self):
        service = make_service()
        try:
            with pytest.raises(ValueError, match="divisible"):
                service.submit(np.ones((30, 30), np.float32))
            with pytest.raises(ValueError, match="source_map"):
                service.submit(np.ones((32, 32), np.float32),
                               source_map=np.zeros((16, 16)))
            with pytest.raises(ValueError, match="sos_map"):
                service.submit(np.ones((4, 32, 32), np.float32))
        finally:
            service.shutdown()

    def test_shape_buckets(self):
        """Mixed-size traffic lands in different buckets; both complete."""
        service = make_service(batch_window_s=0.05)
        try:
            f32 = service.submit(np.ones((32, 32), np.float32), iterations=8)
            f48 = service.submit(np.ones((48, 48), np.float32), iterations=8)
            o32, o48 = f32.result(timeout=TIMEOUT), f48.result(timeout=TIMEOUT)
            assert o32["wavefield"].shape == (32, 32, 2)
            assert o48["wavefield"].shape == (48, 48, 2)
            assert set(service.stats()["by_size"]) == {"32x32", "48x48"}
        finally:
            service.shutdown()

    def test_shutdown_rejects_new_work(self):
        service = make_service()
        service.shutdown()
        with pytest.raises(RuntimeError):
            service.submit(np.ones((32, 32), np.float32))


class TestHTTPFrontend:
    def test_solve_over_http(self):
        from helmnet_tpu_torch.cli.serve import serve_forever

        service = make_service()
        server, _ = serve_forever(service, port=0)
        port = server.server_address[1]
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30
            ) as r:
                assert json.load(r)["ok"] is True

            body = json.dumps({
                "sos": np.ones((32, 32), np.float32).tolist(),
                "source_location": [26, 16],
                "iterations": 8,
            }).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/solve", data=body,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                out = json.load(r)
            wf = np.asarray(out["wavefield"], np.float32)
            assert wf.shape == (32, 32, 2)
            assert np.isfinite(wf).all()
            assert out["best_rmse"] > 0

            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/stats", timeout=30
            ) as r:
                assert json.load(r)["completed"] == 1
        finally:
            server.shutdown()
            service.shutdown()

    def test_http_bad_request(self):
        from helmnet_tpu_torch.cli.serve import serve_forever

        service = make_service()
        server, _ = serve_forever(service, port=0)
        port = server.server_address[1]
        try:
            body = json.dumps({"sos": np.ones((30, 30)).tolist()}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/solve", data=body)
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                urllib.request.urlopen(req, timeout=60)
            assert exc_info.value.code == 400
        finally:
            server.shutdown()
            service.shutdown()


def test_served_against_jax_service():
    """The port's service and the JAX package's on the same weights, the
    same mixed traffic (a default and an explicit source, a source map):
    each request's wavefield and rmse agree within the rollout tolerance."""
    import jax

    from helmnet_tpu import serve as jserve
    from helmnet_tpu.solvers import iterative as jit_
    from helmnet_tpu_torch.weights import from_jax_params
    from tests.test_training import tiny_config as jax_tiny_config

    jcfg = jax_tiny_config()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, precision="highest"))
    tcfg = tiny_config(precision="highest")
    jsolver = jit_.IterativeSolver(jcfg)  # JAX's init, PRNGKey(0)
    tree = jax.tree_util.tree_map(np.asarray, jsolver.params)
    tsolver = IterativeSolver(tcfg, params=from_jax_params(tree, device="cpu"),
                              device="cpu")
    rng = np.random.default_rng(5)
    sos = (1.0 + 0.5 * rng.random((3, 32, 32))).astype(np.float32)
    smap = np.zeros((32, 32, 2), np.float32)
    smap[20, 10:20, 0] = 1.0
    requests = [dict(), dict(source_location=(22, 14)), dict(source_map=smap)]
    sc = dict(max_batch=4, chunk_iterations=8, batch_window_s=0.2)
    services = (jserve.SolverService(jsolver, jserve.ServeConfig(**sc)),
                SolverService(tsolver, ServeConfig(**sc)))
    try:
        outs = []
        for service in services:
            futs = [service.submit(s, iterations=16, **kw)
                    for s, kw in zip(sos, requests)]
            outs.append([f.result(timeout=TIMEOUT) for f in futs])
        for jo, to in zip(*outs):
            np.testing.assert_allclose(to["rmse"], np.asarray(jo["rmse"]), rtol=1e-3)
            wf = np.asarray(jo["wavefield"])
            np.testing.assert_allclose(to["wavefield"], wf, atol=1e-3 * np.abs(wf).max())
            assert to["best_rmse"] == pytest.approx(jo["best_rmse"], rel=1e-3)
            assert to["iterations"] == jo["iterations"] == 16
        assert services[1].stats().keys() == services[0].stats().keys()
    finally:
        for service in services:
            service.shutdown()


def test_from_checkpoint(tmp_path):
    """`from_checkpoint` reads the params npz onto the device it is given,
    refuses an orbax directory, and without a card and without a device
    raises instead of falling back to the CPU."""
    from helmnet_tpu_torch.weights import ORBAX_REFUSAL
    from tests.torch_solver_cases import R2C_NPZ

    service = SolverService.from_checkpoint(R2C_NPZ, ServeConfig(max_batch=2),
                                            device="cpu")
    try:
        assert service.solver.device == torch.device("cpu")
        assert service.solver.cfg.model.features == 8
    finally:
        service.shutdown()
    with pytest.raises(ValueError, match="export_orbax_npz"):
        SolverService.from_checkpoint(str(tmp_path), device="cpu")
    assert "export_orbax_npz" in ORBAX_REFUSAL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SolverService.from_checkpoint(R2C_NPZ)


def test_worker_failure_reaches_every_future(monkeypatch):
    """A failure inside a batch (a kernel's included) is set on every
    future of that batch and counted; nothing falls back."""
    service = make_service(batch_window_s=0.2)

    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(service.solver, "forward", broken)
    try:
        futs = [service.submit(np.ones((32, 32), np.float32), iterations=8)
                for _ in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="launch failed"):
                f.result(timeout=TIMEOUT)
        assert service.stats()["failed"] == 2
        assert service.stats()["completed"] == 0
    finally:
        service.shutdown()

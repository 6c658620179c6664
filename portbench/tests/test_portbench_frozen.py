"""The frozen copies in `portbench/counts.py` tied to `chip_smoke.py`'s
originals on the models' shapes, as they stood when copied; the shape
tree the benchmark builds from the raw npz against the program's own
weights.

The only file of `portbench/` that imports `chip_smoke`."""

import dataclasses
import faulthandler

import pytest
import torch

import chip_smoke
from helmnet_tpu_torch.core.config import Config
from helmnet_tpu_torch.models.hybridnet import iter_leaves
from helmnet_tpu_torch.weights import load_params3d_npz, load_params_npz
from portbench import counts, spec
from portbench.trace import Trace
from portbench.reference.unet import load_weights

faulthandler.cancel_dump_traceback_later()  # chip_smoke arms a watchdog at import

W2D = spec.ROOT / "trained_models" / "tpu_r2c_best.npz"
W3D = spec.ROOT / "trained_models" / "tpu3d_a_ep80.npz"


def _config2d():
    cfg = Config()
    return cfg.replace(model=dataclasses.replace(cfg.model, double_conv_mode="pallas",
                                                 up_mode="subpixel"))


def _config3d():
    cfg = Config()
    return cfg.replace(model=dataclasses.replace(cfg.model, depth=3, state_depth=3,
                                                 features=16, in_channels=7))


def test_peaks():
    assert counts.PEAK_BF16_FLOPS == chip_smoke.PEAK_BF16_FLOPS
    assert counts.PEAK_F32_FLOPS == chip_smoke.PEAK_F32_FLOPS
    assert counts.PEAK_BYTES_S == chip_smoke.PEAK_BYTES_S


@pytest.mark.parametrize("name,depth,cfg", [("2d", 4, _config2d), ("3d", 3, _config3d)])
def test_shape_tree_is_the_programs(name, depth, cfg):
    """The tree built from the raw npz has the program's leaves and shapes."""
    c = cfg()
    path = W2D if name == "2d" else W3D
    port = (load_params_npz if name == "2d" else load_params3d_npz)(str(path), c, device="cpu")
    tree = counts.shape_tree(load_weights(path, depth, depth, "cpu"), depth, depth)
    assert [(p, tuple(t.shape)) for p, t in iter_leaves(tree)] == \
        [(p, tuple(t.shape)) for p, t in iter_leaves(port)]


@pytest.mark.parametrize("n,batch", [(96, 32), (96, 512), (256, 16), (1024, 4)])
def test_k1_bound(n, batch):
    c = _config2d()
    params = load_params_npz(str(W2D), c, device="cpu")
    mine = counts.step_calls(params, c.model, n)
    theirs = chip_smoke.step_calls(params, c.model, n)
    assert [(a[0], a[2], a[3]) for a in mine] == [(a[0], a[2], a[3]) for a in theirs]
    for (_, p, g, chans) in mine:
        co = p["post"]["w"].shape[0] if "post" in p else p["c2"]["w"].shape[0]
        parts = [torch.empty(batch, g, g, ch, device="meta") for ch in chans]
        out = torch.empty(batch, g, g, co, device="meta")
        assert counts.bound(p, parts, out) == chip_smoke.bound(p, parts, out)


@pytest.mark.parametrize("n", [48, 64])
def test_conv_flops3d(n):
    c = _config3d()
    params = load_params3d_npz(str(W3D), c, device="cpu")
    assert counts.conv_flops(params, 3, n, 3) == chip_smoke.conv_flops3d(params, c.model, n)
    tree = counts.shape_tree(load_weights(W3D, 3, 3, "cpu"), 3, 3)
    assert counts.conv_flops(tree, 3, n, 3) == chip_smoke.conv_flops3d(params, c.model, n)


def test_busy_and_idle():
    """`Trace.busy_s` is profile_steps' device time (the sum of the
    operations' times) where they do not overlap, and the union where
    they do; the idle share is 1 - profile_steps' busy share."""
    ops = [("k_a", 0.00, 0.10), ("Memcpy HtoD", 0.15, 0.20), ("k_b", 0.30, 0.60)]
    tr = Trace(ops=ops, window_s=1.0)
    device_ms = 1e3 * sum(e - s for _, s, e in ops)
    assert tr.busy_s() == pytest.approx(device_ms / 1e3)
    idle = spec.metric_reader("device_idle_share.solve")(tr)
    assert idle == pytest.approx(100 * (1 - counts.busy_share(device_ms, 1.0)))
    overlap = Trace(ops=[("a", 0.0, 0.5), ("b", 0.25, 0.75)], window_s=1.0)
    assert overlap.busy_s() == pytest.approx(0.75)
    assert [n for n, _, _ in tr.kernels] == ["k_a", "k_b"]

"""The port's evaluation entry point against the JAX package's, on the CPU:
`load_maps`, the reference-checkpoint import (leaf by leaf, exactly, and
the config fields) and `cli.evaluate.main` with `--packed 2` and
`--packed 0` on 4 maps at 32^2 (the saved rmse at rtol 1e-3, the unpacked
port tests' tolerance).

The checkpoint is synthetic: the trained weights of
trained_models/round1_best_epoch890.npz under the reference's
PyTorch-Lightning names, written with `torch.save`, with hyper-parameters
for a 32^2 grid whose PML (4 cells) and source fit.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from helmnet_tpu.cli import evaluate as jeval
from helmnet_tpu.data.ellipses import load_maps as jax_load_maps
from helmnet_tpu.train.checkpoint import load_reference_checkpoint as jax_load_ckpt
from helmnet_tpu_torch.cli import evaluate as teval
from helmnet_tpu_torch.core.config import Config
from helmnet_tpu_torch.data.ellipses import load_maps
from helmnet_tpu_torch.models.hybridnet import iter_leaves
from helmnet_tpu_torch.solvers.iterative import IterativeSolver
from helmnet_tpu_torch.train.checkpoint import load_reference_checkpoint
from helmnet_tpu_torch.weights import from_jax_params, load_params_npz
from tests.test_torch_iterative import NPZ

HPARAMS = dict(domain_size=32, PMLsize=4, sigma_max=2.0, max_iterations=50,
               source_location=[26, 16], source_amplitude=10.0,
               activation_function="prelu", features=8, depth=4,
               state_depth=4, state_channels=2)
LIGHTNING = ("pytorch_lightning", "pytorch_lightning.utilities",
             "pytorch_lightning.utilities.parsing")


def _state_dict(params) -> dict:
    """The port's params under the reference's `f.*` names."""
    sd = {}

    def dc(prefix, p):
        sd[f"{prefix}.double_conv.0.weight"] = p["c1"]["w"]
        sd[f"{prefix}.double_conv.0.bias"] = p["c1"]["b"]
        sd[f"{prefix}.double_conv.1.weight"] = p["act"]["a"]
        sd[f"{prefix}.double_conv.2.weight"] = p["c2"]["w"]
        sd[f"{prefix}.double_conv.2.bias"] = p["c2"]["b"]

    def conv(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["w"], p["b"]

    dc("f.inc", params["inc"])
    conv("f.outc.conv", params["outc"])
    for d, blk in enumerate(params["enc"]):
        dc(f"f.enc.{d}.conv_signal", blk["conv_signal"])
        dc(f"f.enc.{d}.conv_state", blk["conv_state"])
        conv(f"f.enc.{d}.down", blk["down"])
    for i, blk in enumerate(params["decode"]):
        dc(f"f.decode.{i}", blk)
    for d, blk in enumerate(params["up"]):
        conv(f"f.up.{d}", blk)
    sd["source"] = torch.zeros(1, 2, 32, 32)  # buffers the import ignores
    sd["Lap.kx"] = torch.zeros(32)
    return sd


@pytest.fixture
def ckpt(tmp_path):
    """A lightning-style checkpoint whose hyper-parameters pickle as
    `pytorch_lightning.utilities.parsing.AttributeDict`, a class that the
    importers' shim has to supply when they load it."""
    params = load_params_npz(NPZ, Config(), device="cpu")
    mods = {name: types.ModuleType(name) for name in LIGHTNING}

    class AttributeDict(dict):
        pass

    AttributeDict.__module__ = LIGHTNING[-1]
    AttributeDict.__qualname__ = "AttributeDict"
    mods[LIGHTNING[-1]].AttributeDict = AttributeDict
    saved = {name: sys.modules.get(name) for name in LIGHTNING}
    sys.modules.update(mods)
    path = tmp_path / "synthetic.ckpt"
    try:
        torch.save({"state_dict": _state_dict(params),
                    "hyper_parameters": AttributeDict(HPARAMS)}, path)
    finally:
        for name in LIGHTNING:
            sys.modules.pop(name)
    yield str(path), params
    for name, mod in saved.items():  # drop the importers' shim
        sys.modules.pop(name, None)
        if mod is not None:
            sys.modules[name] = mod


def test_load_maps_and_key_fallback(tmp_path):
    rng = np.random.default_rng(0)
    maps = rng.random((3, 8, 8)).astype(np.float64)
    np.savez(tmp_path / "a.npz", maps=maps, other=np.zeros((2, 2, 2)))
    np.savez(tmp_path / "b.npz", flat=np.zeros(4), val=maps)  # eval256's key
    np.savez(tmp_path / "c.npz", flat=np.zeros(4))
    for name in ("a.npz", "b.npz"):
        got = load_maps(str(tmp_path / name))
        assert got.dtype == np.float32 and got.shape == (3, 8, 8)
        np.testing.assert_array_equal(got, jax_load_maps(str(tmp_path / name)))
    with pytest.raises(KeyError, match="no 3D map array"):
        load_maps(str(tmp_path / "c.npz"))


def test_reference_checkpoint_matches_jax_import(ckpt):
    path, params = ckpt
    got, cfg = load_reference_checkpoint(path, device="cpu")
    ref_params, ref_cfg = jax_load_ckpt(path)
    ref = from_jax_params(_numpy_tree(ref_params), device="cpu")
    got_leaves, ref_leaves = dict(iter_leaves(got)), dict(iter_leaves(ref))
    assert list(got_leaves) == list(ref_leaves) and len(got_leaves) == 88
    for p, r in ref_leaves.items():
        torch.testing.assert_close(got_leaves[p], r, rtol=0, atol=0, msg=p)
    for p, t in iter_leaves(params):  # and it is the tree that was saved
        torch.testing.assert_close(got_leaves[p], t, rtol=0, atol=0, msg=p)
    assert cfg.to_json() == Config.from_json(ref_cfg.to_json()).to_json()
    assert cfg.geometry.domain_size == 32 and cfg.geometry.pml_size == 4
    assert cfg.source.location == (26, 16) and cfg.max_iterations == 50
    solver = IterativeSolver.from_reference_checkpoint(path, device="cpu")
    assert solver.source.shape == (1, 32, 32, 2) and solver.op.height == 32


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.mark.parametrize("packed", ["2", "0"])
def test_cli_matches_jax_cli(ckpt, tmp_path, packed):
    path, _ = ckpt
    rng = np.random.default_rng(0)
    sos = np.ones((4, 32, 32), np.float32)
    sos[:, 10:20, 8:22] = 1.0 + rng.random((4, 10, 14)).astype(np.float32)
    testset = tmp_path / "test.npz"
    np.savez(testset, maps=sos)
    args = ["--checkpoint", path, "--testset", str(testset), "--iterations", "4",
            "--batch", "4", "--packed", packed, "--platform", "cpu"]
    name = "evolution_of_model_RMSE_on_test_set.npy"
    assert jeval.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert teval.main(args + ["--out", str(tmp_path / "port")]) == 0
    ref = np.load(tmp_path / "jax" / name)
    got = np.load(tmp_path / "port" / name)
    assert got.shape == (4, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_cli_reads_orbax_directories(tmp_path):
    """An orbax run of the JAX package (checkpoints/tpu_r2c, read at its
    best step as JAX's CLI reads it) gives the rmse of the npz of that
    step, exactly; a directory with no step raises FileNotFoundError."""
    from tests.torch_solver_cases import R2C_NPZ, R2C_ORBAX, ROOT

    if not os.path.isdir(R2C_ORBAX):
        pytest.skip("checkpoints/tpu_r2c is not present")
    name = "evolution_of_model_RMSE_on_test_set.npy"
    args = ["--testset", os.path.join(ROOT, "datasets", "splitted_96", "testset.npz"),
            "--limit", "2", "--iterations", "3", "--batch", "2", "--platform", "cpu"]
    for ckpt, out in ((R2C_ORBAX, "orbax"), (R2C_NPZ, "npz")):
        assert teval.main(["--checkpoint", ckpt, "--out", str(tmp_path / out)] + args) == 0
    got, want = np.load(tmp_path / "orbax" / name), np.load(tmp_path / "npz" / name)
    assert got.shape == (2, 3) and np.array_equal(got, want)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        teval.main(["--checkpoint", str(tmp_path), "--testset", "x.npz",
                    "--platform", "cpu"])


def test_cli_raises_without_a_card(ckpt, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.main(["--checkpoint", ckpt[0], "--testset", "x.npz"])

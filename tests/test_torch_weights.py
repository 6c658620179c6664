"""The port's weight loader against the JAX package's, on the CPU.

`load_params_npz` reads the flat `p0 ... pN` npz without JAX; it must give
exactly what `from_jax_params` makes of the JAX package's own
`load_params_npz`, leaf by leaf.
"""

import os

import jax
import numpy as np
import pytest
import torch

from helmnet_tpu.core.config import Config as JConfig
from helmnet_tpu.models import hybridnet as jh
from helmnet_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from helmnet_tpu_torch.core.config import Config as TConfig
from helmnet_tpu_torch.models import hybridnet as th
from helmnet_tpu_torch.weights import from_jax_params, leaf_paths, load_params_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = ["round1_best_epoch890.npz", "round1_fixed_best_epoch720.npz"]


@pytest.mark.parametrize("name", NPZ)
def test_npz_loader_matches_jax_loader(name):
    path = os.path.join(ROOT, "trained_models", name)
    got = load_params_npz(path, TConfig(), device="cpu")
    ref = from_jax_params(
        jax.tree.map(np.asarray, jax_load_params_npz(path, JConfig())),
        device="cpu",
    )
    got_leaves, ref_leaves = list(th.iter_leaves(got)), list(th.iter_leaves(ref))
    assert len(got_leaves) == len(ref_leaves) == 88
    for (gp, g), (rp, r) in zip(got_leaves, ref_leaves):
        assert gp == rp
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_leaf_paths_follow_jax_tree_order():
    paths = leaf_paths(TConfig())
    assert len(paths) == 88
    assert paths[:5] == ["decode[0].act.a", "decode[0].c1.b", "decode[0].c1.w",
                         "decode[0].c2.b", "decode[0].c2.w"]
    assert paths[-2:] == ["up[3].b", "up[3].w"]
    shapes = jax.eval_shape(lambda k: jh.init_params(k, JConfig().model),
                            jax.random.PRNGKey(0))
    jpaths = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    norm = [p.replace("['", ".").replace("']", "").lstrip(".") for p in jpaths]
    assert norm == paths


def test_transposed_conv_weights_are_unflipped():
    path = os.path.join(ROOT, "trained_models", NPZ[0])
    got = load_params_npz(path, TConfig(), device="cpu")
    with np.load(path) as f:
        hwio = f[f"p{leaf_paths(TConfig()).index('up[0].w')}"]
    # port layout [I, O, kh, kw]; JAX keeps the flipped [kh, kw, I, O]
    np.testing.assert_array_equal(got["up"][0]["w"].numpy(),
                                  np.transpose(hwio[::-1, ::-1], (2, 3, 0, 1)))


def test_mismatch_raises(tmp_path):
    src = os.path.join(ROOT, "trained_models", NPZ[0])
    with np.load(src) as f:
        arrays = {k: f[k] for k in f.files}
    short = dict(arrays)
    del short["p87"]
    np.savez(tmp_path / "short.npz", **short)
    with pytest.raises(ValueError, match="88"):
        load_params_npz(str(tmp_path / "short.npz"), TConfig(), device="cpu")
    bad = dict(arrays, p2=np.zeros((3, 3, 15, 8), np.float32))
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="p2"):
        load_params_npz(str(tmp_path / "bad.npz"), TConfig(), device="cpu")

"""The port's reader of the JAX package's orbax checkpoints, without JAX
(core/zstd.py, train/orbax.py):

- the zstd decoder against `zstandard` (imported here only, never by the
  port): levels -5, 1, 3 and 19, with and without a content checksum, on
  0 B, 1 B, 1 KB and 150,013 B (several blocks; a length that reaches
  every tail of XXH64) of constant bytes, random bytes, text and float32
  values; then the block kinds those leave out (single-stream and
  treeless Huffman literals, direct Huffman weights, a frame without a
  content size, skippable and concatenated frames); a truncated frame, a
  bit-flipped one and one that names a dictionary raise;
- `OcdbtStore` against tensorstore's `ocdbt` kvstore, every key and value
  byte for byte, on one step each of tpu_r2c, tpu_r3c1024 and
  sharded_quality_dyx (written from a mesh), and on a database written
  here with small nodes (interior nodes, a version tree, no compression);
- the key list of every step of the 13 orbax runs in `checkpoints/`
  against its `_METADATA` (nodes only);
- `read_step` against `trained_models/tpu_r2c_best.npz` and the pytree's
  leaves against `_METADATA`;
- a run that holds both formats: `Trainer.fit(ckpt_dir=)` on a copy of
  tpu_r2c at top_k=2 adds a `state.pt` step and deletes only the orbax
  step the manifest ranks out; each step is then read in its own format.

The JAX side (orbax's restore against `from_orbax_checkpoint` and
`Trainer.restore`) is in test_torch_orbax_npz.py, beside that file's
restore.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from helmnet_tpu_torch.core import zstd
from helmnet_tpu_torch.core.config import Config
from helmnet_tpu_torch.models.hybridnet import iter_leaves
from helmnet_tpu_torch.train import checkpoint as tckpt
from helmnet_tpu_torch.train import orbax
from helmnet_tpu_torch.weights import load_params_npz, load_params_orbax
from tests.torch_solver_cases import R2C_NPZ, R2C_ORBAX, ROOT

CKPT = os.path.join(ROOT, "checkpoints")
RUNS = ("tpu_r1b", "tpu_r1c", "tpu_r1d", "tpu_r2a", "tpu_r2b", "tpu_r2c",
        "tpu_r3a", "tpu_r3b512", "tpu_r3c1024", "tpu_r3d", "tpu_r4d",
        "sharded_quality_dyx", "sharded_quality_none")
STEPS = ("tpu_r2c/step_940", "tpu_r3c1024/step_40", "sharded_quality_dyx/step_425")


def _need(path):
    if not os.path.exists(path):
        pytest.skip(f"{os.path.relpath(path, ROOT)} is not present")


def _payload(kind: str, size: int) -> bytes:
    rng = np.random.default_rng(size)
    if kind == "constant":
        return b"\x07" * size
    if kind == "random":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    if kind == "text":
        with open(os.path.join(ROOT, "README.md"), "rb") as f:
            text = f.read()
        return (text * (size // len(text) + 1))[:size]
    return rng.standard_normal(size // 4 + 1).astype(np.float32).tobytes()[:size]


@pytest.mark.parametrize("kind", ["constant", "random", "text", "float32"])
@pytest.mark.parametrize("size", [0, 1, 1024, 150_013])
@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_zstd_decodes_zstandard_frames(level, checksum, size, kind):
    zstandard = pytest.importorskip("zstandard")
    data = _payload(kind, size)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


def _frames(case: str):
    """(frames, content) for the block kinds the cases above leave out."""
    zstandard = pytest.importorskip("zstandard")
    rng = np.random.default_rng(0)
    if case == "single_stream_literals":  # Huffman literals in 1 stream
        data = _payload("text", 300)
    elif case == "direct_huffman_weights":  # 16 symbols: 4-bit weights
        data = rng.integers(0, 16, 3000, dtype=np.uint8).tobytes()
    elif case == "treeless_literals":  # later blocks repeat the Huffman tree
        words = [bytes(rng.integers(97, 123, 4, dtype=np.uint8)) for _ in range(50)]
        data = b" ".join(words[i] for i in rng.integers(0, 50, 80_000))
        return zstandard.ZstdCompressor(level=1).compress(data), data
    elif case == "no_content_size":  # streamed: a window descriptor instead
        data = _payload("float32", 140_000)
        c = zstandard.ZstdCompressor(level=3).compressobj()
        return c.compress(data) + c.flush(), data
    else:  # a skippable frame between two frames
        a, b = _payload("text", 700), _payload("float32", 900)
        skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
        cz = zstandard.ZstdCompressor(level=3)
        return cz.compress(a) + skip + cz.compress(b), a + b
    return zstandard.ZstdCompressor(level=3).compress(data), data


@pytest.mark.parametrize("case", ["single_stream_literals", "direct_huffman_weights",
                                  "treeless_literals", "no_content_size",
                                  "skippable_and_concatenated"])
def test_zstd_decodes_every_block_kind(case):
    frames, data = _frames(case)
    assert zstd.decompress(frames) == data


def test_zstd_refuses_malformed_frames():
    zstandard = pytest.importorskip("zstandard")
    data = _payload("text", 5000)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(frame[:-9])
    flipped = bytearray(frame)
    flipped[len(frame) // 2] ^= 0x10
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(flipped))
    # the same frame with a 1-byte Dictionary_ID (42) in its header
    desc = frame[4]
    head = 6 if desc & 0x20 == 0 else 5  # after the window descriptor, if any
    named = frame[:4] + bytes([desc | 1]) + frame[5:head] + b"\x2a" + frame[head:]
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(named)
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


def _tensorstore_items(root):
    ts = pytest.importorskip("tensorstore")
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + os.path.abspath(root) + "/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


@pytest.mark.parametrize("step", STEPS)
def test_ocdbt_store_equals_tensorstore(step):
    root = os.path.join(CKPT, step)
    _need(root)
    store = orbax.OcdbtStore(root)
    want = _tensorstore_items(root)
    assert store.keys == sorted(want)
    for k, v in want.items():
        assert store.get(k) == v, k


def test_ocdbt_store_reads_interior_nodes_and_version_trees(tmp_path):
    """Nodes of at most 300 bytes (a B+tree of height 6), two versions a
    version-tree node and five commits, values over 20 bytes in data
    files, no compression."""
    ts = pytest.importorskip("tensorstore")
    base = "file://" + str(tmp_path) + "/"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": base, "config": {
        "max_decoded_node_bytes": 300, "version_tree_arity_log2": 1,
        "max_inline_value_bytes": 20, "compression": None}}).result()
    for c in range(5):
        with ts.Transaction() as txn:
            for i in range(40):
                kv.with_transaction(txn)[f"grp{i % 3}/key{c:02d}_{i:03d}"] = (
                    f"value{c}_{i}" * (1 + i % 4)).encode()
    store = orbax.OcdbtStore(str(tmp_path))
    want = _tensorstore_items(tmp_path)
    assert len(want) == 200 and store.keys == sorted(want)
    assert all(store.get(k) == v for k, v in want.items())


def _array_names(meta):
    return sorted(".".join(str(k["key"]) for k in e["key_metadata"])
                  for e in meta["tree_metadata"].values()
                  if not e["value_metadata"].get("skip_deserialize"))


@pytest.mark.parametrize("run", RUNS)
def test_every_step_lists_its_metadata_arrays(run):
    directory = os.path.join(CKPT, run)
    _need(directory)
    steps = sorted(n for n in os.listdir(directory) if n.startswith("step_"))
    assert steps
    for name in steps:
        step = os.path.join(directory, name)
        with open(os.path.join(step, "_METADATA")) as f:
            want = _array_names(json.load(f))
        keys = [k.decode() for k in orbax.OcdbtStore(step).keys]
        assert sorted({k.rsplit("/", 1)[0] for k in keys}) == want, name
        assert {f"{a}/.zarray" for a in want} <= set(keys), name


def test_read_step_equals_the_exported_npz():
    """tpu_r2c's best step (940) through `read_step` and the port's
    layouts: the committed npz to the bit; the tree's leaves as
    `_METADATA` lists them, every array finite."""
    step = os.path.join(R2C_ORBAX, "step_940")
    _need(step)
    got = load_params_orbax(step, Config(), device="cpu")
    want = load_params_npz(R2C_NPZ, Config(), device="cpu")
    pairs = list(zip(iter_leaves(got), iter_leaves(want)))
    assert len(pairs) == 88
    for (path, a), (wpath, b) in pairs:
        assert path == wpath and torch.equal(a, b), path
    tree = orbax.read_step(step)
    assert int(tree["epoch"]) == 940 and tree["opt_state"]["inner_state"][0] is None
    assert tree["opt_state"]["hyperparams_states"] == {}
    with open(os.path.join(step, "_METADATA")) as f:
        names = _array_names(json.load(f))
    arrays = [a for _, a in iter_leaves(tree) if isinstance(a, np.ndarray)]
    assert len(arrays) == len(names) == 269
    assert all(np.isfinite(a).all() for a in arrays)


def _port_trainer():
    """tests/test_training.py:20's tiny config (32^2, full width)."""
    from helmnet_tpu_torch.core import config as tconf
    from helmnet_tpu_torch.train.loop import Trainer

    cfg = tconf.Config(
        max_iterations=50,
        geometry=tconf.GeometryConfig(domain_size=32, pml_size=4, sigma_max=2.0),
        source=tconf.SourceConfig(amplitude=10.0, location=(26, 16)),
        training=tconf.TrainingConfig(buffer_size=16, train_batch_size=4,
                                      unrolling_steps=3))
    return Trainer(cfg, device="cpu")


def test_fit_prunes_a_mixed_run_as_the_manifest_ranks(tmp_path):
    """`fit(ckpt_dir=)` on a copy of tpu_r2c (orbax steps 940, 950, 970)
    resumes at 970, trains an epoch and saves step 971 as `state.pt` with
    no val loss (1e30); at top_k=2 the manifest keeps 940 and 950 and the
    latest, and only 970 goes. The kept orbax steps are untouched and each
    step is read in its own format."""
    _need(R2C_ORBAX)
    run = tmp_path / "tpu_r2c"
    shutil.copytree(R2C_ORBAX, run)
    before = {n: sorted(os.listdir(run / n)) for n in ("step_940", "step_950")}
    from helmnet_tpu_torch.data.ellipses import make_dataset

    tt = _port_trainer()
    tt.fit(make_dataset(8, 32, seed=0), num_epochs=1, ckpt_dir=str(run), top_k=2)
    assert sorted(n for n in os.listdir(run) if n.startswith("step_")) == [
        "step_940", "step_950", "step_971"]
    assert os.listdir(run / "step_971") == ["state.pt"]
    for name, files in before.items():
        assert sorted(os.listdir(run / name)) == files
        assert orbax.is_orbax_step(str(run / name))
    manifest = json.loads((run / "manifest.json").read_text())
    assert sorted(manifest["scores"], key=int) == ["940", "950", "971"]
    assert tckpt.latest_step(str(run)) == 971 and tckpt.best_step(str(run)) == 940
    latest = tckpt.restore_checkpoint(str(run), 971, device="cpu")
    assert latest["epoch"] == 971 and latest["global_step"] > 272570
    best = tckpt.restore_checkpoint(str(run), 940, device="cpu")
    assert best["epoch"] == 940
    again = _port_trainer()
    assert again.restore(str(run), best=True) and again.epoch == 940
    assert again.restore(str(run)) and again.epoch == 971

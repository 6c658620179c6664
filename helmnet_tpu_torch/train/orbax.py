"""The JAX package's orbax checkpoints, read with numpy alone.

`helmnet_tpu.train.checkpoint.save_checkpoint` writes each step of a
training run with orbax's `PyTreeCheckpointer` as `step_<n>/`: the
pytree's structure in `_METADATA` and every leaf as a zarr v2 array in an
OCDBT key-value store (tensorstore's "kvstore/ocdbt" format). This module
reads such a step without JAX, orbax, tensorstore or a compiled codec:

- `OcdbtStore`: the manifest (`manifest.ocdbt`), the latest version of
  its version tree, and the B+tree below it (interior and leaf nodes,
  their data-file tables, keys, and values inline or referenced into data
  files, such as the root database's references into
  `ocdbt.process_0/`). Each manifest and node is checked against its
  CRC-32C and decoded with `core/zstd.py`.
- `read_zarr(store, name)`: a zarr v2 array (`<name>/.zarray`: dtype,
  shape, chunks, dimension separator, fill value, zstd compressor; chunk
  keys `i.j...`, `0` for a scalar).
- `read_step(step_dir)`: the pytree, rebuilt from `_METADATA`'s
  `tree_metadata` key paths (dicts and lists; `None` and empty-dict leaves
  as orbax wrote them).
- `train_state(step_dir, device)`: the step in the port's train-state form
  (`train/checkpoint.py`): params converted to the port's layouts
  (`weights.from_jax_params`), optax's Adam moments (`inner_state[2]`'s
  `mu`, `nu`, `count`) as `torch.optim.Adam` state in `make_optimizer`'s
  leaf order, the injected learning rate, the epoch and the global step.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..core import zstd

__all__ = ["OcdbtStore", "is_orbax_step", "read_step", "read_zarr",
           "train_state"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE


class OrbaxFormatError(ValueError):
    """An orbax step that this reader cannot read."""


def is_orbax_step(step_dir: str) -> bool:
    """Whether `step_dir` is an orbax step (its `_METADATA` and OCDBT
    manifest), as against the port's `state.pt`."""
    return (os.path.isfile(os.path.join(step_dir, "_METADATA"))
            and os.path.isfile(os.path.join(step_dir, "manifest.ocdbt")))


# ---------------------------------------------------------------------------
# Encodings
# ---------------------------------------------------------------------------


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Varints, fixed-width integers and byte strings from a body."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def varint(self) -> int:
        v = shift = 0
        data = self.data
        while True:
            if self.pos >= len(data):
                raise OrbaxFormatError("truncated varint")
            c = data[self.pos]
            self.pos += 1
            v |= (c & 0x7F) << shift
            if c < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OrbaxFormatError("varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OrbaxFormatError("truncated OCDBT body")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def fixed(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")


def _unwrap(blob: bytes, magic: int, what: str) -> bytes:
    """The body of an OCDBT manifest or node: magic (u32 big-endian),
    length (u64), format version and compression (varints), the body
    (zstd or raw), CRC-32C (u32) of everything before it."""
    if len(blob) < 18 or int.from_bytes(blob[:4], "big") != magic:
        raise OrbaxFormatError(f"{what}: bad magic")
    if int.from_bytes(blob[4:12], "little") != len(blob):
        raise OrbaxFormatError(f"{what}: length field disagrees with the data")
    if crc32c(blob[:-4]) != int.from_bytes(blob[-4:], "little"):
        raise OrbaxFormatError(f"{what}: CRC-32C mismatch")
    r = _Reader(blob[:-4])
    r.pos = 12
    if r.varint() != 0:
        raise OrbaxFormatError(f"{what}: unknown format version")
    compression = r.varint()
    body = blob[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise OrbaxFormatError(f"{what}: unknown compression {compression}")


def _data_file_table(r: _Reader, transitive: str) -> list:
    """Data-file paths relative to the database root: each entry's base
    path after `transitive`, the base path of the file holding the table."""
    n = r.varint()
    prefix = r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths = []
    prev = b""
    for i in range(n):
        p = (prev[:prefix[i - 1]] if i else b"") + r.take(suffix[i])
        if base[i] > len(p):
            raise OrbaxFormatError("data-file base path longer than its path")
        paths.append((transitive + p[:base[i]].decode(), p[base[i]:].decode()))
        prev = p
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> tuple[list, list]:
    """Prefix-coded keys, and for an interior node each child's
    subtree-common-prefix length."""
    prefix = r.varints(n - 1)
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys = []
    prev = b""
    for i in range(n):
        if i and prefix[i - 1] > len(prev):
            raise OrbaxFormatError("key prefix longer than the previous key")
        k = (prev[:prefix[i - 1]] if i else b"") + r.take(suffix[i])
        keys.append(k)
        prev = k
    return keys, common


# ---------------------------------------------------------------------------
# The key-value store
# ---------------------------------------------------------------------------


class OcdbtStore:
    """The latest version of an OCDBT database in `root`: its keys (bytes)
    and their values (`get`)."""

    def __init__(self, root: str):
        self.root = root
        self._files: dict = {}
        r = _Reader(_unwrap(self._file("manifest.ocdbt"), MANIFEST_MAGIC,
                            os.path.join(root, "manifest.ocdbt")))
        r.take(16)  # uuid
        if r.varint() != 0:
            raise OrbaxFormatError(
                f"{root}: a numbered manifest; orbax writes a single one")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.u8()  # version_tree_arity_log2
        if r.varint() == 1:  # zstd nodes, then their level (int32)
            r.fixed(4)
        files = _data_file_table(r, "")
        n = r.varint()
        if n == 0:
            raise OrbaxFormatError(f"{root}: a manifest with no version")
        generation = r.varints(n)
        height = [r.u8() for _ in range(n)]
        fid = r.varints(n)
        offset = r.varints(n)
        length = r.varints(n)
        num_keys = r.varints(n)
        r.varints(n)  # num_tree_bytes
        r.varints(n)  # num_indirect_value_bytes
        r.take(8 * n)  # commit times
        latest = max(range(n), key=generation.__getitem__)
        self._values: dict = {}
        if num_keys[latest]:
            if fid[latest] >= len(files):
                raise OrbaxFormatError("root node names no data file")
            self._walk(files[fid[latest]], offset[latest], length[latest],
                       height[latest], b"")
        self.keys = sorted(self._values)

    def _file(self, path: str) -> bytes:
        if path not in self._files:
            with open(os.path.join(self.root, path), "rb") as f:
                self._files[path] = f.read()
        return self._files[path]

    def _slice(self, file: tuple, offset: int, length: int) -> bytes:
        data = self._file(file[0] + file[1])
        if offset + length > len(data):
            raise OrbaxFormatError(f"{file[0] + file[1]}: reference past its end")
        return data[offset:offset + length]

    def _walk(self, file: tuple, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        body = _unwrap(self._slice(file, offset, length), NODE_MAGIC,
                       file[0] + file[1])
        r = _Reader(body)
        if r.u8() != height:
            raise OrbaxFormatError("node height disagrees with its reference")
        files = _data_file_table(r, file[0])
        n = r.varint()
        if n == 0:
            raise OrbaxFormatError("empty B+tree node")
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
            if r.pos != len(body):
                raise OrbaxFormatError("bytes after an interior node")
            for i in range(n):
                if fid[i] >= len(files) or common[i] > len(keys[i]):
                    raise OrbaxFormatError("corrupt interior node entry")
                self._walk(files[fid[i]], off[i], ln[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise OrbaxFormatError("unknown value kind")
        indirect = [i for i in range(n) if kinds[i]]
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(fid, off)))
        for i in range(n):
            if i in refs:
                f, o = refs[i]
                if f >= len(files):
                    raise OrbaxFormatError("value names no data file")
                self._values[prefix + keys[i]] = (files[f], o, lengths[i])
            else:
                self._values[prefix + keys[i]] = r.take(lengths[i])
        if r.pos != len(body):
            raise OrbaxFormatError("bytes after a leaf node")

    def get(self, key) -> bytes:
        """The value of `key` (str or bytes); KeyError if absent."""
        v = self._values[key.encode() if isinstance(key, str) else key]
        return self._slice(*v) if isinstance(v, tuple) else v

    def __contains__(self, key) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._values


# ---------------------------------------------------------------------------
# Zarr v2 and the pytree
# ---------------------------------------------------------------------------


def read_zarr(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array `name` of `store`."""
    meta = json.loads(store.get(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise OrbaxFormatError(f"{name}: not a plain zarr v2 array")
    dtype = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    order = meta.get("order", "C")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp.get('id')!r}")
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype=dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue  # a chunk equal to the fill value
        raw = store.get(key)
        if comp is not None:
            raw = zstd.decompress(raw)
        chunk = np.frombuffer(raw, dtype=dtype)
        if chunk.size != int(np.prod(chunks)):
            raise OrbaxFormatError(f"{key}: {chunk.size} elements, chunk {chunks}")
        chunk = chunk.reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def read_step(step_dir: str, subtree: str | None = None) -> dict:
    """An orbax step's pytree: nested dicts (string keys) and lists of
    numpy arrays, `None` and `{}` where orbax stored no array. With
    `subtree` (a top-level key, such as "params"), only that key's leaves."""
    with open(os.path.join(step_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise OrbaxFormatError(
            f"{step_dir}: not an OCDBT step of zarr v2 arrays")
    store = OcdbtStore(step_dir)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        path = entry["key_metadata"]
        if subtree is not None and str(path[0]["key"]) != subtree:
            continue
        value = entry["value_metadata"]
        kind = value["value_type"]
        if value.get("skip_deserialize"):
            leaf: Any = {} if kind == "Dict" else None
        else:
            leaf = read_zarr(store, ".".join(str(k["key"]) for k in path))
        node = tree
        for depth, k in enumerate(path):
            key = int(k["key"]) if k["key_type"] == 1 else str(k["key"])
            last = depth == len(path) - 1
            child_kind = (None if last else
                          list if path[depth + 1]["key_type"] == 1 else dict)
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if last:
                    node[key] = leaf
                elif node[key] is None:
                    node[key] = child_kind()
                node = node[key]
            else:
                if last:
                    node[key] = leaf
                else:
                    node = node.setdefault(key, child_kind())
    return tree


def _adam(opt_state: dict) -> dict:
    """optax's `inject_hyperparams(chain(clip, add_decayed_weights,
    scale_by_adam, scale))` state: the `scale_by_adam` entry."""
    for entry in opt_state["inner_state"]:
        if isinstance(entry, dict) and {"mu", "nu", "count"} <= set(entry):
            return entry
    raise OrbaxFormatError("no Adam state (mu, nu, count) in the optimizer state")


def train_state(step_dir: str, device=None) -> dict:
    """The step as the port's train state: `params` (port layouts),
    `opt_state` (a `torch.optim.Adam` state dict over the params' leaves
    in tree order, its one param group holding only the injected learning
    rate), `epoch` and `global_step`."""
    from ..models.hybridnet import iter_leaves
    from ..weights import from_jax_params

    tree = read_step(step_dir)
    params = from_jax_params(tree["params"], device=device)
    opt = tree["opt_state"]
    adam = _adam(opt)
    mu = iter_leaves(from_jax_params(adam["mu"], device=device))
    nu = iter_leaves(from_jax_params(adam["nu"], device=device))
    step = torch.tensor(float(adam["count"]), dtype=torch.float32)
    state = {}
    for i, ((path, m), (npath, v)) in enumerate(zip(mu, nu)):
        if path != npath:
            raise OrbaxFormatError("Adam moments with different trees")
        state[i] = {"step": step.clone(), "exp_avg": m, "exp_avg_sq": v}
    lr = float(np.float32(opt["hyperparams"]["learning_rate"]))
    return {
        "params": params,
        "opt_state": {"state": state, "param_groups": [{"lr": lr}]},
        "epoch": int(tree["epoch"]),
        "global_step": int(tree["global_step"]),
    }

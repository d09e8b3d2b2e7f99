"""Checkpoints with restart semantics, the port of the reference's
``repro.training.checkpoint`` in its on-disk format, so a checkpoint either
package writes restores in the other bit for bit.

Layout:  <dir>/step_<k>/
            manifest.json       — leaf shapes and dtypes, the shard's
                                  sha256, the caller's ``extra`` (the data
                                  cursor)
            shard_<host>.npz    — this host's leaves, one array each

A leaf's name is its key path joined by "/": dict keys, tuple and list
indices, NamedTuple field names (``TrainState``'s ``params``, ``opt``,
``ef``), as the reference's ``_flatten`` spells ``jax.tree_util`` paths; a
``None`` holds no leaf. bfloat16 leaves are written as float32 (exact).
Restore checks the hash, the leaf set and every shape, and casts each leaf
to the dtype of the tree it is restored into.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.bridge import to_numpy


def _items(tree, prefix=()):
    """(key path, leaf) pairs of ``tree``: NamedTuples by field name, dicts
    by key, tuples and lists by index; ``None`` has no leaves."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, t in zip(tree._fields, tree):
            yield from _items(t, prefix + (name,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _items(t, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _flatten(tree) -> dict:
    return dict(_items(tree))


def _rebuild(tree, restored, prefix=()):
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(t, restored, prefix + (name,))
                            for name, t in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _rebuild(v, restored, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, restored, prefix + (str(i),))
                          for i, t in enumerate(tree))
    return restored["/".join(prefix)]


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def save(directory: str, step: int, tree, *, extra: dict | None = None,
         host_id: int = 0) -> str:
    """Write one checkpoint. Atomic: writes to .tmp then renames."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: to_numpy(v) for k, v in _flatten(tree).items()}
    shard_path = os.path.join(tmp, f"shard_{host_id}.npz")
    np.savez(shard_path, **arrays)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "shards": {str(host_id): {"file": f"shard_{host_id}.npz",
                                  "sha256": _sha256(shard_path)}},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(directory: str, step: int, tree_like, *, device=None,
            host_id: int = 0):
    """Load a checkpoint into the structure of ``tree_like`` (tensors, on
    any device — the ``meta`` device will do — giving each leaf's shape and
    dtype). Returns (tree on ``device``, the manifest's ``extra``). Raises
    on a hash mismatch, a missing leaf or a shape that differs."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    shard = manifest["shards"][str(host_id)]
    path = os.path.join(d, shard["file"])
    if _sha256(path) != shard["sha256"]:
        raise IOError(f"checkpoint shard corrupt: {path}")
    data = np.load(path)
    leaves = _flatten(tree_like)
    missing = set(leaves) - set(data.files)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
    restored = {}
    for k, like in leaves.items():
        arr = data[k]
        want = tuple(like.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{k}: shape {arr.shape} != expected {want}")
        restored[k] = torch.from_numpy(np.array(arr)).to(device=device,
                                                          dtype=like.dtype)
    return _rebuild(tree_like, restored), manifest["extra"]

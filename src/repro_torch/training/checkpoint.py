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

A sharded state (DTensor leaves, the ``--production`` mesh) is saved whole,
leaf by leaf: every rank joins each leaf's gather and rank 0 alone writes,
so the card never holds more than one gathered leaf and the file is the
one an unsharded run writes. ``restore(..., shardings=(mesh, specs))``
puts it back onto any mesh (the elastic restart after
``fault_tolerance.remesh_after_failure``): each rank reads one leaf at a
time on the host and moves only its own shard to its device.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import zipfile

import numpy as np
import torch

from repro_torch.bridge import to_numpy
from repro_torch.sharding.planner import Spec, distribute

#: bytes hashed at a time: a shard holds the whole f32 state
_HASH_CHUNK = 4 << 20


def _items(tree, prefix=()):
    """(key path, leaf) pairs of ``tree``: NamedTuples by field name, dicts
    by key, tuples and lists by index; ``None`` has no leaves, a ``Spec``
    is one."""
    if tree is None:
        return
    if isinstance(tree, Spec):               # a sharding's leaf
        yield "/".join(prefix), tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
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
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_HASH_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def save(directory: str, step: int, tree, *, extra: dict | None = None,
         host_id: int = 0) -> str:
    """Write one checkpoint. Atomic: writes to .tmp then renames. Under a
    process group every rank calls it: each DTensor leaf is gathered whole
    (one at a time), rank 0 writes, and no rank returns before the
    rename (the directory is one all ranks share)."""
    from repro_torch.kernels.sharded import is_dtensor
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    writer = _rank() == 0
    shard_path = os.path.join(tmp, f"shard_{host_id}.npz")
    if writer:
        os.makedirs(tmp, exist_ok=True)
    leaves = {}
    # np.savez's layout (stored .npy members), written a leaf at a time
    with (zipfile.ZipFile(shard_path, "w", allowZip64=True) if writer
          else contextlib.nullcontext()) as zf:
        for k, v in _flatten(tree).items():
            if is_dtensor(v):
                v = v.full_tensor()          # every rank joins
            if writer:
                arr = to_numpy(v)
                leaves[k] = {"shape": list(arr.shape),
                             "dtype": str(arr.dtype)}
                with zf.open(k + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
    if writer:
        manifest = {
            "step": step,
            "leaves": leaves,
            "shards": {str(host_id): {"file": f"shard_{host_id}.npz",
                                      "sha256": _sha256(shard_path)}},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    _barrier()
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _flat_specs(specs, names) -> dict:
    """A sharding's spec tree flattened, checked leaf by leaf against the
    leaf names of the tree it lays out: raises naming the first leaf where
    the two differ."""
    flat = _flatten(specs)
    names, got = list(names), list(flat)
    for i in range(max(len(names), len(got))):
        a = names[i] if i < len(names) else None
        b = got[i] if i < len(got) else None
        if a != b:
            raise ValueError(f"shardings differ from tree_like at leaf "
                             f"{a or b!r}: tree_like has {a!r}, shardings "
                             f"{b!r}")
        if not isinstance(flat[b], Spec):
            raise ValueError(f"shardings leaf {b!r} is {flat[b]!r}, not a "
                             f"Spec")
    return flat


def restore(directory: str, step: int, tree_like, *, shardings=None,
            device=None, host_id: int = 0):
    """Load a checkpoint into the structure of ``tree_like`` (tensors, on
    any device — the ``meta`` device will do — giving each leaf's shape and
    dtype). Returns (tree, the manifest's ``extra``). Raises on a hash
    mismatch, a missing leaf or a shape that differs.

    ``shardings``: None, or a pair ``(mesh, specs)`` — a ``DeviceMesh``
    and a ``Spec`` tree of ``tree_like``'s structure (``train_state_specs``
    of the plan), the port's counterpart of the reference's tree of
    ``NamedSharding``. Each leaf then comes back a DTensor on ``mesh``
    laid out by its spec, as ``planner.distribute`` lays one out, the mesh
    free to differ from the one the checkpoint was saved on; every rank of
    the mesh calls this. Without it each leaf is a tensor on ``device``."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    shard = manifest["shards"][str(host_id)]
    path = os.path.join(d, shard["file"])
    if _sha256(path) != shard["sha256"]:
        raise IOError(f"checkpoint shard corrupt: {path}")
    leaves = _flatten(tree_like)
    mesh, specs = shardings if shardings is not None else (None, None)
    if mesh is not None:
        specs = _flat_specs(specs, leaves)
    restored = {}
    with np.load(path) as data:
        missing = set(leaves) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing leaves: {sorted(missing)[:5]}")
        for k, like in leaves.items():
            arr = data[k]                    # this leaf alone, on the host
            want = tuple(like.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{k}: shape {arr.shape} != expected {want}")
            t = torch.from_numpy(arr)
            if mesh is None:
                restored[k] = t.to(device=device, dtype=like.dtype)
            else:
                restored[k] = distribute(t, specs[k], mesh,
                                         device=mesh.device_type,
                                         dtype=like.dtype)
    return _rebuild(tree_like, restored), manifest["extra"]

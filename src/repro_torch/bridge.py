"""Numpy bridge between the reference package's trees and the port's.

Parameters, decode caches and migration payloads cross between the JAX
reference and the port as nested dicts of numpy arrays. Leaves are walked in
sorted-key order — the order ``jax.tree.leaves`` walks a dict, and the order
``state_transfer.fingerprint`` hashes — so the same logical state hashes
identically on both sides.

bf16 crosses as float32 numpy, which is exact, so neither side needs a numpy
bf16 type: ``to_numpy`` widens torch bf16 to float32, and ``to_torch`` widens
any numpy array whose dtype numpy itself cannot compute with (such as an
``ml_dtypes`` bfloat16 array handed over by the reference) before narrowing
to the requested torch dtype.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of


def leaves(tree) -> List[Any]:
    """Leaves of a nested dict/tuple/list tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf; containers keep their structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole tensor (``full_tensor``: a collective every rank
    of its mesh joins); any other tensor as it is."""
    from repro_torch.kernels.sharded import is_dtensor
    return x.full_tensor() if is_dtensor(x) else x


def to_numpy(x) -> np.ndarray:
    """One leaf to host numpy (torch bf16 widens to float32; a DTensor
    gives its whole tensor, gathered by every rank of its mesh)."""
    if isinstance(x, torch.Tensor):
        x = _whole(x.detach()).cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def to_torch(x, device=None, dtype=None) -> torch.Tensor:
    """One leaf (torch tensor, numpy array or anything ``np.asarray`` takes)
    to a torch tensor on ``device``; ``dtype`` applies to float leaves. A
    DTensor gives its whole tensor (every rank of its mesh joins)."""
    if isinstance(x, torch.Tensor):
        x = _whole(x)
    else:
        a = np.asarray(x)
        if a.dtype.kind not in "biuf":       # e.g. a bfloat16 extension type
            a = a.astype(np.float32)
        x = torch.from_numpy(np.array(a, order="C"))   # owned, writable
    if dtype is not None and x.is_floating_point():
        x = x.to(dtype)
    return x.to(device)


def tree_to_numpy(tree):
    return tree_map(to_numpy, tree)


def tree_to_torch(tree, device=None, dtype=None):
    return tree_map(lambda x: to_torch(x, device, dtype), tree)


# leaves the reference stores in float32 whatever ``cfg.dtype`` is: norm
# scales (layers.py ``rmsnorm_init``), the MoE router (moe.py ``moe_init``),
# int8 dequantisation scales (quant.py ``quantize_weight``), the RG-LRU
# gates and Λ (rglru.py ``rglru_init``) and the SSD's A_log, D and dt bias
# (ssd.py ``ssd_init``)
F32_KEYS = frozenset(("scale", "router", "s", "gate_a", "gate_i", "lambda",
                      "A_log", "D", "dt_bias"))

# decode-cache leaves the reference keeps in float32 (kvcache.py
# ``init_cache``): the RG-LRU state ``h`` and the SSD state ``ssm``
CACHE_F32_KEYS = frozenset(("h", "ssm"))


def _by_key(tree, f32_keys, device, dtype, key=""):
    """Port tensors of a tree of any array leaves, dicts walked by key and
    tuples/lists in order: float leaves under ``f32_keys`` become float32,
    other float leaves ``dtype``, integer leaves stay as they are."""
    if isinstance(tree, dict):
        return {k: _by_key(v, f32_keys, device, dtype, k)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_by_key(t, f32_keys, device, dtype, key)
                          for t in tree)
    return to_torch(tree, device,
                    torch.float32 if key in f32_keys else dtype)


def params_to_torch(params, cfg: ModelConfig, device=None):
    """A reference param tree (numpy leaves, bf16 as float32 or in its own
    dtype) as port params. Every leaf takes the dtype the reference stores
    it in, decided by its key and not by the dtype it arrives in: the
    leaves under ``F32_KEYS`` are float32, other float leaves take
    ``cfg.dtype``, integer leaves (int8 weights) stay as they are. Works for
    any family's tree (dense, MoE, the hybrid's tuple of layers, SSM,
    encdec)."""
    return _by_key(params, F32_KEYS, device, dtype_of(cfg))


def payload_to_numpy(payload: dict) -> dict:
    """A slot payload with its cache on the host as numpy."""
    out = dict(payload)
    out["cache"] = tree_to_numpy(payload["cache"])
    return out


def payload_to_torch(payload: dict, cfg: ModelConfig, device=None) -> dict:
    """A slot payload (any array leaves; a DTensor, as a transfer with
    ``dst_shardings`` lays one out, gives its whole tensor) with its cache
    as port tensors in the reference's dtypes: the recurrent states under
    ``CACHE_F32_KEYS`` float32, other float leaves ``cfg.dtype``, integer
    leaves as they are."""
    out = dict(payload)
    out["cache"] = _by_key(payload["cache"], CACHE_F32_KEYS, device,
                           dtype_of(cfg))
    return out


def train_state_to_numpy(state) -> dict:
    """A train state (either package's ``TrainState``: params, opt with
    m, v and step, ef) as a dict of numpy trees with the same fields."""
    return {"params": tree_to_numpy(state.params),
            "opt": {"m": tree_to_numpy(state.opt["m"]),
                    "v": tree_to_numpy(state.opt["v"]),
                    "step": to_numpy(state.opt["step"])},
            "ef": None if state.ef is None else tree_to_numpy(state.ef)}


def train_state_to_torch(state, device=None):
    """A train state (either package's ``TrainState``, or the dict
    ``train_state_to_numpy`` makes) as the port's ``TrainState``: every
    float leaf f32 (master weights, moments, residuals), the step int32."""
    from repro_torch.training.train_step import TrainState
    if not isinstance(state, dict):
        state = train_state_to_numpy(state)

    def f32(tree):
        return tree_to_torch(tree, device, torch.float32)
    return TrainState(
        params=f32(state["params"]),
        opt={"m": f32(state["opt"]["m"]), "v": f32(state["opt"]["v"]),
             "step": to_torch(state["opt"]["step"], device).to(torch.int32)},
        ef=None if state["ef"] is None else f32(state["ef"]))

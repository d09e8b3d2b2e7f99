"""Engine-side adapter runtime (data plane).

Loaded adapters live in two stacked f32 tables on the engine's device,
``A: [E, d, r]`` and ``B: [E, r, d]``, where row 0 is the null adapter (all
zeros, so its delta is exactly zero and base sessions are bit-identical to
an adapter-free engine). Each engine slot carries an int32 index into the
tables; the fused K-step decode gathers rows per slot.

Two token-identical routes compute the batched delta:

- ``gather``: per-row gather + f32 einsum (the default on the CPU).
- ``grouped``: slots grouped by adapter index and pushed through the
  grouped-GEMM kernel ``moe_gemm`` (the default on a CUDA device) — the MoE
  dispatch shape with "slots grouped by adapter" standing in for "tokens
  grouped by expert". Empty groups and ragged group sizes need no padding:
  the kernel bounds-checks every edge.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.moe_gemm.moe_gemm import moe_gemm


def lora_apply_rows(h, a, b):
    """Delta for one adapter applied to every row of ``h: [b, d]``
    (prefill path — the whole batch shares one adapter)."""
    hf = h.float()
    t = hf @ a.float()
    return (t @ b.float()).to(h.dtype)


def _delta_gather(h, A, B, idx):
    hf = h.float()
    a = A[idx.long()].float()              # [b, d, r]
    b = B[idx.long()].float()              # [b, r, d]
    t = torch.einsum("bd,bdr->br", hf, a)
    return torch.einsum("br,brd->bd", t, b).to(h.dtype)


def _delta_grouped(h, A, B, idx):
    n, d = h.shape
    E = A.shape[0]
    order = torch.argsort(idx, stable=True)   # groups stay contiguous
    sidx = idx[order].contiguous()
    # position of each row within its adapter group: offset from the
    # first occurrence of its index in the sorted vector
    start = torch.searchsorted(sidx, sidx, side="left")
    pos = torch.arange(n, device=h.device) - start
    # scatter rows into the [E, C, D] expert layout; capacity = n is always
    # enough (each slot maps to exactly one adapter), unused (e, c) cells
    # stay zero
    xg = torch.zeros((E, n, d), dtype=torch.float32, device=h.device)
    xg[sidx.long(), pos] = h[order].float()
    t = moe_gemm(xg, A.float())            # [E, C, r]
    y = moe_gemm(t, B.float())             # [E, C, d]
    delta = y[sidx.long(), pos]            # back to sorted row order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=h.device)
    return delta[inv].to(h.dtype)


def lora_delta(h, A, B, idx, *, route: str = "gather"):
    """Batched per-row adapter delta for ``h: [b, d]`` under the per-slot
    int32 table ``idx: [b]``. Rows with index 0 get an exact zero delta."""
    if route == "grouped":
        return _delta_grouped(h, A, B, idx)
    return _delta_gather(h, A, B, idx)


class AdapterRuntime:
    """Mutable device tables for one engine.

    ``max_adapters`` tenant adapters share the table on top of the reserved
    null row. Adapters of smaller rank are zero-padded up to the table rank,
    which changes nothing numerically (extra columns of A meet extra zero
    rows of B). ``device`` defaults to the CUDA card; ``route="auto"`` is
    ``grouped`` there (the grouped-GEMM kernel) and ``gather`` on the CPU.
    """

    def __init__(self, d_model: int, *, max_adapters: int = 8,
                 rank: int = 8, route: str = "auto", device=None) -> None:
        self.device = resolve_device(device)
        if route == "auto":
            route = "grouped" if self.device.type == "cuda" else "gather"
        if route not in ("gather", "grouped"):
            raise ValueError(f"unknown adapter route {route!r}")
        self.d_model = int(d_model)
        self.rank = int(rank)
        self.max_adapters = int(max_adapters)
        self.route = route
        E = self.max_adapters + 1
        self.A = torch.zeros((E, self.d_model, self.rank),
                             dtype=torch.float32, device=self.device)
        self.B = torch.zeros((E, self.rank, self.d_model),
                             dtype=torch.float32, device=self.device)
        self._index: Dict[str, int] = {}
        self._free: List[int] = list(range(1, E))

    def _fit(self, w, shape: Tuple[int, int]) -> torch.Tensor:
        if isinstance(w, torch.Tensor):
            w = w.detach().cpu().float().numpy()
        w = np.asarray(w, np.float32)
        if w.shape[0] > shape[0] or w.shape[1] > shape[1]:
            raise ValueError(
                f"adapter weights {w.shape} exceed table shape {shape}")
        out = np.zeros(shape, np.float32)
        out[: w.shape[0], : w.shape[1]] = w
        return torch.from_numpy(out).to(self.device)

    def load(self, adapter_id: str, a, b) -> int:
        """Install weights for ``adapter_id``; idempotent. Returns the table
        index slots reference."""
        if adapter_id in self._index:
            return self._index[adapter_id]
        if not self._free:
            raise RuntimeError(
                f"adapter table full ({self.max_adapters} loaded)")
        a = self._fit(a, (self.d_model, self.rank))
        b = self._fit(b, (self.rank, self.d_model))
        idx = self._free.pop(0)
        self.A[idx] = a
        self.B[idx] = b
        self._index[adapter_id] = idx
        return idx

    def unload(self, adapter_id: str) -> None:
        idx = self._index.pop(adapter_id)    # KeyError if not loaded
        self.A[idx] = 0.0
        self.B[idx] = 0.0
        self._free.insert(0, idx)

    def index_of(self, adapter_id: str) -> int:
        """Table index for a session's adapter ("" means none)."""
        if not adapter_id:
            return 0
        if adapter_id not in self._index:
            raise KeyError(adapter_id)
        return self._index[adapter_id]

    def is_loaded(self, adapter_id: str) -> bool:
        return adapter_id in self._index

    def loaded(self) -> Tuple[str, ...]:
        return tuple(sorted(self._index))

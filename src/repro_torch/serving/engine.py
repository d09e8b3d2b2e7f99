"""Slot-based continuous-batching inference engine.

One engine instance = one execution anchor's serving plane for one model:
a fixed decode batch of ``slots`` sequences. Sessions join/leave slots
independently (per-slot positions in the cache make lockstep unnecessary).
The engine is the ``v_cmp`` substrate AIS compute leases reserve against,
and its ``export_slot``/``import_slot`` are the state-transfer primitive
behind make-before-break migration.

Hot-path disciplines:

* **Fused multi-step decode** — ``decode_round(steps=K)`` runs K decode
  steps back to back on the device with on-device greedy sampling and an
  on-device active-slot mask: no host sync inside the K steps and one
  device→host copy of the [slots, K] token block per chunk.
* **Bucketed prefill** — prompts are right-padded to power-of-two buckets
  with the true length passed separately, as in the reference.
* **In-place slot state** — slot insert (admit / migrate in) writes the
  slot's rows of every cache leaf; decode writes each new K/V row, and
  each recurrent state row, in place.
* **Every family's cache** — stacked K/V (dense, MoE), a tuple of per-layer
  RG-LRU states and ring buffers (hybrid, slot-first), stacked conv and SSD
  states (SSM, layer-first): the slot axis is found per leaf, as in the
  reference.
* **Per-session adapters** — an :class:`~repro_torch.adapters.runtime.
  AdapterRuntime` multiplexes LoRA adapters over the base model: each slot
  carries an int32 index into the runtime's tables, and the fused decode
  adds every row's delta to its final hidden state (on the card through the
  grouped-GEMM kernel).
* **Rollback-able speculative rounds** — ``spec_round`` (draft) and
  ``spec_grade`` (verify) run the same fused decode loop, one session
  active, and keep per-step copies of the session's rows of every
  destructive cache leaf, so ``spec_accept`` can restore the state after
  any prefix of the round.
"""

from __future__ import annotations

import itertools
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import leaves, payload_to_torch, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM
from repro_torch.models import kvcache as KV

#: smallest prefill bucket
_MIN_BUCKET = 16


class PagePoolExhausted(RuntimeError):
    """The paged engine has no free KV pages for an allocation. Running out
    of MEMORY (pages) is distinct from running out of decode SLOTS — the
    serving plane maps it to COMPUTE_SCARCITY, and pressure-driven
    reclamation (hibernate the coldest parked sessions) is supposed to keep
    it from firing at all."""


def prefill_buckets(max_len: int) -> List[int]:
    """Power-of-two padded prompt lengths, capped at ``max_len``."""
    out: List[int] = []
    b = _MIN_BUCKET
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


@dataclass
class SlotState:
    session_id: str
    position: int
    tokens_generated: int = 0
    last_token: int = 0
    #: tenant adapter bound to this session ("" = base model)
    adapter_id: str = ""
    #: parked = bound-but-idle: the session keeps its slot (and pages) but
    #: rides decode rounds with active=False, so its state never advances
    parked: bool = False
    #: monotone use tick (engine-local LRU clock, not wall time)
    last_used: int = 0
    #: page ids owned by this slot, in block-table order (paged engines)
    pages: List[int] = field(default_factory=list)


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, params=None, *, slots: int = 8,
                 max_len: int = 512, seed: int = 0,
                 paged: bool = False,
                 page_size: int = KV.DEFAULT_PAGE_SIZE,
                 num_pages: Optional[int] = None,
                 hibernation=None, clock=None, adapters=None, device=None):
        """``paged=True`` selects the block-table paged KV layout for
        families that support it (full-attention stacked KV, see
        ``kvcache.supports_paging``); other families silently keep the
        dense slot layout but still park and hibernate. ``num_pages``
        bounds device KV memory (default: enough for every slot at
        max_len, plus the scratch page). ``hibernation`` is a
        :class:`~repro_torch.serving.hibernation.HibernationStore` (or
        ``True`` for a private unbounded one) enabling the host-memory tier.
        ``clock`` (any object with ``now()``) timestamps hibernation records.
        ``adapters`` is an :class:`~repro_torch.adapters.runtime.
        AdapterRuntime` on this engine's device (or ``True`` for a
        default-sized one) enabling per-session LoRA multiplexing.
        ``device`` defaults to the CUDA card; ``params`` must live on it."""
        self.cfg = cfg
        self.lm = LM(cfg)
        self.device = resolve_device(device)
        self.slots = slots
        self.max_len = max_len
        if params is None:
            params = self.lm.init(seed, self.device)
        self.params = params
        self.paged = bool(paged) and KV.supports_paging(cfg)
        if hibernation is True:
            from repro_torch.serving.hibernation import HibernationStore
            hibernation = HibernationStore()
        if hibernation is False:                   # bool flag, not a store
            hibernation = None
        self.hibernation = hibernation
        self.clock = clock
        #: canonical exports: linear stacked-KV buffers zero their garbage
        #: tail, so the same logical state fingerprints identically across
        #: dense and paged engines and across hibernate/resume round trips
        self._canonical = cfg.family in ("dense", "moe") \
            and not cfg.sliding_window
        #: slot axis of every leaf under cache["layers"]: the hybrid's
        #: per-layer leaves are slot-first, stacked families layer-first
        self._slot_axis = 0 if cfg.family == "hybrid" else 1
        if adapters is True:
            from repro_torch.adapters.runtime import AdapterRuntime
            adapters = AdapterRuntime(cfg.d_model, device=self.device)
        if adapters and adapters.device.type != self.device.type:
            raise ValueError(f"adapter tables on {adapters.device}, engine "
                             f"on {self.device}")
        self.adapters = adapters if adapters else None
        if self.paged:
            self.page_size = KV.page_len(cfg, max_len, page_size)
            self.pages_per_slot = KV.pages_per_slot(max_len, self.page_size)
            full = 1 + slots * self.pages_per_slot      # incl. scratch page
            self.num_pages = full if num_pages is None \
                else max(2, int(num_pages))
            self.cache = self.lm.init_paged_cache(
                slots, max_len, self.num_pages, self.page_size,
                device=self.device)
            # free list excludes page 0 (the shared scratch/null page);
            # popped from the tail so allocation order is ascending
            self._free_page_list: List[int] = \
                list(range(self.num_pages - 1, 0, -1))
            self._block_host = np.zeros((slots, self.pages_per_slot),
                                        np.int32)
        else:
            self.page_size = 0
            self.pages_per_slot = 0
            self.num_pages = 0
            self.cache = self.lm.init_cache(slots, max_len,
                                            device=self.device)
        self._slot_map: Dict[str, int] = {}
        self._slots: list[Optional[SlotState]] = [None] * slots
        self._use_clock = itertools.count(1)
        #: device "pos" may diverge from host truth once any row parks (the
        #: fused loop advances pos unconditionally); set -> resync next round
        self._pos_dirty = False
        self.buckets = prefill_buckets(max_len)
        self._compiled_buckets: set = set()
        # speculative decode: which cache leaves must be snapshotted per
        # step to make a round rollback-able (empty = pos-only)
        self._spec_paths = self._spec_stack_paths()
        self._spec_pending: Dict[str, dict] = {}

    # ------------------------------------------------------------------
    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def has_slot(self, session_id: str) -> bool:
        return session_id in self._slot_map

    def position_of(self, session_id: str) -> int:
        """Current cache position (context length) of one session's slot —
        the authoritative payload size for migration."""
        idx = self._slot_map.get(session_id)
        if idx is None and self.hibernation is not None \
                and self.hibernation.has(session_id):
            return self.hibernation.record(session_id).position
        return self._slots[self._slot_map[session_id]].position

    # -- page-pool / session-tier accounting ----------------------------
    def free_pages(self) -> int:
        return len(self._free_page_list) if self.paged else 0

    def total_pages(self) -> int:
        """Usable pages (the scratch page is never allocatable)."""
        return self.num_pages - 1 if self.paged else 0

    def page_util(self) -> float:
        tot = self.total_pages()
        return 0.0 if tot <= 0 else 1.0 - len(self._free_page_list) / tot

    def pool_bytes(self) -> int:
        if self.paged:
            return KV.paged_cache_bytes(self.cfg, self.slots, self.max_len,
                                        self.num_pages, self.page_size)
        return KV.cache_bytes(self.cfg, self.slots, self.max_len)

    def resident_sessions(self) -> int:
        return len(self._slot_map)

    def parked_sessions(self) -> int:
        return sum(1 for s in self._slots if s is not None and s.parked)

    def hibernated_sessions(self) -> int:
        return len(self.hibernation) if self.hibernation is not None else 0

    def bound_sessions(self) -> int:
        """Sessions whose state this engine holds SOMEWHERE (resident slot
        or hibernation tier)."""
        return self.resident_sessions() + self.hibernated_sessions()

    def is_parked(self, session_id: str) -> bool:
        idx = self._slot_map.get(session_id)
        return idx is not None and self._slots[idx] is not None \
            and self._slots[idx].parked

    def has_hibernated(self, session_id: str) -> bool:
        return self.hibernation is not None \
            and self.hibernation.has(session_id)

    def has_session(self, session_id: str) -> bool:
        return self.has_slot(session_id) or self.has_hibernated(session_id)

    # -- page allocation -------------------------------------------------
    def _alloc_pages(self, n: int) -> List[int]:
        if n > len(self._free_page_list):
            raise PagePoolExhausted(
                f"page pool exhausted: need {n} pages, "
                f"{len(self._free_page_list)} free of {self.total_pages()}")
        return [self._free_page_list.pop() for _ in range(n)]

    def _free_slot_pages(self, idx: int) -> None:
        meta = self._slots[idx]
        if meta is not None and meta.pages:
            self._free_page_list.extend(reversed(meta.pages))
            meta.pages = []
        self._block_host[idx, :] = 0

    def _ensure_pages(self, idx: int, upto_tokens: int) -> bool:
        """Grow slot ``idx``'s block table to cover token indices
        [0, upto_tokens). Under pool pressure, hibernates the coldest
        parked sessions first (LRU reclaim); raises PagePoolExhausted when
        reclamation cannot free enough."""
        meta = self._slots[idx]
        needed = min(-(-max(upto_tokens, 1) // self.page_size),
                     self.pages_per_slot)
        grow = needed - len(meta.pages)
        if grow <= 0:
            return False
        if grow > len(self._free_page_list):
            self._reclaim_pages(grow)
        new = self._alloc_pages(grow)
        meta.pages.extend(new)
        self._block_host[idx, :len(meta.pages)] = meta.pages
        return True

    def _reclaim_pages(self, need: int) -> None:
        """Hibernate coldest parked sessions until ``need`` pages are free
        (best effort; the caller's allocation raises if still short)."""
        if self.hibernation is None:
            return
        while len(self._free_page_list) < need:
            victim = None
            best = None
            for s in self._slots:
                if s is not None and s.parked and \
                        (best is None or s.last_used < best):
                    best, victim = s.last_used, s.session_id
            if victim is None:
                return
            if not self.hibernate_slot(victim):
                return          # store full: nothing more can page out

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill buckets used so far: the reference's count of
        its jitted prefill variants (the padded width is the only shape
        that varies across prompts)."""
        return len(self._compiled_buckets)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_len

    def _alloc(self, session_id: str) -> int:
        for i, s in enumerate(self._slots):
            if s is None:
                self._slot_map[session_id] = i
                return i
        raise RuntimeError("no free decode slots (lease accounting bug)")

    # -- slot state in and out ---------------------------------------------
    def _write_slot(self, idx: int, cache1) -> None:
        """Copy a batch-1 dense-layout cache into slot ``idx`` of every
        leaf of the engine cache."""
        ax = self._slot_axis
        for full, one in zip(leaves(self.cache["layers"]),
                             leaves(cache1["layers"])):
            full.select(ax, idx).copy_(one.select(ax, 0))
        self.cache["pos"][idx] = cache1["pos"][0]

    def _paged_install(self, k1, v1, idx: int, n: int) -> None:
        """Copy a batch-1 linear KV cache ([L, 1, S', kh, hd]) into the
        pages slot ``idx`` owns; rows past ``n`` in them are bucket padding
        that decode never reads."""
        owned = self._slots[idx].pages
        rows = len(owned) * self.page_size
        ids = torch.as_tensor(owned, dtype=torch.long, device=self.device)
        for pool, src in ((self.cache["layers"]["k"], k1),
                          (self.cache["layers"]["v"], v1)):
            src = src[:, 0, :rows]                       # [L, s, kh, hd]
            if src.shape[1] < rows:
                pad = src.new_zeros((src.shape[0], rows - src.shape[1])
                                    + tuple(src.shape[2:]))
                src = torch.cat([src, pad], dim=1)
            pool[:, ids] = src.reshape(
                src.shape[0], len(owned), self.page_size, src.shape[2],
                src.shape[3]).to(pool.dtype)
        self.cache["block"][idx] = torch.from_numpy(
            self._block_host[idx]).to(self.device)
        self.cache["pos"][idx] = n

    def _canonical_read(self, idx: int, pos: int) -> dict:
        """Canonical batch-1 export: the slot's rows as a linear
        [L, 1, max_len, kh, hd] buffer with the garbage tail (rows >=
        position: prefill bucket padding, stale rows of re-used slots)
        zeroed, and the host position — so the SAME logical state
        fingerprints identically across dense and paged engines and across
        hibernate/resume round trips."""
        out = {}
        for key in ("k", "v"):
            if self.paged:
                ids = torch.from_numpy(self._block_host[idx]).long().to(
                    self.device)
                full = self.cache["layers"][key][:, ids]  # [L, PPS, page, ..]
                full = full.reshape(full.shape[0], -1, full.shape[3],
                                    full.shape[4])[:, :self.max_len]
            else:
                full = self.cache["layers"][key][:, idx].clone()
            full[:, pos:] = 0
            out[key] = full[:, None]
        return {"layers": out,
                "pos": torch.full((1,), pos, dtype=torch.int32,
                                  device=self.device)}

    def export_slot(self, session_id: str):
        """Extract this session's state (the migration payload): tensors on
        this engine's device. Hibernated sessions export straight from the
        host tier: migrating a cold session needs no resume."""
        if session_id not in self._slot_map and self.has_hibernated(
                session_id):
            return self.hibernation.restore(session_id)
        idx = self._slot_map[session_id]
        meta = self._slots[idx]
        if self.paged or self._canonical:
            state = self._canonical_read(idx, meta.position)
        else:
            # recurrent states and rings carry no garbage tail: a copy of
            # the slot's rows, with the host position (device pos drifts
            # for parked rows)
            state = {"layers": tree_map(
                lambda t: t.narrow(self._slot_axis, idx, 1).clone(),
                self.cache["layers"]),
                "pos": torch.full((1,), meta.position, dtype=torch.int32,
                                  device=self.device)}
        return {"cache": state, "position": meta.position,
                "last_token": meta.last_token,
                "adapter_id": meta.adapter_id}

    def import_slot(self, session_id: str, payload) -> None:
        """Install a migrated session's state into a free slot. The payload
        may come from any engine of either package (tensors, numpy arrays);
        it is moved onto this engine's device. Raises AdmissionDenied when
        the target has no free slot or, paged, no pages for the payload."""
        from repro_torch.serving.state_transfer import AdmissionDenied
        if self.free_slots() == 0:
            raise AdmissionDenied(
                f"target admission denied: no free decode slots for "
                f"{session_id}")
        adapter_id = str(payload.get("adapter_id", ""))
        if adapter_id and (self.adapters is None
                           or not self.adapters.is_loaded(adapter_id)):
            # the adapter binding is part of the session contract: a
            # target that cannot realise it must refuse the transfer
            raise AdmissionDenied(
                f"target admission denied: adapter {adapter_id!r} not "
                f"loaded for {session_id}")
        payload = payload_to_torch(payload, self.cfg, self.device)
        position = int(payload["position"])
        idx = self._alloc(session_id)
        meta = SlotState(session_id, position,
                         last_token=int(payload["last_token"]),
                         adapter_id=adapter_id,
                         last_used=next(self._use_clock))
        self._slots[idx] = meta
        if self.paged:
            try:
                self._ensure_pages(idx, max(position, 1))
            except PagePoolExhausted as e:
                self._slot_map.pop(session_id, None)
                self._slots[idx] = None
                raise AdmissionDenied(str(e)) from e
            self._paged_install(payload["cache"]["layers"]["k"],
                                payload["cache"]["layers"]["v"], idx,
                                position)
        else:
            self._write_slot(idx, payload["cache"])

    def _free_slot(self, session_id: str) -> None:
        """Free the slot and pages only — hibernated state (if any) stays."""
        idx = self._slot_map.pop(session_id, None)
        if idx is not None:
            if self.paged:
                self._free_slot_pages(idx)
            self._slots[idx] = None

    def release_slot(self, session_id: str) -> None:
        """End of session: free slot/pages AND purge any hibernated copy."""
        self._free_slot(session_id)
        if self.hibernation is not None:
            self.hibernation.drop(session_id)

    # -- tiering: resident <-> parked <-> hibernated ---------------------
    def park_slot(self, session_id: str) -> None:
        """Mark a resident session idle: it keeps its slot and pages but
        rides later decode rounds with active=False, state frozen."""
        meta = self._slots[self._slot_map[session_id]]
        meta.parked = True
        self._pos_dirty = True

    def hibernate_slot(self, session_id: str, *,
                       now: Optional[float] = None) -> bool:
        """Page a resident session out to the host tier, freeing its slot
        and pages. Returns False — session left resident, state intact —
        when a capacity-bounded store refuses the payload."""
        if self.hibernation is None:
            raise RuntimeError(
                f"cannot hibernate {session_id}: engine has no "
                f"hibernation store")
        if now is None:
            now = self.clock.now() if self.clock is not None else 0.0
        payload = self.export_slot(session_id)
        try:
            self.hibernation.put(session_id, payload, now=now)
        except MemoryError:
            return False
        self._free_slot(session_id)
        return True

    def resume_slot(self, session_id: str) -> None:
        """Re-import a hibernated session. The store record is dropped only
        AFTER the import succeeds."""
        payload = self.hibernation.restore(session_id)
        self.import_slot(session_id, payload)
        self.hibernation.drop(session_id)

    def resume_session(self, session_id: str) -> None:
        """Bring a bound session back to active-resident from any tier."""
        idx = self._slot_map.get(session_id)
        if idx is not None:
            meta = self._slots[idx]
            meta.parked = False
            meta.last_used = next(self._use_clock)
            return
        if self.has_hibernated(session_id):
            self.resume_slot(session_id)
            return
        raise KeyError(f"unknown session {session_id}")

    # -- adapter lifecycle ------------------------------------------------
    def load_adapter(self, adapter_id: str, a, b) -> int:
        """Install adapter weights into this engine's device tables;
        idempotent. Returns the table index."""
        if self.adapters is None:
            raise RuntimeError("engine has no adapter runtime")
        return self.adapters.load(adapter_id, a, b)

    def unload_adapter(self, adapter_id: str) -> None:
        """Evict an adapter. Refused while any bound session (resident or
        parked) still references it — unloading under a live binding would
        silently continue those sessions on the base model."""
        if self.adapters is None:
            raise RuntimeError("engine has no adapter runtime")
        users = [s.session_id for s in self._slots
                 if s is not None and s.adapter_id == adapter_id]
        if users:
            raise RuntimeError(
                f"adapter {adapter_id!r} still bound by {users}")
        self.adapters.unload(adapter_id)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill_session(self, session_id: str, prompt: np.ndarray, *,
                        adapter_id: str = "") -> dict:
        """Admit a session: run prefill, install the cache, return TTFT.

        The prompt is right-padded to its power-of-two bucket with the true
        length passed separately.

        ``adapter_id`` binds a tenant adapter for the session's lifetime;
        it must already be loaded on this engine (ValueError otherwise —
        the serving plane maps that to NO_FEASIBLE_BINDING)."""
        t0 = time.perf_counter()
        aidx = 0
        if adapter_id:
            if self.adapters is None:
                raise ValueError(
                    f"engine has no adapter runtime; cannot bind "
                    f"{adapter_id!r} for {session_id}")
            try:
                aidx = self.adapters.index_of(adapter_id)
            except KeyError:
                raise ValueError(
                    f"adapter {adapter_id!r} not loaded on this engine "
                    f"for {session_id}")
        prompt = np.asarray(prompt)
        n = len(prompt)
        if n > self.max_len:
            # refuse rather than silently truncate: a truncated prefill
            # would condition generation on a clipped prefix while
            # position_of()/migration payload sizing report the full length
            raise ValueError(
                f"prompt of {n} tokens exceeds engine max_len "
                f"{self.max_len} for {session_id}")
        width = self._bucket(n)
        padded = np.zeros(width, np.int64)
        padded[:n] = prompt
        self._compiled_buckets.add(width)
        batch = {"tokens": torch.from_numpy(padded[None, :]).to(self.device),
                 "length": n}
        adapter = ((self.adapters.A[aidx], self.adapters.B[aidx]) if aidx
                   else None)
        logits, cache1 = self.lm.prefill(self.params, batch, self.max_len,
                                         adapter=adapter)
        tok = int(torch.argmax(logits[0]))
        idx = self._alloc(session_id)
        meta = SlotState(session_id, position=n, tokens_generated=1,
                         last_token=tok, adapter_id=adapter_id,
                         last_used=next(self._use_clock))
        self._slots[idx] = meta
        if self.paged:
            try:
                # only ceil(n / page) pages — NOT max_len worth: admission
                # reserves what the session actually uses
                self._ensure_pages(idx, n)
            except PagePoolExhausted:
                self._slot_map.pop(session_id, None)
                self._slots[idx] = None
                raise
            self._paged_install(cache1["layers"]["k"], cache1["layers"]["v"],
                                idx, n)
        else:
            self._write_slot(idx, cache1)
        return {"first_token": tok,
                "ttfb_ms": (time.perf_counter() - t0) * 1e3}

    # ------------------------------------------------------------------
    def _fused(self, last: np.ndarray, active: np.ndarray, steps: int, *,
               forced: Optional[np.ndarray] = None, snap_rows=None):
        """K decode steps with no host sync between them. ``last``:
        [slots] token feedback; ``active``: [slots] — inactive slots keep
        feeding their (zero) token so a fused chunk is bit-identical to K
        single-step rounds regardless of who shares the batch. With an
        adapter runtime, the per-slot int32 table index selects each row's
        adapter (0, the null adapter, for base sessions and free slots).

        ``forced`` ([slots, K]): step t consumes ``forced[:, t]`` instead
        of the previous step's token (the teacher-forced verify round).
        ``snap_rows``: tensors copied after every step but the last (the
        rollback snapshots of a speculative round; the last step's state
        is the live one). Returns the [slots, K] token block, through one
        device→host copy, and the list of per-step copies."""
        fed = torch.from_numpy(last).to(self.device)
        act = torch.from_numpy(active).to(self.device)
        if forced is not None:
            forced = torch.from_numpy(forced).to(self.device)
        adapter = None
        if self.adapters is not None:
            aidx = np.zeros(self.slots, np.int32)
            for i, s in enumerate(self._slots):
                if s is not None and s.adapter_id:
                    aidx[i] = self.adapters.index_of(s.adapter_id)
            adapter = (self.adapters.A, self.adapters.B,
                       torch.from_numpy(aidx).to(self.device),
                       self.adapters.route)
        cache = self.cache
        toks, snaps = [], []
        for t in range(steps):
            if forced is not None:
                fed = forced[:, t]
            logits, cache = self.lm.decode_step(self.params, cache,
                                                fed[:, None], active=act,
                                                adapter=adapter)
            nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
            fed = torch.where(act, nxt, fed)
            toks.append(fed)
            if snap_rows is not None and t < steps - 1:
                snaps.append([r.clone() for r in snap_rows])
        self.cache = cache
        return torch.stack(toks, dim=1).cpu().numpy(), snaps

    def _resync_pos(self) -> None:
        """Device pos (and block table) from host truth: parked rows'
        device pos advances inside the fused loop even though their state
        is frozen, and a speculative round runs ahead of its accept."""
        pos_host = np.zeros(self.slots, np.int32)
        for i, s in enumerate(self._slots):
            if s is not None:
                pos_host[i] = s.position
        self.cache["pos"] = torch.from_numpy(pos_host).to(self.device)
        if self.paged:
            self.cache["block"].copy_(torch.from_numpy(self._block_host))

    # ------------------------------------------------------------------
    # Speculative decode: rollback-able rounds.
    #
    # Both the draft and verify role run the SAME shape of round: γ+1
    # fused decode steps consuming [ℓ, t_1..t_γ] (ℓ = the slot's
    # unconsumed last token), whose post-step state at index n is exactly
    # the engine state after committing n of the γ candidate tokens. The
    # draft consumes its own outputs (autoregressive, producing the
    # proposals), the verifier consumes the proposals teacher-forced
    # (producing the target-greedy continuation y_0..y_γ in ONE fused
    # round). ``spec_accept(n, y_n)`` then restores the index-n snapshot:
    # committed stream = d_1..d_n, y_n — bitwise what target-only greedy
    # decode would have produced.
    #
    # Rollback cost depends on the cache family: full-attention caches
    # written at absolute positions need NO snapshots (rows >= pos are
    # never attended and later overwritten — pos-only rollback, including
    # paged); recurrent and ring-buffer leaves (ssm conv/ssm, hybrid conv/h
    # and windowed k/v) are overwritten IN PLACE by every step, so each
    # step's snapshot is a copy of the session's row of each of them (the
    # other rows ride inactive and stay bit-identical), and a restore
    # copies it back into the live leaf, whose storage never changes.
    # ------------------------------------------------------------------
    def _spec_stack_paths(self) -> List[tuple]:
        """Cache-leaf paths that must be snapshotted per step."""
        if self.cfg.family in ("dense", "moe", "encdec") \
                and not self.cfg.sliding_window:
            return []                       # pos-only rollback
        layers = self.cache["layers"]
        if isinstance(layers, tuple):       # hybrid: per-layer dicts
            return [("layers", i, key) for i, layer in enumerate(layers)
                    for key in sorted(layer)]
        return [("layers", key) for key in sorted(layers)
                if key not in ("cross_k", "cross_v")]   # static after prefill

    def _spec_rows(self, idx: int) -> List[torch.Tensor]:
        """Views of slot ``idx``'s row of every leaf a round snapshots."""
        rows = []
        for path in self._spec_paths:
            leaf = self.cache
            for p in path:
                leaf = leaf[p]
            rows.append(leaf.select(self._slot_axis, idx))
        return rows

    def _spec_prologue(self, session_id: str, gamma: int):
        """Shared admission for a spec round: slot lookup, bounds, page
        growth, device pos/block resync from host truth (a spec round
        always ends with host-side position authority)."""
        idx = self._slot_map[session_id]
        meta = self._slots[idx]
        if meta.adapter_id:
            raise ValueError(
                f"speculative decode does not support adapter-bound "
                f"sessions ({session_id} binds {meta.adapter_id!r})")
        if gamma < 1:
            raise ValueError("spec round needs gamma >= 1")
        if meta.position + gamma + 1 > self.max_len:
            raise ValueError(
                f"spec round of gamma={gamma} overruns max_len "
                f"{self.max_len} from position {meta.position}")
        if session_id in self._spec_pending:
            raise RuntimeError(
                f"spec round already pending for {session_id}; "
                f"spec_accept it first")
        last = np.zeros(self.slots, np.int32)
        active = np.zeros(self.slots, bool)
        last[idx] = meta.last_token
        active[idx] = True
        if self.paged:
            self._ensure_pages(idx, meta.position + gamma + 2)
        self._resync_pos()
        return idx, meta, last, active

    def _spec_run(self, session_id: str, gamma: int,
                  tokens: Optional[List[int]] = None) -> np.ndarray:
        """γ+1 steps of ``session_id`` alone (co-resident slots ride with
        active=False, frozen): autoregressive from its last token, or
        teacher-forced over [ℓ, *tokens]. The host state does NOT advance:
        the round is pending until ``spec_accept`` or ``spec_abort``.
        Returns the session's row of the token block."""
        idx, meta, last, active = self._spec_prologue(session_id, gamma)
        forced = None
        if tokens is not None:
            forced = np.zeros((self.slots, gamma + 1), np.int32)
            forced[idx, 0] = meta.last_token
            forced[idx, 1:] = tokens
        rows = self._spec_rows(idx)
        pre = [r.clone() for r in rows]
        block, stacks = self._fused(last, active, gamma + 1, forced=forced,
                                    snap_rows=rows)
        self._spec_pending[session_id] = {"stacks": stacks, "pre": pre,
                                          "base_pos": meta.position,
                                          "gamma": gamma}
        self._pos_dirty = True      # device pos ran ahead of host truth
        return block[idx]

    @torch.no_grad()
    def spec_round(self, session_id: str, gamma: int) -> List[int]:
        """Draft role: propose γ tokens autoregressively from the current
        state. Pending until ``spec_accept`` commits a prefix of it."""
        gamma = int(gamma)
        return [int(t) for t in self._spec_run(session_id, gamma)[:gamma]]

    @torch.no_grad()
    def spec_grade(self, session_id: str, tokens: List[int]) -> List[int]:
        """Verify role: consume ``tokens`` = [d_1..d_γ] teacher-forced in
        one fused round and return the target-greedy continuation
        y_0..y_γ (y_t = greedy next after [.., ℓ, d_1..d_t]). Pending
        until ``spec_accept``."""
        return [int(t) for t in
                self._spec_run(session_id, len(tokens), list(tokens))]

    @torch.no_grad()
    def spec_accept(self, session_id: str, n_accept: int,
                    last_token: int) -> None:
        """Commit the longest agreeing prefix: restore the index-n
        snapshot (state after consuming ℓ, d_1..d_n), advance the host
        position by n+1 committed tokens, and make ``last_token`` (= y_n,
        the verifier's correction/extension) the new unconsumed token.
        n ∈ [0, γ]; n = γ accepts the whole round (the live state)."""
        pend = self._spec_pending.pop(session_id)
        n = int(n_accept)
        if not (0 <= n <= pend["gamma"]):
            raise ValueError(
                f"n_accept {n} outside [0, {pend['gamma']}]")
        idx = self._slot_map[session_id]
        if n < pend["gamma"]:
            for row, snap in zip(self._spec_rows(idx), pend["stacks"][n]):
                row.copy_(snap)
        meta = self._slots[idx]
        meta.position = pend["base_pos"] + n + 1
        meta.last_token = int(last_token)
        meta.tokens_generated += n + 1
        meta.last_used = next(self._use_clock)
        self._pos_dirty = True      # next round resyncs device pos

    @torch.no_grad()
    def spec_abort(self, session_id: str) -> None:
        """Drop a pending round without committing anything: restore the
        pre-round copy of every destructive leaf (host position never
        advanced; device pos resyncs on the next round)."""
        pend = self._spec_pending.pop(session_id, None)
        if pend is not None:
            idx = self._slot_map[session_id]
            for row, snap in zip(self._spec_rows(idx), pend["pre"]):
                row.copy_(snap)
        self._pos_dirty = True

    def override_last_token(self, session_id: str, token: int) -> None:
        """Re-point the slot's unconsumed token at an externally committed
        one. The draft half of a split session decodes the VERIFIER's
        token stream, not its own: after the draft-side prefill (and
        after every accepted round) the next token it must consume is
        whatever the verifier committed."""
        meta = self._slots[self._slot_map[session_id]]
        meta.last_token = int(token)

    @torch.no_grad()
    def decode_round(self, steps: Optional[int] = None
                     ) -> Dict[str, Union[int, List[int]]]:
        """Continuous-batching decode for every active slot.

        ``steps=None`` — single-step form: {session: token}.
        ``steps=K``    — fused K-step chunk: {session: [token, ...] * K}.
        """
        if not self._slot_map:
            return {}
        k = 1 if steps is None else max(1, int(steps))
        last = np.zeros(self.slots, np.int32)
        active = np.zeros(self.slots, bool)
        any_parked = False
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if s.parked:
                any_parked = True
                continue
            last[i] = s.last_token
            active[i] = True
        if not active.any():
            return {}
        if self.paged:
            # grow block tables BEFORE the fused chunk — the loop cannot
            # allocate mid-flight; under pressure this hibernates coldest
            # parked sessions or raises PagePoolExhausted
            for i, s in enumerate(self._slots):
                if s is not None and not s.parked:
                    self._ensure_pages(i, s.position + k)
        if self.paged or any_parked or self._pos_dirty:
            self._resync_pos()
            self._pos_dirty = any_parked
        block, _ = self._fused(last, active, k)          # [slots, K]
        out: Dict[str, Union[int, List[int]]] = {}
        for i, s in enumerate(self._slots):
            if s is None or s.parked:
                continue
            s.last_token = int(block[i, -1])
            s.position += k
            s.tokens_generated += k
            s.last_used = next(self._use_clock)
            out[s.session_id] = (int(block[i, 0]) if steps is None
                                 else [int(t) for t in block[i]])
        return out

    # ------------------------------------------------------------------
    def serve(self, session_id: str, prompt_tokens: int, gen_tokens: int,
              *, prompt: Optional[np.ndarray] = None,
              chunk: int = 16, adapter_id: str = "") -> dict:
        """Unary convenience: prefill + chunked decode for one session.
        Synthetic prompts are crc32-seeded (NOT ``hash()``, which varies
        per process under PYTHONHASHSEED)."""
        rng = np.random.default_rng(
            zlib.crc32(session_id.encode()) % 2**31)
        if prompt is None:
            prompt = rng.integers(0, self.cfg.vocab_size,
                                  size=prompt_tokens).astype(np.int32)
        t0 = time.perf_counter()
        pre = self.prefill_session(session_id, prompt,
                                   adapter_id=adapter_id)
        toks = [pre["first_token"]]
        remaining = gen_tokens - 1
        while remaining > 0:
            # pow2 chunk schedule, as the reference's
            k = min(chunk, 1 << (remaining.bit_length() - 1))
            out = self.decode_round(steps=k)
            toks.extend(out[session_id])
            remaining -= k
        self.release_slot(session_id)
        total_ms = (time.perf_counter() - t0) * 1e3
        return {"tokens": toks, "ttfb_ms": pre["ttfb_ms"],
                "latency_ms": total_ms}

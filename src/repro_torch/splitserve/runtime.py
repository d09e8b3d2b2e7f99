"""SpecDecoder: the data-plane loop of a split session over two real
:class:`~repro_torch.serving.engine.InferenceEngine` instances.

Per round (window γ):

1. DRAFT — the edge engine proposes d_1..d_γ autoregressively
   (``spec_round``), a rollback-able (γ+1)-step fused scan.
2. VERIFY — the anchored engine consumes [ℓ, d_1..d_γ] teacher-forced in
   ONE fused forward (``spec_grade``) and emits the target-greedy
   continuation y_0..y_γ.
3. ACCEPT — n = |longest prefix with d_i == y_{i-1}|; both engines
   restore their index-n snapshot and commit d_1..d_n, y_n
   (``spec_accept``). Every committed token is exactly what target-only
   greedy decode would have produced (induction over rounds), and every
   round commits ≥ 1 token — the loop cannot stall.

The decoder also implements the two continuity behaviours the split
story needs: ``migrate_verify`` (make-before-break verify re-anchor —
export/import the slot between rounds, bit-exact) and ``degrade`` /
``reattach_verify`` (airplane mode: verify loss drops to edge-only
drafting without killing the stream; re-attachment prefixes the new
verifier with the committed stream, so post-recovery tokens are again
target-greedy given the prefix).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs.registry import draft_compatible
from repro_torch.splitserve.placement import DEFAULT_GAMMA


def expected_round_tokens(alpha: float, gamma: int) -> float:
    """Expected committed tokens per round at per-token acceptance rate
    α (the Eq. 14-style predictor the heartbeat and bench share):
    1 + α + ... + α^γ = (1 − α^{γ+1}) / (1 − α)."""
    a = min(max(float(alpha), 0.0), 1.0)
    g = max(int(gamma), 0)
    if a >= 1.0:
        return float(g + 1)
    return (1.0 - a ** (g + 1)) / (1.0 - a)


def spec_speedup(alpha: float, gamma: int, *, rtt_verify_ms: float,
                 rtt_edge_ms: float, verify_step_ms: float = 0.0,
                 draft_step_ms: float = 0.0) -> float:
    """Predicted interactive-streaming speedup of split serving over
    target-only, per committed token. Target-only pays the verify
    anchor's RTT per streamed token; the split pays the edge RTT per
    token plus ONE verify round trip per round::

        t_target = rtt_verify + c_v
        t_split  = rtt_edge + c_d + (rtt_verify + (γ+1)·c_v) / E[n+1]

    where E[n+1] = expected_round_tokens(α, γ). The RTT terms dominate on
    real deployments (55 ms backhaul vs 2 ms access), which is what makes
    the ratio hardware-independent enough to guard in CI."""
    e = expected_round_tokens(alpha, gamma)
    t_target = rtt_verify_ms + verify_step_ms
    t_split = rtt_edge_ms + draft_step_ms \
        + (rtt_verify_ms + (gamma + 1) * verify_step_ms) / max(e, 1e-9)
    return t_target / max(t_split, 1e-9)


@dataclass
class SpecStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    committed: int = 0
    degraded_rounds: int = 0
    #: wall-clock split: where the decode time actually went
    draft_ms: float = 0.0
    verify_ms: float = 0.0

    @property
    def acceptance(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_round(self) -> float:
        return self.committed / self.rounds if self.rounds else 0.0


class SpecDecoder:
    """Drives one split session over a (draft, verify) engine pair."""

    def __init__(self, draft_engine, verify_engine, *,
                 gamma: int = DEFAULT_GAMMA, session_id: str = "split"):
        if not draft_compatible(draft_engine.cfg, verify_engine.cfg):
            raise ValueError(
                f"draft vocab {draft_engine.cfg.vocab_size} != target "
                f"vocab {verify_engine.cfg.vocab_size}: pairing rejected "
                f"before any tokens stream")
        self.draft = draft_engine
        self.verify: Optional[object] = verify_engine
        self.gamma = int(gamma)
        self.sid = session_id
        self.tokens: List[int] = []      # committed stream (post-prompt)
        self._prompt: Optional[np.ndarray] = None
        self.stats = SpecStats()

    # ------------------------------------------------------------------
    @property
    def degraded(self) -> bool:
        return self.verify is None

    def _committed_last(self) -> int:
        return self.tokens[-1]

    def start(self, prompt: np.ndarray) -> int:
        """Prefill both anchors. The FIRST committed token comes from the
        VERIFIER's prefill (identity with target-only decode starts at
        token 0); the draft's own prefill argmax is discarded — its slot
        is re-pointed at the committed token."""
        self._prompt = np.asarray(prompt, np.int32)
        if self.verify is None:
            raise RuntimeError("cannot start a split stream degraded; "
                               "use a plain engine for edge-only serve")
        pre = self.verify.prefill_session(self.sid, self._prompt)
        first = int(pre["first_token"])
        self.draft.prefill_session(self.sid, self._prompt)
        self.draft.override_last_token(self.sid, first)
        self.tokens = [first]
        return first

    # ------------------------------------------------------------------
    def _window(self) -> int:
        """Clamp γ so neither engine's round overruns max_len."""
        room_v = self.verify.max_len - self.verify.position_of(self.sid) \
            - 1 if self.verify is not None else self.gamma
        room_d = self.draft.max_len - self.draft.position_of(self.sid) - 1
        return max(1, min(self.gamma, room_v, room_d))

    def round(self, proposals: Optional[Sequence[int]] = None) -> List[int]:
        """One draft/verify/accept round; returns the committed tokens
        (length n+1 ∈ [1, γ+1]).

        ``proposals`` substitutes external draft tokens (the bench's
        oracle arm sweeps acceptance this way). The edge engine still
        runs — its round is charged and rolled back, then its state is
        teacher-forced onto the accepted prefix so the pair stays
        stream-consistent."""
        if self.degraded:
            return self.round_degraded()
        g = self._window()
        t0 = time.perf_counter()
        if proposals is None:
            d = self.draft.spec_round(self.sid, g)
            engine_drafted = True
        else:
            self.draft.spec_round(self.sid, g)
            self.draft.spec_abort(self.sid)
            d = [int(t) for t in list(proposals)[:g]]
            if len(d) < g:
                g = max(1, len(d))
                d = d[:g]
            engine_drafted = False
        t1 = time.perf_counter()
        y = self.verify.spec_grade(self.sid, d)
        n = 0
        while n < g and d[n] == y[n]:
            n += 1
        last = int(y[n])
        self.verify.spec_accept(self.sid, n, last)
        t2 = time.perf_counter()
        if engine_drafted:
            self.draft.spec_accept(self.sid, n, last)
        else:
            # teacher-force the accepted prefix (pad one junk token so a
            # zero-length prefix is representable; snapshots beyond n are
            # discarded by the accept)
            self.draft.spec_grade(self.sid, list(d[:n]) + [0])
            self.draft.spec_accept(self.sid, n, last)
        t3 = time.perf_counter()
        committed = [int(t) for t in d[:n]] + [last]
        self.tokens.extend(committed)
        st = self.stats
        st.rounds += 1
        st.drafted += g
        st.accepted += n
        st.committed += len(committed)
        st.draft_ms += (t1 - t0 + t3 - t2) * 1e3
        st.verify_ms += (t2 - t1) * 1e3
        return committed

    def round_degraded(self) -> List[int]:
        """Edge-only round (verify anchor lost): the draft engine's own
        greedy tokens ARE the stream — explicitly lower quality tier, but
        the session keeps streaming instead of failing."""
        g = self._window()
        t0 = time.perf_counter()
        d = self.draft.spec_round(self.sid, g)
        # commit all γ drafts: consumed ℓ, d_1..d_{γ-1}; newest = d_γ
        self.draft.spec_accept(self.sid, g - 1, d[-1])
        self.stats.draft_ms += (time.perf_counter() - t0) * 1e3
        self.tokens.extend(int(t) for t in d)
        self.stats.rounds += 1
        self.stats.degraded_rounds += 1
        self.stats.committed += g
        return [int(t) for t in d]

    def decode(self, n_tokens: int,
               proposals: Optional[Sequence[int]] = None) -> List[int]:
        """Commit at least ``n_tokens`` more tokens (rounds are atomic,
        so up to γ extra may land). ``proposals`` feeds the oracle arm —
        consumed positionally from the current stream offset."""
        start = len(self.tokens)
        while len(self.tokens) - start < n_tokens:
            if proposals is None:
                self.round()
            else:
                off = len(self.tokens) - 1      # proposals[i] drafts token i+1
                self.round(proposals=list(proposals[off:off + self.gamma]))
        return self.tokens[start:]

    # ------------------------------------------------------------------
    # continuity: verify migration, degrade, re-attach
    # ------------------------------------------------------------------
    def migrate_verify(self, new_engine) -> None:
        """Make-before-break verify re-anchor between rounds: export the
        slot from the old verifier, import into the new one (bit-exact —
        the same state-transfer primitive as session migration), then
        release the old slot. The edge draft anchor never stops."""
        if self.verify is None:
            raise RuntimeError("no verify anchor to migrate; reattach "
                               "first")
        if not draft_compatible(self.draft.cfg, new_engine.cfg):
            raise ValueError("verify migration target has mismatched "
                             "vocab; rejected before transfer")
        payload = self.verify.export_slot(self.sid)
        new_engine.import_slot(self.sid, payload)
        self.verify.release_slot(self.sid)
        self.verify = new_engine

    def degrade(self) -> None:
        """Airplane mode: drop the verify anchor. Subsequent rounds are
        edge-only (``round_degraded``)."""
        if self.verify is not None:
            try:
                self.verify.release_slot(self.sid)
            except Exception:
                pass                       # a crashed engine has no slot
        self.verify = None

    def reattach_verify(self, new_engine) -> None:
        """Recover full quality: prefill the new verifier with the
        committed stream (prompt + everything committed so far, minus
        the newest unconsumed token), then re-point its slot at the
        committed last token. Tokens from here on are target-greedy
        given the degraded-mode prefix."""
        if not draft_compatible(self.draft.cfg, new_engine.cfg):
            raise ValueError("verify re-attach target has mismatched "
                             "vocab; rejected before prefill")
        stream = np.concatenate(
            [self._prompt, np.asarray(self.tokens[:-1], np.int32)]) \
            if len(self.tokens) > 1 else self._prompt
        new_engine.prefill_session(self.sid, stream)
        new_engine.override_last_token(self.sid, self._committed_last())
        self.verify = new_engine

    def close(self) -> None:
        for eng in (self.draft, self.verify):
            if eng is not None:
                try:
                    eng.release_slot(self.sid)
                except Exception:
                    pass

"""Speculative decode and split serving in the port against the reference
package's, on the CPU with bridged float32 smoke-size weights.

* The engine's primitives — ``spec_round`` (draft), ``spec_grade``
  (verify), ``spec_accept`` and ``spec_abort`` — give the reference
  engine's tokens on the dense, paged, MoE, hybrid and SSM families. After
  ``spec_accept(n)`` the session's exported state agrees with the
  reference's (1e-4: the two packages compute it in another order) and
  fingerprints EXACTLY as the state a plain decode of the same committed
  tokens leaves, so a snapshot that aliased the live leaf (which decode
  updates in place) would fail here. An abort restores the state from
  before the round, bit for bit, and a co-resident session is left bit
  for bit as it was.
* ``SpecDecoder`` (the port's copy of ``splitserve``) over port engines
  commits the stream, and counts the rounds, drafts and acceptances, of
  the reference's decoder over reference engines on the same weights, and
  the stream is bitwise the port's target-only greedy stream: engine and
  oracle drafts, a twin draft, verify migration into a dense or paged
  engine, degrade and reattach, and a reference decoder whose verify
  anchor migrates into a port engine.
* ``SplitManager`` over the port's ``Orchestrator`` establishes a dual
  anchor and releases both halves.
"""

import dataclasses
import functools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serving.engine import InferenceEngine as JaxEngine
from repro.splitserve import SpecDecoder as JaxSpecDecoder
from repro_torch import bridge
from repro_torch.core import Orchestrator, default_asp
from repro_torch.core.asp import QualityTier
from repro_torch.core.catalog import Catalog, default_catalog
from repro_torch.core.clock import VirtualClock
from repro_torch.core.sites import ExecutionSite, SiteSpec
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.state_transfer import fingerprint
from repro_torch.splitserve import SpecDecoder, SplitManager
from tests._torch_pairs import configs, prompt, weights

MAX_LEN, PAGE, GAMMA = 96, 16, 3
TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT = (np.arange(1, 13, dtype=np.int32) * 7) % 500
SPEC_ARCHS = ("edge-tiny", "recurrentgemma-2b", "mamba2-1.3b")
#: family -> (smoke config, paged)
FAMILIES = {"dense": ("edge-tiny", False), "paged": ("edge-tiny", True),
            "moe": ("qwen3-moe-30b-a3b", False),
            "hybrid": ("recurrentgemma-2b", False),
            "ssm": ("mamba2-1.3b", False)}


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0):
    """(reference config, port config, reference params, port params)."""
    jcfg, tcfg = configs(arch, smoke=True)
    return (jcfg, tcfg) + weights(jcfg, tcfg, seed)


_JAX_ENGINES = {}


def _jax(arch, *, seed=0, paged=False, role=""):
    """A reference engine, kept across tests so that its jitted functions
    compile once, handed out with every slot free."""
    key = (arch, seed, paged, role)
    if key not in _JAX_ENGINES:
        jcfg, _, jp, _ = _pair(arch, seed)
        _JAX_ENGINES[key] = JaxEngine(jcfg, params=jp, slots=2,
                                      max_len=MAX_LEN, paged=paged,
                                      page_size=PAGE)
    eng = _JAX_ENGINES[key]
    eng._spec_pending.clear()
    for sid in list(eng._slot_map):
        eng.release_slot(sid)
    return eng


def _port(arch, *, seed=0, paged=False):
    _, tcfg, _, tp = _pair(arch, seed)
    return InferenceEngine(tcfg, params=tp, slots=2, max_len=MAX_LEN,
                           paged=paged, page_size=PAGE, device="cpu")


class _Bridged:
    """A port engine as the reference package sees it: its payloads cross
    as numpy, through the bridge; everything else is the engine's own."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def export_slot(self, sid):
        return bridge.payload_to_numpy(self.engine.export_slot(sid))


def _same_values(jeng, teng, sid):
    """The session's exported state agrees across the packages."""
    jpay = jeng.export_slot(sid)
    tpay = bridge.payload_to_numpy(teng.export_slot(sid))
    assert tpay["position"] == int(jpay["position"])
    jl, tl = bridge.leaves(jpay["cache"]), bridge.leaves(tpay["cache"])
    assert [a.shape for a in jl] == [b.shape for b in tl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), **TOL)


# -- the engine's primitives -------------------------------------------
@pytest.mark.parametrize("n", [0, 1, GAMMA])
@pytest.mark.parametrize("family", FAMILIES)
def test_spec_accept_restores_the_index_n_state(family, n):
    arch, paged = FAMILIES[family]
    vocab = _pair(arch)[1].vocab_size
    jeng, teng, plain = _jax(arch, paged=paged), _port(arch, paged=paged), \
        _port(arch, paged=paged)
    for eng in (jeng, teng, plain):
        eng.prefill_session("s", PROMPT)
    # a drafted round, n of its tokens committed, then a correction
    d = teng.spec_round("s", GAMMA)
    assert d == jeng.spec_round("s", GAMMA)
    for eng in (jeng, teng):
        eng.spec_accept("s", n, 7)
    plain.decode_round(steps=n + 1)
    plain.override_last_token("s", 7)
    _same_values(jeng, teng, "s")
    assert fingerprint(teng.export_slot("s")) == \
        fingerprint(plain.export_slot("s"))
    # a graded round over tokens that are not the greedy ones
    forced = [(5 * t + 3) % vocab for t in range(1, GAMMA + 1)]
    y = teng.spec_grade("s", forced)
    assert y == jeng.spec_grade("s", forced) and len(y) == GAMMA + 1
    for eng in (jeng, teng):
        eng.spec_accept("s", n, y[n])
    for t in [7] + forced[:n]:
        plain.override_last_token("s", t)
        plain.decode_round()
    plain.override_last_token("s", y[n])
    _same_values(jeng, teng, "s")
    assert fingerprint(teng.export_slot("s")) == \
        fingerprint(plain.export_slot("s"))
    nxt = teng.decode_round(steps=4)["s"]
    assert nxt == jeng.decode_round(steps=4)["s"]
    assert nxt == plain.decode_round(steps=4)["s"]


@pytest.mark.parametrize("family", FAMILIES)
def test_spec_abort_restores_the_state_before_the_round(family):
    arch, paged = FAMILIES[family]
    jeng, teng = _jax(arch, paged=paged), _port(arch, paged=paged)
    for eng in (jeng, teng):
        eng.prefill_session("s", PROMPT)
    before = fingerprint(teng.export_slot("s"))
    assert teng.spec_round("s", GAMMA) == jeng.spec_round("s", GAMMA)
    for eng in (jeng, teng):
        eng.spec_abort("s")
    assert fingerprint(teng.export_slot("s")) == before
    assert teng.spec_grade("s", [1, 2, 3]) == jeng.spec_grade("s", [1, 2, 3])
    for eng in (jeng, teng):
        eng.spec_abort("s")
    assert fingerprint(teng.export_slot("s")) == before
    _same_values(jeng, teng, "s")
    assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)


@pytest.mark.parametrize("family", FAMILIES)
def test_co_resident_session_is_left_bit_identical(family):
    arch, paged = FAMILIES[family]
    vocab = _pair(arch)[1].vocab_size
    jeng, teng = _jax(arch, paged=paged), _port(arch, paged=paged)
    for eng in (jeng, teng):
        eng.prefill_session("a", PROMPT)
        eng.prefill_session("b", prompt(29, vocab, 2))
    before = fingerprint(teng.export_slot("b"))
    for eng in (jeng, teng):
        d = eng.spec_round("a", GAMMA)
        eng.spec_accept("a", 1, d[1])
        y = eng.spec_grade("a", [4, 5, 6])
        eng.spec_accept("a", 0, y[0])
        eng.spec_round("a", GAMMA)
        eng.spec_abort("a")
    assert fingerprint(teng.export_slot("b")) == before
    _same_values(jeng, teng, "b")
    _same_values(jeng, teng, "a")
    assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)


def test_spec_round_refuses_what_the_reference_refuses():
    teng = _port("edge-tiny")
    teng.prefill_session("s", PROMPT)
    with pytest.raises(ValueError, match="gamma >= 1"):
        teng.spec_round("s", 0)
    with pytest.raises(ValueError, match="overruns max_len"):
        teng.spec_round("s", MAX_LEN)
    teng.spec_round("s", 2)
    with pytest.raises(RuntimeError, match="already pending"):
        teng.spec_grade("s", [1, 2])
    with pytest.raises(ValueError, match="outside"):
        teng.spec_accept("s", 3, 0)


# -- SpecDecoder in both packages ---------------------------------------
def _target_only(arch, n):
    """The port's plain greedy stream of ``n`` tokens."""
    eng = _port(arch)
    toks = [eng.prefill_session("s", PROMPT)["first_token"]]
    return toks + eng.decode_round(steps=n - 1)["s"]


def _counts(dec):
    st = dec.stats
    return (st.rounds, st.drafted, st.accepted, st.committed,
            st.degraded_rounds)


def _both(verify, draft, gamma, drive, *, draft_seed=7, twin=False):
    """Run ``drive(decoder, package)`` on the reference's decoder over
    reference engines and on the port's over port engines (same weights);
    both must commit the same stream with the same counts. Returns the
    port's decoder, its engines still holding the session."""
    out = []
    for pkg, engine, decoder in (("jax", _jax, JaxSpecDecoder),
                                 ("port", _port, SpecDecoder)):
        v = engine(verify, role="verify") if pkg == "jax" else engine(verify)
        if twin:
            d = (engine(verify, role="draft") if pkg == "jax"
                 else engine(verify))
            d.params = v.params
        else:
            d = (engine(draft, seed=draft_seed, role="draft") if pkg == "jax"
                 else engine(draft, seed=draft_seed))
        dec = decoder(d, v, gamma=gamma, session_id="s")
        drive(dec, pkg)
        out.append(dec)
    jdec, tdec = out
    assert tdec.tokens == jdec.tokens
    assert _counts(tdec) == _counts(jdec)
    return tdec


def _decode(n, proposals=None):
    def drive(dec, pkg):
        dec.start(PROMPT)
        dec.decode(n, proposals=proposals)
    return drive


@settings(max_examples=9, deadline=None, database=None)
@given(st.sampled_from(SPEC_ARCHS), st.sampled_from((1, 2, 4)))
def test_streams_and_counts_match_the_reference(arch, gamma):
    """A disagreeing draft (another arch, or other weights): the committed
    stream is the target-only greedy stream in both packages."""
    dec = _both(arch, "edge-tiny", gamma, _decode(19))
    assert dec.tokens[:20] == _target_only(arch, 20)


def test_twin_draft_accepts_the_full_window():
    dec = _both("edge-tiny", "edge-tiny", 4, _decode(19), twin=True)
    assert dec.tokens[:20] == _target_only("edge-tiny", 20)
    assert dec.stats.acceptance == 1.0
    assert dec.stats.tokens_per_round == pytest.approx(5.0)


def test_oracle_proposals_with_a_hybrid_draft():
    """Corrupted target-greedy proposals: the hybrid draft grades them and
    accepts 0 < n < γ, restoring RG-LRU and ring-buffer snapshots; its
    state stays the reference draft's."""
    base = _target_only("mamba2-1.3b", 20)
    rng = np.random.default_rng(3)
    corrupted = [t if rng.random() < 0.6 else (t + 1) % 512
                 for t in base[1:]]
    dec = _both("mamba2-1.3b", "recurrentgemma-2b", 4,
                _decode(19, corrupted))
    assert dec.tokens[:20] == base
    assert 0.0 < dec.stats.acceptance < 1.0
    _same_values(_JAX_ENGINES[("recurrentgemma-2b", 7, False, "draft")],
                 dec.draft, "s")


@pytest.mark.parametrize("verify,paged", [("recurrentgemma-2b", False),
                                          ("edge-tiny", True)])
def test_verify_migration_keeps_the_stream(verify, paged):
    """Mid-stream make-before-break re-anchor of the verify tier into a
    fresh engine (a paged one for the dense family)."""
    def drive(dec, pkg):
        dec.start(PROMPT)
        dec.decode(9)
        fresh = (_jax(verify, paged=paged, role="fresh") if pkg == "jax"
                 else _port(verify, paged=paged))
        dec.migrate_verify(fresh)
        dec.decode(24 - len(dec.tokens))

    dec = _both(verify, "edge-tiny", 2, drive)
    assert dec.verify.paged == paged
    assert dec.tokens[:24] == _target_only(verify, 24)


def test_degrade_and_reattach():
    """Edge-only rounds while the verifier is lost; after reattach every
    token is target-greedy given the committed prefix."""
    marks = {}

    def drive(dec, pkg):
        dec.start(PROMPT)
        dec.decode(4)
        dec.degrade()
        dec.decode(4)
        marks[pkg] = len(dec.tokens)
        dec.reattach_verify(_jax("edge-tiny", role="fresh") if pkg == "jax"
                            else _port("edge-tiny"))
        dec.decode(6)

    dec = _both("edge-tiny", "mamba2-1.3b", 2, drive, draft_seed=5)
    assert dec.stats.degraded_rounds > 0
    n = marks["port"]
    oracle = _port("edge-tiny")
    oracle.prefill_session("s", np.concatenate(
        [PROMPT, np.asarray(dec.tokens[:n - 1], np.int32)]))
    oracle.override_last_token("s", dec.tokens[n - 1])
    assert dec.tokens[n:] == oracle.decode_round(
        steps=len(dec.tokens) - n)["s"]


def test_reference_decoder_migrates_its_verify_anchor_into_the_port():
    verify = "recurrentgemma-2b"
    dec = JaxSpecDecoder(_jax("edge-tiny", seed=7, role="draft"),
                         _jax(verify, role="verify"), gamma=2,
                         session_id="s")
    dec.start(PROMPT)
    dec.decode(9)
    dec.migrate_verify(_Bridged(_port(verify)))
    dec.decode(24 - len(dec.tokens))
    assert dec.tokens[:24] == _target_only(verify, 24)


# -- SplitManager over the port's orchestrator --------------------------
def _split_orch():
    """An edge site hosting the draft model and two regional sites hosting
    the target, as the reference's split-control tests build them."""
    clock = VirtualClock()
    cat = Catalog()
    for model in ("recurrentgemma-2b", "minitron-8b"):
        cat.register(default_catalog().get(model))

    def site(sid, kind, rtt, slots, hosted):
        return ExecutionSite(SiteSpec(
            sid, kind, "eu", chips=8, hbm_bytes_total=8 * 80e9,
            peak_flops=8 * 989e12, hbm_bw=8 * 3.35e12, decode_slots=slots,
            rtt_ms={"zone-a": rtt}, hosted_models=hosted,
            price_per_chip_s=2.0e-4), clock)

    sites = {"regional-1": site("regional-1", "regional", 12.0, 64,
                                ("minitron-8b@1.0",)),
             "regional-2": site("regional-2", "regional", 30.0, 64,
                                ("minitron-8b@1.0",)),
             "edge-a": site("edge-a", "edge", 2.0, 32,
                            ("recurrentgemma-2b@1.0",))}
    orch = Orchestrator(clock=clock, catalog=cat, sites=sites)
    return orch, SplitManager(orch)


def _split_asp():
    return dataclasses.replace(default_asp(tier=QualityTier.STANDARD),
                               split_policy="require",
                               max_cost_per_1k_tokens=4.0)


def test_split_manager_establishes_a_dual_anchor():
    orch, mgr = _split_orch()
    events = []
    orch.split_event_sinks.append(lambda sid, ev, d: events.append(ev))
    s = orch.establish(_split_asp(), invoker="u", zone="zone-a")
    st_ = mgr.states[s.session_id]
    assert (s.binding.site_id, s.binding.model_id) == \
        ("edge-a", "recurrentgemma-2b")
    assert (st_.verify_binding.site_id, st_.verify_binding.model_id) == \
        ("regional-1", "minitron-8b")
    assert st_.placement.draft_budget.p99_ms < s.asp.objectives.p99_ms
    assert st_.placement.verify_budget.p99_ms < s.asp.objectives.p99_ms
    assert events == ["split-established"]
    assert orch.sites["edge-a"].slots_in_use() == 1
    assert orch.sites["regional-1"].slots_in_use() == 1


def test_split_manager_release_frees_both_anchors():
    orch, mgr = _split_orch()
    s = orch.establish(_split_asp(), invoker="u", zone="zone-a")
    orch.release(s)
    assert mgr.states == {}
    assert all(site.slots_in_use() == 0 for site in orch.sites.values())

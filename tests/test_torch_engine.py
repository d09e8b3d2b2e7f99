"""The port's serving engine and launcher against the reference package's,
on the CPU with bridged float32 edge-tiny weights.

* Greedy streams are token-identical to the reference engine's (dense and
  paged; the reference runs its Pallas decode kernels in interpret mode).
* Migration payloads have the reference's keys, shapes and dtypes, and a
  session moves reference -> port and port -> reference through the
  reference's own ``state_transfer.transfer`` (fingerprint-checked) and
  continues token-identically.
* Paging, parking and hibernation keep the reference's accounting.
* ``serve()`` serves the same requests as the reference launcher.

Payload values computed independently by the two packages agree to 1e-5
(float32, different summation order); states that crossed the bridge agree
bit for bit (their fingerprints match).
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

import repro.core.clock as jax_clock
import repro.core.session as jax_session
import repro.launch.serve as jax_serve_mod
import repro_torch.core.clock as port_clock
import repro_torch.core.session as port_session
import repro_torch.launch.serve as port_serve_mod
from repro.launch.serve import serve as jax_serve
from repro.serving import state_transfer as jax_transfer
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch import bridge
from repro_torch.launch.serve import serve
from repro_torch.serving import state_transfer
from repro_torch.serving.engine import InferenceEngine, PagePoolExhausted
from repro_torch.serving.hibernation import HibernationStore
from tests._torch_pairs import configs, prompt, weights

MAX_LEN, PAGE = 64, 16


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg, tcfg)
    return dataclasses.replace(jcfg, use_pallas_decode=True), tcfg, jp, tp


@pytest.fixture(scope="module")
def jax_engines(pair):
    """One reference engine per layout, shared so that its jitted decode
    compiles once; each test starts it with every slot free."""
    jcfg, _, jp, _ = pair
    return {paged: JaxEngine(jcfg, params=jp, slots=2, max_len=MAX_LEN,
                             paged=paged, page_size=PAGE)
            for paged in (False, True)}


def _jax_engine(jax_engines, paged):
    eng = jax_engines[paged]
    for sid in list(eng._slot_map):
        eng.release_slot(sid)
    return eng


def _port_engine(pair, paged, slots=2, **kw):
    _, tcfg, _, tp = pair
    return InferenceEngine(tcfg, params=tp, slots=slots, max_len=MAX_LEN,
                           paged=paged, page_size=PAGE, device="cpu", **kw)


class _Bridged:
    """The port engine as the reference package sees it: payloads cross as
    numpy, through the bridge."""

    def __init__(self, engine):
        self.engine = engine

    def export_slot(self, sid):
        return bridge.payload_to_numpy(self.engine.export_slot(sid))

    def import_slot(self, sid, payload):
        self.engine.import_slot(sid, payload)

    def release_slot(self, sid):
        self.engine.release_slot(sid)


def _admit(engine, vocab):
    firsts = [engine.prefill_session("a", prompt(5, vocab, 1))["first_token"],
              engine.prefill_session("b", prompt(23, vocab, 2))["first_token"]]
    return firsts


@pytest.mark.parametrize("paged", [False, True])
class TestAgainstReferenceEngine:
    def test_32_step_greedy_stream_token_identical(self, pair, jax_engines, paged):
        vocab = pair[1].vocab_size
        jeng, teng = _jax_engine(jax_engines, paged), _port_engine(pair, paged)
        assert _admit(jeng, vocab) == _admit(teng, vocab)
        for _ in range(4):
            assert teng.decode_round(steps=8) == jeng.decode_round(steps=8)
        if paged:
            assert teng.free_pages() == jeng.free_pages()

    def test_export_payload_matches(self, pair, jax_engines, paged):
        vocab = pair[1].vocab_size
        jeng, teng = _jax_engine(jax_engines, paged), _port_engine(pair, paged)
        for eng in (jeng, teng):
            _admit(eng, vocab)
            eng.decode_round(steps=8)
        jpay, tpay = jeng.export_slot("b"), teng.export_slot("b")
        assert set(jpay) == set(tpay)
        assert {k: jpay[k] for k in ("position", "last_token",
                                     "adapter_id")} == \
            {k: tpay[k] for k in ("position", "last_token", "adapter_id")}
        jl = jax.tree.leaves(jpay["cache"])
        tl = bridge.leaves(tpay["cache"])
        assert [(a.shape, str(a.dtype)) for a in jl] == \
            [(tuple(b.shape), str(b.dtype).replace("torch.", "")) for b in tl]
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=1e-5, rtol=1e-5)
        # both packages' fingerprints hash the same bytes of a payload
        assert state_transfer.fingerprint(tpay) == \
            jax_transfer.fingerprint(bridge.payload_to_numpy(tpay))

    def test_reference_to_port_migration_continues(self, pair, jax_engines, paged):
        vocab = pair[1].vocab_size
        jeng, teng = _jax_engine(jax_engines, paged), _port_engine(pair, paged)
        _admit(jeng, vocab)
        jeng.decode_round(steps=8)
        meta = jax_transfer.transfer(jeng, _Bridged(teng), "b")
        assert meta["fingerprint"] == state_transfer.fingerprint(
            teng.export_slot("b"))
        jeng.release_slot("a")
        assert teng.decode_round(steps=8)["b"] == \
            jeng.decode_round(steps=8)["b"]

    def test_port_to_reference_migration_continues(self, pair, jax_engines, paged):
        vocab = pair[1].vocab_size
        jeng, teng = _jax_engine(jax_engines, paged), _port_engine(pair, paged)
        _admit(teng, vocab)
        teng.decode_round(steps=8)
        jax_transfer.transfer(_Bridged(teng), jeng, "a")
        teng.release_slot("b")
        assert jeng.decode_round(steps=8)["a"] == \
            teng.decode_round(steps=8)["a"]


class TestTiers:
    def test_dense_and_paged_fingerprints_agree(self, pair):
        vocab = pair[1].vocab_size
        dense, paged = _port_engine(pair, False), _port_engine(pair, True)
        for eng in (dense, paged):
            _admit(eng, vocab)
            eng.decode_round(steps=5)
        for sid in ("a", "b"):
            assert state_transfer.fingerprint(dense.export_slot(sid)) == \
                state_transfer.fingerprint(paged.export_slot(sid))

    def test_park_hibernate_resume_bit_exact(self, pair):
        vocab = pair[1].vocab_size
        eng = _port_engine(pair, True, hibernation=HibernationStore())
        twin = _port_engine(pair, True)
        for e in (eng, twin):
            _admit(e, vocab)
            e.decode_round(steps=4)
        before = state_transfer.fingerprint(eng.export_slot("a"))
        eng.park_slot("a")
        frozen = eng.decode_round(steps=4)          # only "b" advances
        assert set(frozen) == {"b"}
        assert eng.hibernate_slot("a")
        assert not eng.has_slot("a") and eng.has_hibernated("a")
        assert eng.position_of("a") == twin.position_of("a")
        eng.resume_session("a")
        assert state_transfer.fingerprint(eng.export_slot("a")) == before
        twin.park_slot("b")
        eng.park_slot("b")
        assert eng.decode_round(steps=6)["a"] == \
            twin.decode_round(steps=6)["a"]

    def test_page_exhaustion_reclaims_parked_first(self, pair):
        vocab = pair[1].vocab_size
        # 4 usable pages: "a" holds 2, "b" needs 3
        eng = _port_engine(pair, True, num_pages=5,
                           hibernation=HibernationStore())
        eng.prefill_session("a", prompt(20, vocab, 1))
        with pytest.raises(PagePoolExhausted):
            eng.prefill_session("b", prompt(40, vocab, 2))
        assert not eng.has_slot("b") and eng.free_pages() == 2
        eng.park_slot("a")
        eng.prefill_session("b", prompt(40, vocab, 2))
        assert eng.has_hibernated("a") and eng.has_slot("b")
        assert eng.free_pages() == 1


def test_prefill_compiles_counts_the_reference_buckets(pair):
    """The number of distinct prefill buckets a mix of prompt lengths
    uses: the reference's count of its jitted prefill variants."""
    jcfg, tcfg, jp, tp = pair
    jeng = JaxEngine(jcfg, params=jp, slots=2, max_len=MAX_LEN)
    teng = _port_engine(pair, False)
    assert teng.prefill_compiles == jeng.prefill_compiles == 0
    for i, n in enumerate((3, 17, 20, 16, 40, 5)):
        for eng in (jeng, teng):
            eng.prefill_session(f"s{i}", prompt(n, tcfg.vocab_size, i))
            eng.release_slot(f"s{i}")
        assert teng.prefill_compiles == jeng.prefill_compiles
    assert teng.prefill_compiles == 3           # buckets 16, 32, 64


def test_serve_matches_reference_launcher(monkeypatch):
    """Same sessions, same requests served, through both northbound stacks
    (the session-id counters of both packages are pinned and restored, and
    both launchers run on a virtual clock: on the wall clock a DISCOVER
    slowed past its 50 ms timer by a loaded host fails, and the client's
    retry draws another session id)."""
    monkeypatch.setattr(jax_session, "_ids", itertools.count(1))
    monkeypatch.setattr(port_session, "_ids", itertools.count(1))
    monkeypatch.setattr(jax_serve_mod, "Clock", jax_clock.VirtualClock)
    monkeypatch.setattr(port_serve_mod, "Clock", port_clock.VirtualClock)
    kw = dict(sessions=2, requests=4, slots=2, gen_tokens=4, quiet=True)
    j_served, j_reports = jax_serve("edge-tiny", **kw)
    t_served, t_reports = serve("edge-tiny", device="cpu", **kw)
    assert t_served == j_served == 4
    assert list(t_reports) == list(j_reports)
    assert [r.n for r in t_reports.values()] == \
        [r.n for r in j_reports.values()]
    assert all(r.in_compliance for r in t_reports.values())


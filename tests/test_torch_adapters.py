"""The port's multi-tenant LoRA adapter runtime against the reference
package's, on the CPU with bridged float32 edge-tiny weights.

* ``AdapterRuntime`` tables, load, unload and rank zero-padding match the
  reference's; ``lora_delta`` (gather and grouped routes) and
  ``lora_apply_rows`` match the reference's to 1e-5 (f32, different
  summation order; the reference's grouped route runs its Pallas kernel in
  interpret mode, the port's the plain version of its grouped GEMM).
* An engine with adapters gives the reference engine's tokens on both
  routes; a mixed batch gives each session the tokens it gets alone; base
  sessions are bit-identical to an adapter-free engine.
* The adapter binding is part of the session contract: it is in the payload
  fingerprint, survives migration between the packages and hibernation,
  and a target without the adapter refuses the import.
* ``LoadAdapterRequest`` through the northbound gateway installs the
  adapter in port engines, and a session bound to it serves through them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.adapters.runtime import AdapterRuntime as JaxRuntime
from repro.adapters.runtime import lora_apply_rows as jax_apply_rows
from repro.adapters.runtime import lora_delta as jax_lora_delta
from repro.serving import state_transfer as jax_transfer
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch import bridge
from repro_torch.adapters import (AdapterRuntime, AdapterSpec,
                                  init_adapter_weights)
from repro_torch.adapters.runtime import lora_apply_rows, lora_delta
from repro_torch.api import NorthboundGateway
from repro_torch.api import messages as m
from repro_torch.core import Orchestrator
from repro_torch.core.asp import QualityTier, default_asp
from repro_torch.core.clock import VirtualClock
from repro_torch.serving import state_transfer
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.plane import RealEngineBackend, ServingPlane
from repro_torch.serving.state_transfer import AdmissionDenied
from tests._torch_pairs import configs, prompt, weights

TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN = 64


def weights_for(adapter_id, d_model, *, rank=4, seed=0, scale=10.0):
    """Catalog weights for an adapter id (a function of the id alone, so
    engines that load different subsets agree per id); scale 10 makes the
    delta large enough to move greedy tokens."""
    return init_adapter_weights(AdapterSpec(
        adapter_id, "1.0", "edge-tiny", "1.0", rank=rank, seed=seed,
        scale=scale), d_model)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _h(n, d, seed=5):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


class TestRuntime:
    def test_tables_match_reference_through_load_and_unload(self):
        d = 32
        jrt = JaxRuntime(d, max_adapters=3, rank=4)
        trt = AdapterRuntime(d, max_adapters=3, rank=4, device="cpu")

        def same():
            np.testing.assert_array_equal(trt.A.numpy(), np.asarray(jrt.A))
            np.testing.assert_array_equal(trt.B.numpy(), np.asarray(jrt.B))
            assert trt.loaded() == jrt.loaded()

        for aid, rank in (("x", 4), ("lo", 2), ("y", 4)):
            w = weights_for(aid, d, rank=rank)
            assert trt.load(aid, *w) == jrt.load(aid, *w)
        same()
        with pytest.raises(RuntimeError, match="table full"):
            trt.load("z", *weights_for("z", d))
        assert trt.load("x", *weights_for("x", d)) == 1     # idempotent
        trt.unload("lo")
        jrt.unload("lo")
        same()
        w = weights_for("z", d)
        assert trt.load("z", *w) == jrt.load("z", *w) == 2  # slot reused
        same()
        assert trt.index_of("") == 0
        with pytest.raises(KeyError):
            trt.index_of("lo")

    def test_null_row_gives_exact_zero_delta(self):
        rt = AdapterRuntime(32, max_adapters=2, rank=4, device="cpu")
        rt.load("x", *weights_for("x", 32))
        h = torch.ones((4, 32))
        for route in ("gather", "grouped"):
            delta = lora_delta(h, rt.A, rt.B,
                               torch.zeros(4, dtype=torch.int32), route=route)
            assert float(delta.abs().max()) == 0.0

    @pytest.mark.parametrize("route", ["gather", "grouped"])
    @pytest.mark.parametrize("idx_mix", [
        [0, 0, 0, 0], [1, 1, 1, 1], [2, 0, 1, 2], [0, 2, 0, 1, 1, 0, 2],
    ])
    def test_lora_delta_matches_reference(self, route, idx_mix):
        """Every batch composition, all-base and empty groups included."""
        d = 64
        jrt = JaxRuntime(d, max_adapters=3, rank=4, route=route)
        trt = AdapterRuntime(d, max_adapters=3, rank=4, route=route,
                             device="cpu")
        for i, aid in enumerate(("x", "y")):
            w = weights_for(aid, d, seed=i)
            jrt.load(aid, *w)
            trt.load(aid, *w)
        h = _h(len(idx_mix), d)
        idx = np.asarray(idx_mix, np.int32)
        want = jax_lora_delta(h, jrt.A, jrt.B, idx, route=route)
        got = lora_delta(torch.from_numpy(h), trt.A, trt.B,
                         torch.from_numpy(idx), route=route)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        other = "gather" if route == "grouped" else "grouped"
        np.testing.assert_allclose(
            lora_delta(torch.from_numpy(h), trt.A, trt.B,
                       torch.from_numpy(idx), route=other).numpy(),
            got.numpy(), **TOL)

    def test_lora_apply_rows_matches_reference(self):
        a, b = weights_for("x", 48)
        h = _h(3, 48)
        np.testing.assert_allclose(
            lora_apply_rows(torch.from_numpy(h), torch.from_numpy(a),
                            torch.from_numpy(b)).numpy(),
            np.asarray(jax_apply_rows(h, a, b)), **TOL)

    def test_routes(self):
        assert AdapterRuntime(8, device="cpu").route == "gather"
        assert AdapterRuntime(8, route="grouped", device="cpu").route == \
            "grouped"
        with pytest.raises(ValueError, match="unknown adapter route"):
            AdapterRuntime(8, route="banana", device="cpu")


def _runtime(d, route="gather", adapters=("acme", "globex")):
    rt = AdapterRuntime(d, max_adapters=4, rank=4, route=route, device="cpu")
    for aid in adapters:
        rt.load(aid, *weights_for(aid, d))
    return rt


def _port_engine(cfg, params, *, slots=4, route="gather",
                 adapters=("acme", "globex"), **kw):
    return InferenceEngine(cfg, params=params, slots=slots, max_len=MAX_LEN,
                           adapters=_runtime(cfg.d_model, route, adapters),
                           device="cpu", **kw)


SESSIONS = (("s-acme", "acme", 7), ("s-glob", "globex", 11),
            ("s-base", "", 9))


def _admit_all(eng, vocab, sessions=SESSIONS):
    return [eng.prefill_session(sid, prompt(n, vocab, n),
                                adapter_id=aid)["first_token"]
            for sid, aid, n in sessions]


def _decode(eng, chunks=(4, 3)):
    out = {}
    for k in chunks:
        for sid, toks in eng.decode_round(steps=k).items():
            out.setdefault(sid, []).extend(toks)
    return out


class TestAdapterEngine:
    @pytest.mark.parametrize("route", ["gather", "grouped"])
    def test_matches_reference_engine(self, pair, route):
        jcfg, tcfg, jp, tp = pair
        jrt = JaxRuntime(jcfg.d_model, max_adapters=4, rank=4, route=route)
        for aid in ("acme", "globex"):
            jrt.load(aid, *weights_for(aid, jcfg.d_model))
        jeng = JaxEngine(jcfg, params=jp, slots=4, max_len=MAX_LEN,
                         adapters=jrt)
        teng = _port_engine(tcfg, tp, route=route)
        assert _admit_all(teng, tcfg.vocab_size) == \
            _admit_all(jeng, jcfg.vocab_size)
        assert _decode(teng) == _decode(jeng)

    @pytest.mark.parametrize("arch", ["edge-tiny", "qwen3-moe-30b-a3b"])
    def test_mixed_batch_identical_to_individual(self, pair, arch):
        """One fused chunk over {acme, globex, base} slots gives every
        session the tokens of an engine of the same shape serving only it,
        on both routes (dense and MoE base models)."""
        if arch == "edge-tiny":
            _, cfg, _, params = pair
        else:
            cfg = dataclasses.replace(configs(arch, smoke=True)[1])
            params = None
        for route in ("gather", "grouped"):
            mux = _port_engine(cfg, params, route=route)
            _admit_all(mux, cfg.vocab_size)
            together = _decode(mux)
            for sess in SESSIONS:
                solo = _port_engine(cfg, mux.params, route=route,
                                    adapters=(sess[1],) if sess[1] else ())
                _admit_all(solo, cfg.vocab_size, (sess,))
                assert _decode(solo)[sess[0]] == together[sess[0]], sess

    def test_adapters_change_tokens_and_base_is_bit_identical(self, pair):
        """Row 0 of the tables is all-zero: an engine with a runtime (and
        other tenants' adapters loaded) serves base sessions exactly as an
        engine with none, while an adapter moves the stream."""
        _, tcfg, _, tp = pair
        plain = InferenceEngine(tcfg, params=tp, slots=4, max_len=MAX_LEN,
                                device="cpu")
        mux = _port_engine(tcfg, tp)
        p = prompt(8, tcfg.vocab_size, 4)
        plain.prefill_session("s", p)
        mux.prefill_session("s", p)
        mux.prefill_session("t", p, adapter_id="acme")
        base, out = plain.decode_round(steps=6), mux.decode_round(steps=6)
        assert base["s"] == out["s"]
        assert out["t"] != out["s"]

    def test_prefill_refuses_unloaded_adapter(self, pair):
        _, tcfg, _, tp = pair
        eng = _port_engine(tcfg, tp, adapters=("acme",))
        with pytest.raises(ValueError, match="not loaded"):
            eng.prefill_session("s", np.arange(4, dtype=np.int32),
                                adapter_id="ghost")
        plain = InferenceEngine(tcfg, params=tp, slots=2, max_len=MAX_LEN,
                                device="cpu")
        with pytest.raises(ValueError, match="no adapter runtime"):
            plain.prefill_session("s", np.arange(4, dtype=np.int32),
                                  adapter_id="acme")
        with pytest.raises(RuntimeError, match="no adapter runtime"):
            plain.load_adapter("acme", *weights_for("acme", tcfg.d_model))

    def test_unload_refused_while_bound(self, pair):
        _, tcfg, _, tp = pair
        eng = _port_engine(tcfg, tp, adapters=("acme",))
        eng.prefill_session("s", np.arange(4, dtype=np.int32),
                            adapter_id="acme")
        with pytest.raises(RuntimeError, match="still bound"):
            eng.unload_adapter("acme")
        eng.release_slot("s")
        eng.unload_adapter("acme")
        assert not eng.adapters.is_loaded("acme")

    def test_spec_decode_refuses_adapter_bound_sessions_first(self, pair):
        """Adapter-bound sessions get the reference's refusal; a base
        session on the same engine runs its speculative round and gets the
        reference engine's tokens."""
        jcfg, tcfg, jp, tp = pair
        eng = _port_engine(tcfg, tp)
        _admit_all(eng, tcfg.vocab_size)
        for call in (lambda: eng.spec_round("s-acme", 2),
                     lambda: eng.spec_grade("s-acme", [1, 2])):
            with pytest.raises(ValueError, match="adapter-bound"):
                call()
        jrt = JaxRuntime(jcfg.d_model, max_adapters=4, rank=4)
        for aid in ("acme", "globex"):
            jrt.load(aid, *weights_for(aid, jcfg.d_model))
        jeng = JaxEngine(jcfg, params=jp, slots=4, max_len=MAX_LEN,
                         adapters=jrt)
        _admit_all(jeng, jcfg.vocab_size)
        assert eng.spec_round("s-base", 2) == jeng.spec_round("s-base", 2)

    def test_engine_rejects_tables_on_another_device(self, pair):
        _, tcfg, _, tp = pair
        rt = AdapterRuntime(tcfg.d_model, device="cpu")
        rt.device = torch.device("cuda")
        with pytest.raises(ValueError, match="adapter tables"):
            InferenceEngine(tcfg, params=tp, slots=2, max_len=MAX_LEN,
                            adapters=rt, device="cpu")


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


class TestAdapterSessionContract:
    def test_fingerprint_binds_adapter_id_as_the_reference_does(self, pair):
        _, tcfg, _, tp = pair
        eng = _port_engine(tcfg, tp)
        p = prompt(6, tcfg.vocab_size)
        eng.prefill_session("a", p, adapter_id="acme")
        eng.prefill_session("b", p)
        pa, pb = eng.export_slot("a"), eng.export_slot("b")
        assert pa["adapter_id"] == "acme"
        assert state_transfer.fingerprint(pa) != state_transfer.fingerprint(
            dict(pa, adapter_id=""))
        legacy = {k: v for k, v in pb.items() if k != "adapter_id"}
        assert state_transfer.fingerprint(pb) == \
            state_transfer.fingerprint(legacy)
        assert state_transfer.fingerprint(pa) == \
            jax_transfer.fingerprint(bridge.payload_to_numpy(pa))

    def test_import_refused_when_target_lacks_adapter(self, pair):
        _, tcfg, _, tp = pair
        src = _port_engine(tcfg, tp)
        src.prefill_session("m", np.arange(6, dtype=np.int32),
                            adapter_id="acme")
        payload = src.export_slot("m")
        bare = InferenceEngine(tcfg, params=tp, slots=2, max_len=MAX_LEN,
                               device="cpu")
        with pytest.raises(AdmissionDenied, match="acme"):
            bare.import_slot("m", payload)
        wrong = _port_engine(tcfg, tp, adapters=("globex",))
        with pytest.raises(AdmissionDenied, match="acme"):
            wrong.import_slot("m", payload)
        assert not wrong.has_slot("m") and wrong.free_slots() == 4

    def test_migration_between_packages_keeps_binding(self, pair):
        """reference -> port -> reference with an adapter bound, through the
        reference's transfer (fingerprint-checked on each hop); the stream
        then continues as an unmigrated reference session's."""
        jcfg, tcfg, jp, tp = pair
        jrt = JaxRuntime(jcfg.d_model, max_adapters=4, rank=4)
        jrt.load("acme", *weights_for("acme", jcfg.d_model))
        jeng = JaxEngine(jcfg, params=jp, slots=4, max_len=MAX_LEN,
                         adapters=jrt)
        p = prompt(10, tcfg.vocab_size, 3)
        jeng.prefill_session("ref", p, adapter_id="acme")
        jeng.prefill_session("m", p, adapter_id="acme")
        jeng.decode_round(steps=5)
        teng = _port_engine(tcfg, tp, adapters=("acme",))
        jax_transfer.transfer(jeng, _Bridged(teng), "m")
        jeng.release_slot("m")
        assert teng.export_slot("m")["adapter_id"] == "acme"
        got = teng.decode_round(steps=3)["m"]
        want = jeng.decode_round(steps=3)["ref"]   # "ref" keeps pace
        jax_transfer.transfer(_Bridged(teng), jeng, "m")
        teng.release_slot("m")
        out = jeng.decode_round(steps=4)
        assert got == want and out["m"] == out["ref"]

    def test_hibernate_resume_preserves_binding(self, pair):
        _, tcfg, _, tp = pair
        twin = _port_engine(tcfg, tp, adapters=("acme",))
        eng = _port_engine(tcfg, tp, adapters=("acme",), hibernation=True)
        p = prompt(8, tcfg.vocab_size, 5)
        for e in (twin, eng):
            e.prefill_session("h", p, adapter_id="acme")
            e.decode_round(steps=4)
        fp = state_transfer.fingerprint(eng.export_slot("h"))
        assert eng.hibernate_slot("h") and eng.has_hibernated("h")
        eng.resume_session("h")
        assert state_transfer.fingerprint(eng.export_slot("h")) == fp
        assert eng.export_slot("h")["adapter_id"] == "acme"
        assert eng.decode_round(steps=7) == twin.decode_round(steps=7)


def send(gw, msg):
    out = gw.handle_json(msg.to_json())
    if isinstance(out, list):
        return [m.from_json(o) for o in out]
    return m.from_json(out)


class TestGatewayAdapterLifecycle:
    def test_load_adapter_request_reaches_port_engines(self, pair):
        """Register and load an adapter through the gateway: it lands in the
        port engine of every site; a session bound to it serves through
        them with the tokens a standalone port engine gives; unload is
        refused while the session is bound and empties the tables after."""
        _, tcfg, _, tp = pair
        clock = VirtualClock()
        orch = Orchestrator(clock=clock)
        engines = {}
        for site_id, site in orch.sites.items():
            eng = InferenceEngine(tcfg, params=tp, slots=2, max_len=MAX_LEN,
                                  adapters=AdapterRuntime(
                                      tcfg.d_model, rank=4, device="cpu"),
                                  device="cpu")
            site.attach_engine(eng)
            site.attach_plane(ServingPlane(
                clock, RealEngineBackend(eng, clock), slots=2,
                site_id=site_id))
            engines[site_id] = eng
        gw = NorthboundGateway(orch)
        reg = send(gw, m.RegisterAdapterRequest(
            adapter_id="acme", base_model_id="edge-tiny", rank=4))
        assert isinstance(reg, m.RegisterAdapterResponse)
        for site_id, eng in engines.items():
            load = send(gw, m.LoadAdapterRequest(adapter_id="acme",
                                                 site_id=site_id))
            assert isinstance(load, m.LoadAdapterResponse)
            assert load.engine_loaded and eng.adapters.is_loaded("acme")
        a, b = orch.catalog.adapters.weights("acme")
        np.testing.assert_array_equal(
            engines["edge-a"].adapters.A[1].numpy()[:, :4], a)

        asp = dataclasses.replace(default_asp(tier=QualityTier.BASIC),
                                  adapter_id="acme")
        disc = send(gw, m.DiscoverRequest(invoker="t1", zone="zone-a",
                                          asp=asp))
        sid = disc.session_id
        send(gw, m.PageRequest(session_id=sid))
        prep = send(gw, m.PrepareRequest(session_id=sid,
                                         idempotency_key="p"))
        send(gw, m.CommitRequest(session_id=sid,
                                 prepared_ref=prep.prepared_ref,
                                 idempotency_key="c"))
        p = prompt(12, tcfg.vocab_size, 6)
        frames = send(gw, m.ServeRequest(
            session_id=sid, prompt_tokens=len(p), gen_tokens=5,
            prompt=[int(t) for t in p]))
        done = frames[-1]
        assert done.completed and len(done.token_ids) == 5
        solo = _port_engine(tcfg, tp, adapters=())
        solo.load_adapter("acme", a, b)
        assert solo.serve("x", len(p), 5, prompt=p,
                          adapter_id="acme")["tokens"] == done.token_ids

        refused = send(gw, m.UnloadAdapterRequest(adapter_id="acme",
                                                  site_id="edge-a"))
        assert isinstance(refused, m.ErrorResponse)
        assert "still bound" in refused.detail
        send(gw, m.ReleaseRequest(session_id=sid))
        for site_id, eng in engines.items():
            out = send(gw, m.UnloadAdapterRequest(adapter_id="acme",
                                                  site_id=site_id))
            assert isinstance(out, m.UnloadAdapterResponse) and out.unloaded
            assert not eng.adapters.is_loaded("acme")

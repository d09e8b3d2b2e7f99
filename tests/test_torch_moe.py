"""The port's MoE family against the reference package's, on the CPU with the
qwen3-moe smoke config (4 experts, top-2, 2 layers) and bridged float32
weights.

* ``moe_apply`` matches the reference for all three implementations, on
  the flattened branch (``s < 64``), the per-row chunked branch (``s = 64``
  with ``moe_chunk = 32``) and the divisor search (``s = 80``), and drops
  the same assignments when the capacity factor is cut to 0.5.
* The LM's prefill logits and the engine's greedy streams (dense and paged)
  match the reference's; sessions migrate between the two packages through
  the reference's ``state_transfer.transfer`` with the fingerprint holding;
  hibernation round-trips bit for bit.

Tolerances: 1e-5 for the MoE layer (f32, different summation order), 1e-4
for logits after the 2-layer stack (as for the dense family).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as JM
from repro.models.transformer import LM as JaxLM
from repro.serving import state_transfer as jax_transfer
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as TM
from repro_torch.models.transformer import LM
from repro_torch.serving import state_transfer
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.hibernation import HibernationStore
from tests._torch_pairs import configs, prompt, weights

ARCH = "qwen3-moe-30b-a3b"
MAX_LEN, PAGE = 64, 16
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs(ARCH, smoke=True)
    jp, tp = weights(jcfg, tcfg)
    return dataclasses.replace(jcfg, use_pallas_decode=True), tcfg, jp, tp


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            {k: v[0] for k, v in tp["layers"]["moe"].items()})


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


class TestMoeLayer:
    @pytest.mark.parametrize("impl", ["einsum", "scatter", "dense"])
    @pytest.mark.parametrize("s", [5, 64, 80])
    def test_moe_apply_matches_reference(self, pair, impl, s):
        jcfg, tcfg, jp, tp = pair
        jc = dataclasses.replace(jcfg, moe_impl=impl)
        tc = dataclasses.replace(tcfg, moe_impl=impl)
        pj, pt = _layer0(jp, tp)
        x = _x(2, s, tc.d_model, s)
        oj, aj = JM.moe_apply(pj, jc, jnp.asarray(x))
        ot, at = TM.moe_apply(pt, tc, torch.from_numpy(x))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
        np.testing.assert_allclose(float(at), float(aj), **TOL)

    @pytest.mark.parametrize("impl", ["einsum", "scatter"])
    def test_capacity_drops_match_reference(self, pair, impl):
        """Capacity factor 0.5: each 32-token chunk of a row gets C = 8
        slots per expert for ~16 assignments, so tokens drop. Both packages
        route the same experts, drop the same assignments (token-major
        positions past C) and give the same output."""
        jcfg, tcfg, jp, tp = pair
        jc = dataclasses.replace(jcfg, moe_impl=impl, moe_capacity_factor=0.5)
        tc = dataclasses.replace(tcfg, moe_impl=impl, moe_capacity_factor=0.5)
        pj, pt = _layer0(jp, tp)
        x = _x(2, 64, tc.d_model, 7)
        oj, _ = JM.moe_apply(pj, jc, jnp.asarray(x))
        ot, _ = TM.moe_apply(pt, tc, torch.from_numpy(x))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
        E, k, T = tc.num_experts, tc.num_experts_per_tok, tc.moe_chunk
        C = TM._capacity(tc, T)
        assert C == JM._capacity(jc, T) == 8
        drops = 0
        for r in range(2):
            for j in range(64 // T):
                xt = x[r, j * T:(j + 1) * T]
                _, ji, _ = JM._route(pj, jc, jnp.asarray(xt))
                onehot = np.asarray(jax.nn.one_hot(ji, E, dtype=jnp.int32))
                flat = onehot.reshape(T * k, E)
                jpos = ((np.cumsum(flat, 0) * flat - 1).reshape(T, k, E)
                        * onehot).sum(-1)
                _, ti, _ = TM._route(pt, tc, torch.from_numpy(xt))
                tpos = TM._positions(tc, ti, T).numpy()
                np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
                np.testing.assert_array_equal(tpos >= C, jpos >= C)
                drops += int((tpos >= C).sum())
        assert drops > 0

    def test_capacity_rule(self):
        """Decode at 8 slots of qwen3-moe: 0.6 assignments per expert,
        rounded up to the minimum of 8; a 2048-token prefill row: 160."""
        _, tc = configs(ARCH)
        assert TM._capacity(tc, 8) == 8
        assert TM._capacity(tc, 2048) == 160


class TestMoeModel:
    def test_init_tree_matches_reference_in_bf16(self):
        """The port's seeded init has the reference's leaves, shapes and
        dtypes at the working dtype: bf16 experts, an f32 router."""
        jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
        spec = JaxLM(jcfg).param_specs()
        tp = LM(tcfg).init(0, "cpu")
        assert [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(spec)] \
            == [(tuple(b.shape), str(b.dtype).replace("torch.", ""))
                for b in bridge.leaves(tp)]
        assert tp["layers"]["moe"]["router"].dtype == torch.float32
        assert "mlp" not in tp["layers"]

    def test_prefill_logits_match_reference(self, pair):
        jcfg, tcfg, jp, tp = pair
        toks = prompt(37, tcfg.vocab_size, 3)
        padded = np.zeros((1, 64), np.int32)
        padded[0, :37] = toks
        lj, cj = JaxLM(jcfg).prefill(jp, {"tokens": jnp.asarray(padded),
                                          "length": jnp.int32(37)}, MAX_LEN)
        lt, ct = LM(tcfg).prefill(tp, {"tokens": torch.from_numpy(padded),
                                       "length": 37}, MAX_LEN)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)
        for key in ("k", "v"):
            np.testing.assert_allclose(
                ct["layers"][key].numpy()[:, :, :37],
                np.asarray(cj["layers"][key])[:, :, :37], **TOL)


@pytest.fixture(scope="module")
def jax_engines(pair):
    jcfg, _, jp, _ = pair
    return {paged: JaxEngine(jcfg, params=jp, slots=2, max_len=MAX_LEN,
                             paged=paged, page_size=PAGE)
            for paged in (False, True)}


def _jax_engine(jax_engines, paged):
    eng = jax_engines[paged]
    for sid in list(eng._slot_map):
        eng.release_slot(sid)
    return eng


def _port_engine(pair, paged, **kw):
    _, tcfg, _, tp = pair
    return InferenceEngine(tcfg, params=tp, slots=2, max_len=MAX_LEN,
                           paged=paged, page_size=PAGE, device="cpu", **kw)


def _admit(engine, vocab):
    return [engine.prefill_session("a", prompt(9, vocab, 1))["first_token"],
            engine.prefill_session("b", prompt(29, vocab, 2))["first_token"]]


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


@pytest.mark.parametrize("paged", [False, True])
class TestMoeEngine:
    def test_greedy_stream_token_identical(self, pair, jax_engines, paged):
        vocab = pair[1].vocab_size
        jeng, teng = _jax_engine(jax_engines, paged), _port_engine(pair, paged)
        assert _admit(jeng, vocab) == _admit(teng, vocab)
        for _ in range(3):
            assert teng.decode_round(steps=8) == jeng.decode_round(steps=8)

    def test_migration_both_ways_keeps_fingerprint(self, pair, jax_engines,
                                                   paged):
        """reference -> port -> reference through the reference's own
        transfer (it checks the fingerprint on each hop); the stream then
        continues as the reference's own."""
        vocab = pair[1].vocab_size
        jeng = _jax_engine(jax_engines, paged)
        teng = _port_engine(pair, paged)
        _admit(jeng, vocab)
        jeng.decode_round(steps=4)
        before = jax_transfer.fingerprint(jeng.export_slot("b"))
        meta = jax_transfer.transfer(jeng, _Bridged(teng), "b")
        assert meta["fingerprint"] == before == state_transfer.fingerprint(
            teng.export_slot("b"))
        jeng.release_slot("b")
        jax_transfer.transfer(_Bridged(teng), jeng, "b")
        assert jax_transfer.fingerprint(jeng.export_slot("b")) == before
        twin = _port_engine(pair, paged)
        _admit(twin, vocab)
        twin.decode_round(steps=4)
        assert twin.decode_round(steps=6)["b"] == \
            jeng.decode_round(steps=6)["b"]

    def test_hibernate_resume_bit_exact(self, pair, paged):
        vocab = pair[1].vocab_size
        eng = _port_engine(pair, paged, hibernation=HibernationStore())
        twin = _port_engine(pair, paged)
        for e in (eng, twin):
            _admit(e, vocab)
            e.decode_round(steps=3)
        before = state_transfer.fingerprint(eng.export_slot("a"))
        assert eng.hibernate_slot("a") and eng.has_hibernated("a")
        eng.resume_session("a")
        assert state_transfer.fingerprint(eng.export_slot("a")) == before
        assert eng.decode_round(steps=5) == twin.decode_round(steps=5)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_drops_with_inactive_slots_match_reference(pair, paged):
    """Decode routes every slot's token, inactive slots' included, through
    one capacity buffer. At 20 slots and capacity factor 0.25, C = 8, so a
    step routes 40 assignments into E·C = 32 places and drops at least 8;
    which ones drop depends on what the inactive slots (never admitted, or
    freed mid-stream, ahead of live ones in token-major order) are fed. The
    port's streams must be the reference's, token for token."""
    jcfg, tcfg, jp, tp = pair
    jc = dataclasses.replace(jcfg, moe_capacity_factor=0.25)
    tc = dataclasses.replace(tcfg, moe_capacity_factor=0.25)
    slots, E, k = 20, tc.num_experts, tc.num_experts_per_tok
    assert TM._capacity(tc, slots) == JM._capacity(jc, slots) == 8
    assert slots * k > E * 8
    jeng = JaxEngine(jc, params=jp, slots=slots, max_len=MAX_LEN,
                     paged=paged, page_size=PAGE)
    teng = InferenceEngine(tc, params=tp, slots=slots, max_len=MAX_LEN,
                           paged=paged, page_size=PAGE, device="cpu")
    vocab = tc.vocab_size

    def admit(names):
        return [[e.prefill_session(sid, prompt(5 + 3 * n, vocab, 40 + n))[
            "first_token"] for e in (jeng, teng)] for n, sid in names]

    for a, b in admit([(n, f"s{n}") for n in range(14)]):
        assert a == b
    assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)
    for sid in ("s1", "s5"):                   # free slots ahead of live ones
        jeng.release_slot(sid)
        teng.release_slot(sid)
    assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)
    for a, b in admit([(14, "s14")]):         # takes a freed slot
        assert a == b
    for _ in range(2):
        assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)

"""mixtral-8x7b in the port against the reference package, on the CPU: its
smoke config (2 layers, 4 experts top-2, sliding window 16) in float32 with
int8 weights quantised by the reference's ``quantize_tree`` and carried
through the bridge.

* ``LM.prefill`` of right-padded prompts of 10, 20 and 40 tokens (buckets
  16, 32, 64; 20 and 40 pass the window, so the ring keeps only the last 16
  positions and routes the bucket's padding to the discard row): logits and
  the ring cache within 1e-5; decode crosses the window with the same
  greedy tokens and logits within 1e-5.
* ``InferenceEngine`` streams are token-identical to the reference
  engine's; ``paged=True`` keeps the dense layout (a window does not page).
* A session moved mid-stream from a reference engine into a port engine
  through the reference's ``state_transfer.transfer`` (fingerprint checked
  on the hop) continues token for token.
* A speculative round accepted at ``n < γ`` restores the ring rows: the
  state fingerprints as a plain decode of the committed tokens leaves it,
  and agrees with the reference's within 1e-5.

Tolerance 1e-5: the same f32 arithmetic in two frameworks, summed in
another order; int8 weights dequantise to the same bf16 values in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import quant as JQ
from repro.models.transformer import LM as JaxLM
from repro.serving import state_transfer as jax_transfer
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch import bridge
from repro_torch.models import kvcache as KV
from repro_torch.models import quant as Q
from repro_torch.models.transformer import LM
from repro_torch.serving import state_transfer
from repro_torch.serving.engine import InferenceEngine
from tests._torch_pairs import configs, prompt

MAX_LEN = 96
TOL = dict(atol=1e-5, rtol=1e-5)
LENS = {"a": 10, "b": 20, "c": 40}


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs("mixtral-8x7b", smoke=True)
    assert tcfg.sliding_window == 16 and tcfg.family == "moe"
    jp = JQ.quantize_tree(JaxLM(jcfg).init(jax.random.key(0)))
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert Q.is_quantized(tp["layers"]["moe"]["w_gate"])
    assert tp["layers"]["moe"]["w_gate"]["q"].dtype == torch.int8
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def jax_engine(pair):
    jcfg, _, jp, _ = pair
    return JaxEngine(jcfg, params=jp, slots=3, max_len=MAX_LEN)


def _fresh(eng):
    eng._spec_pending.clear()
    for sid in list(eng._slot_map):
        eng.release_slot(sid)
    return eng


def _port(pair, **kw):
    _, tcfg, _, tp = pair
    return InferenceEngine(tcfg, params=tp, slots=3, max_len=MAX_LEN,
                           device="cpu", **kw)


def _admit(engine, vocab, names=("a", "b", "c")):
    return [engine.prefill_session(sid, prompt(LENS[sid], vocab,
                                                ord(sid)))["first_token"]
            for sid in names]


class _Bridged:
    """A port engine as the reference package sees it: payloads cross as
    numpy, through the bridge."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def export_slot(self, sid):
        return bridge.payload_to_numpy(self.engine.export_slot(sid))


@pytest.mark.parametrize("n,bucket", [(10, 16), (20, 32), (40, 64)])
def test_prefill_ring_and_decode_match_reference(pair, n, bucket):
    jcfg, tcfg, jp, tp = pair
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompt(n, tcfg.vocab_size, n)
    lj, cj = JaxLM(jcfg).prefill(jp, {"tokens": jnp.asarray(padded),
                                      "length": jnp.int32(n)}, MAX_LEN)
    lt, ct = LM(tcfg).prefill(tp, {"tokens": torch.from_numpy(padded),
                                   "length": n}, MAX_LEN)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert ct["layers"]["k"].shape[2] == tcfg.sliding_window
    for a, b in zip(jax.tree.leaves(cj), bridge.leaves(ct)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for _ in range(8):                      # 10 + 8 > 16: every case wraps
        lj, cj = JaxLM(jcfg).decode_step(jp, cj, jnp.asarray(tok))
        lt, ct = LM(tcfg).decode_step(tp, ct, torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tok = np.asarray(jnp.argmax(lj[:, 0], -1))[:, None].astype(np.int32)
        assert (lt[:, 0].argmax(-1).numpy() == tok[:, 0]).all()


@pytest.mark.parametrize("paged", [False, True])
def test_engine_streams_token_identical(pair, jax_engine, paged):
    vocab = pair[1].vocab_size
    jeng, teng = _fresh(jax_engine), _port(pair, paged=paged)
    assert teng.paged is False and not teng._canonical
    assert _admit(teng, vocab) == _admit(jeng, vocab)
    for _ in range(3):
        assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)


def test_session_moves_from_the_reference_mid_stream(pair, jax_engine):
    """reference -> port through the reference's own transfer, the ring
    wrapped; the port engine then continues the session token for token
    as the reference engine does, and its payload is ``cache_bytes`` of
    one slot."""
    vocab = pair[1].vocab_size
    jeng, teng = _fresh(jax_engine), _port(pair)
    _admit(jeng, vocab)
    jeng.decode_round(steps=6)              # "a" wraps its ring of 16
    for sid in ("a", "c"):
        before = jax_transfer.fingerprint(jeng.export_slot(sid))
        meta = jax_transfer.transfer(jeng, _Bridged(teng), sid)
        assert meta["fingerprint"] == before == state_transfer.fingerprint(
            teng.export_slot(sid))
    assert state_transfer.payload_bytes(teng.export_slot("a")) == \
        KV.cache_bytes(pair[1], 1, MAX_LEN)
    for _ in range(3):
        got, want = teng.decode_round(steps=4), jeng.decode_round(steps=4)
        assert got == {sid: want[sid] for sid in ("a", "c")}


@pytest.mark.parametrize("n", [0, 2])
def test_spec_accept_restores_the_ring(pair, jax_engine, n):
    """A drafted round of γ 3 on a session whose ring has wrapped, n < γ of
    it committed: the port's state fingerprints as a plain decode of the
    committed tokens leaves it and agrees with the reference's."""
    gamma, vocab = 3, pair[1].vocab_size
    jeng, teng, plain = _fresh(jax_engine), _port(pair), _port(pair)
    for eng in (jeng, teng, plain):
        _admit(eng, vocab, ("b",))
        eng.decode_round(steps=2)           # position 22 > the window
    d = teng.spec_round("b", gamma)
    assert d == jeng.spec_round("b", gamma)
    for eng in (jeng, teng):
        eng.spec_accept("b", n, 7)
    plain.decode_round(steps=n + 1)
    plain.override_last_token("b", 7)
    assert state_transfer.fingerprint(teng.export_slot("b")) == \
        state_transfer.fingerprint(plain.export_slot("b"))
    jpay = jeng.export_slot("b")
    tpay = bridge.payload_to_numpy(teng.export_slot("b"))
    assert tpay["position"] == int(jpay["position"])
    for a, b in zip(bridge.leaves(jpay["cache"]),
                    bridge.leaves(tpay["cache"])):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), **TOL)
    assert teng.decode_round(steps=4)["b"] == jeng.decode_round(steps=4)["b"]

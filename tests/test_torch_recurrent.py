"""The port's recurrent families against the reference package's, on the
CPU with bridged float32 weights: recurrentgemma-2b (hybrid: RG-LRU blocks
and sliding-window attention, pattern rec, rec, attn, rec; window 16) and
mamba2-1.3b (SSM: Mamba-2 SSD layers, chunk 16), both at their smoke
sizes.

* ``LM.prefill`` and ``decode_step`` logits, and the decode cache, match
  the reference's; the port's seeded init and the bridge keep the
  reference's leaves, shapes and dtypes at bf16 (the recurrent states
  ``h`` and ``ssm`` stay f32).
* The engine's greedy streams are token-identical to the reference
  engine's, with prompts that are not a bucket length (a hybrid prompt of
  29 tokens passes the window of 16, so its ring takes only the last 16
  positions and routes the bucket's padding to the discard row);
  ``paged=True`` keeps the dense layout for these families.
* Park/resume and hibernate/resume continue exactly as the reference does;
  a session freed mid-stream leaves the others' streams unchanged; a
  session moves reference -> port -> reference mid-stream through the
  reference's own ``state_transfer.transfer`` with its fingerprint check.

Tolerances: 1e-4 for logits (f32; two frameworks, another summation order
in the scans), 1e-4 for cache leaves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import kvcache as JKV
from repro.models.transformer import LM as JaxLM
from repro.serving import state_transfer as jax_transfer
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import kvcache as KV
from repro_torch.models.transformer import LM
from repro_torch.serving import state_transfer
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.hibernation import HibernationStore
from tests._torch_pairs import configs, prompt, weights

ARCHS = ("recurrentgemma-2b", "mamba2-1.3b")
MAX_LEN = 96
TOL = dict(atol=1e-4, rtol=1e-4)
#: prompt lengths: none a bucket (16, 32, 64); 29 > the hybrid's window
LENS = {"a": 9, "b": 29, "c": 45}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg, tcfg = configs(request.param, smoke=True)
    jp, tp = weights(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def jax_engine(pair):
    """One reference engine per family, shared so that its jitted prefill
    and decode compile once; each test starts it with every slot free."""
    jcfg, _, jp, _ = pair
    return JaxEngine(jcfg, params=jp, slots=3, max_len=MAX_LEN,
                     hibernation=True)


def _fresh(eng):
    for sid in list(eng._slot_map):
        eng.release_slot(sid)
    return eng


def _port_engine(pair, **kw):
    _, tcfg, _, tp = pair
    return InferenceEngine(tcfg, params=tp, slots=3, max_len=MAX_LEN,
                           device="cpu", **kw)


def _admit(engine, vocab, names=("a", "b", "c")):
    return [engine.prefill_session(sid, prompt(LENS[sid], vocab,
                                                ord(sid)))["first_token"]
            for sid in names]


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


def _spec(tree):
    return [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in tree]


class TestModel:
    @pytest.mark.parametrize("n", [29, 64])
    def test_prefill_and_decode_match_reference(self, pair, n):
        """A right-padded 29-token prompt (bucket 64) and a full one: the
        prefill logits and cache, then 4 greedy decode steps."""
        jcfg, tcfg, jp, tp = pair
        padded = np.zeros((1, 64), np.int32)
        padded[0, :n] = prompt(n, tcfg.vocab_size, n)
        lj, cj = JaxLM(jcfg).prefill(jp, {"tokens": jnp.asarray(padded),
                                          "length": jnp.int32(n)}, MAX_LEN)
        lt, ct = LM(tcfg).prefill(tp, {"tokens": torch.from_numpy(padded),
                                       "length": n}, MAX_LEN)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        assert _spec(bridge.leaves(ct)) == _spec(jax.tree.leaves(cj))
        for a, b in zip(jax.tree.leaves(cj), bridge.leaves(ct)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
        tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
        for _ in range(4):
            lj, cj = JaxLM(jcfg).decode_step(jp, cj, jnp.asarray(tok))
            lt, ct = LM(tcfg).decode_step(tp, ct, torch.from_numpy(tok))
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
            tok = np.asarray(jnp.argmax(lj[:, 0], -1))[:, None].astype(
                np.int32)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_tree_matches_reference_in_bf16(self, arch):
        """The port's seeded init has the reference's leaves, shapes and
        dtypes at the working dtype (the hybrid's layers a tuple)."""
        spec = JaxLM(jax_smoke_config(arch)).param_specs()
        tp = LM(get_smoke_config(arch)).init(0, "cpu")
        assert _spec(bridge.leaves(tp)) == _spec(jax.tree.leaves(spec))
        assert isinstance(tp["layers"], tuple) == (arch == ARCHS[0])

    @pytest.mark.parametrize("arch", ARCHS)
    def test_cache_layout_matches_reference(self, arch):
        cfg = get_smoke_config(arch)
        jc = JKV.init_cache(jax_smoke_config(arch), 3, MAX_LEN)
        tc = KV.init_cache(cfg, 3, MAX_LEN)
        assert _spec(bridge.leaves(tc)) == _spec(jax.tree.leaves(jc))
        assert KV.cache_bytes(cfg, 3, MAX_LEN) == JKV.cache_bytes(
            jax_smoke_config(arch), 3, MAX_LEN)
        assert not KV.supports_paging(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_keeps_reference_dtypes_in_bf16(arch):
    """Reference bf16 params and caches, carried as numpy (bf16 widened to
    float32, as the bridge's own ``to_numpy`` does), come out with the
    reference's dtypes: bf16 matrices, f32 gates, Λ, A_log, D, dt bias and
    norm scales, and f32 recurrent states ``h`` and ``ssm``."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp = JaxLM(jcfg).init(jax.random.key(0))
    as_f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = bridge.params_to_torch(as_f32, tcfg, "cpu")
    assert _spec(bridge.leaves(tp)) == _spec(jax.tree.leaves(jp))
    for a, b in zip(jax.tree.leaves(jp), bridge.leaves(tp)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    jc = JKV.init_cache(jcfg, 2, MAX_LEN)
    payload = {"cache": jax.tree.map(lambda a: np.asarray(a, np.float32)
                                     if a.dtype != jnp.int32
                                     else np.asarray(a), jc),
               "position": 3, "last_token": 1}
    tc = bridge.payload_to_torch(payload, tcfg, "cpu")["cache"]
    assert _spec(bridge.leaves(tc)) == _spec(jax.tree.leaves(jc))
    states = [t for t in bridge.leaves(tc) if t.dtype == torch.float32]
    assert states and all(t.dim() in (2, 5) for t in states)   # h, ssm


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_streams_token_identical(pair, jax_engine, paged):
    """Three sessions of 9, 29 and 45 tokens; ``paged=True`` silently
    keeps the dense slot layout, as the reference does."""
    vocab = pair[1].vocab_size
    jeng, teng = _fresh(jax_engine), _port_engine(pair, paged=paged)
    assert teng.paged is False
    assert _admit(teng, vocab) == _admit(jeng, vocab)
    for _ in range(3):
        assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)


def test_export_payload_matches_reference(pair, jax_engine):
    """Keys, shapes and dtypes of a slot payload are the reference's; its
    size is ``cache_bytes`` of one slot."""
    vocab = pair[1].vocab_size
    jeng, teng = _fresh(jax_engine), _port_engine(pair)
    _admit(jeng, vocab, "b")
    _admit(teng, vocab, "b")
    jp, tp = jeng.export_slot("b"), teng.export_slot("b")
    assert _spec(bridge.leaves(tp["cache"])) == _spec(
        jax.tree.leaves(jp["cache"]))
    assert state_transfer.payload_bytes(tp) == KV.cache_bytes(
        pair[1], 1, MAX_LEN)
    assert (tp["position"], tp["last_token"]) == (jp["position"],
                                                   jp["last_token"])


def test_park_and_hibernate_resume_continue_exactly(pair, jax_engine):
    """A parked session rides the fused batch with its state frozen; a
    hibernated one leaves its slot and comes back bit for bit. Both
    continue as the reference's do under the same operations."""
    vocab = pair[1].vocab_size
    jeng = _fresh(jax_engine)
    teng = _port_engine(pair, hibernation=HibernationStore())
    assert _admit(teng, vocab) == _admit(jeng, vocab)
    for eng in (jeng, teng):
        eng.park_slot("a")
    for _ in range(2):
        assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)
    before = state_transfer.fingerprint(teng.export_slot("b"))
    for eng in (jeng, teng):
        eng.resume_session("a")
        assert eng.hibernate_slot("b") and eng.has_hibernated("b")
    assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)
    for eng in (jeng, teng):
        eng.resume_session("b")
    assert state_transfer.fingerprint(teng.export_slot("b")) == before
    for _ in range(2):
        assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)


def test_freed_session_leaves_the_others_unchanged(pair):
    """Freeing a session mid-stream changes no other stream: the batch
    gives ``a`` and ``c`` the tokens of an engine ``b`` never joined."""
    vocab = pair[1].vocab_size
    full, bare = _port_engine(pair), _port_engine(pair)
    _admit(full, vocab)
    _admit(bare, vocab, ("a", "c"))
    out = full.decode_round(steps=4)
    assert out.pop("b") and out == bare.decode_round(steps=4)
    full.release_slot("b")
    for _ in range(2):
        assert full.decode_round(steps=4) == bare.decode_round(steps=4)


def test_migration_both_ways_keeps_fingerprint(pair, jax_engine):
    """reference -> port -> reference mid-stream through the reference's
    own transfer (it checks the fingerprint on each hop); the stream then
    continues as a port engine that kept the session throughout."""
    vocab = pair[1].vocab_size
    jeng = _fresh(jax_engine)
    teng, twin = _port_engine(pair), _port_engine(pair)
    _admit(jeng, vocab)
    _admit(twin, vocab)
    jeng.decode_round(steps=4)
    twin.decode_round(steps=4)
    before = jax_transfer.fingerprint(jeng.export_slot("b"))
    meta = jax_transfer.transfer(jeng, _Bridged(teng), "b")
    assert meta["fingerprint"] == before == state_transfer.fingerprint(
        teng.export_slot("b"))
    jeng.release_slot("b")
    assert teng.decode_round(steps=4)["b"] == twin.decode_round(steps=4)["b"]
    jax_transfer.transfer(_Bridged(teng), jeng, "b")
    assert jax_transfer.fingerprint(jeng.export_slot("b")) == \
        state_transfer.fingerprint(teng.export_slot("b"))
    assert jeng.decode_round(steps=4)["b"] == twin.decode_round(steps=4)["b"]

"""qwen2-vl-72b in the port (M-RoPE and the vision frontend stub) against
the reference package, on the CPU at its smoke config: 2 layers, d_model
64, 4 query / 2 KV heads of 16, M-RoPE sections (4, 2, 2), 8 vision
tokens.

* ``LM.init``'s tree has the reference's leaves, shapes and dtypes,
  ``vision_adapter`` included; it is drawn after every other leaf, so the
  other leaves are those of the same config without the frontend; the int8
  init is ``quantize_tree`` of the bf16 init bit for bit; the bridge
  carries the tree both ways.
* ``LM.prefill`` in f32 on the reference's weights: logits and K/V within
  1e-5 with and without ``vision_embeds``, at default positions (three
  equal streams [3, 1, s]), at explicit distinct [3, b, s] streams (an
  image's grid in streams 1-2), and at a stream 0 that repeats a position
  (every image token at t 0, as Qwen2-VL places one image), where the
  causal mask reads stream 0 of row 0.
* The default positions are three streams, never a 1-D ``arange``: a 1-D
  one reaches ``apply_mrope`` unbroadcast and rotates by the wrong angles
  (the guard shows both).
* 16 greedy ``decode_step``s after a vision prefill give the reference's
  tokens; text-only engines (dense and ``paged=True``) give the reference
  engine's streams; a session moved from a reference engine by the
  reference's ``state_transfer.transfer`` keeps its fingerprint and
  continues token for token.
* bf16 prefill and decode logits within 0.1 absolute.
* ``apply_mrope``'s section slices give the bits of the gather they
  replaced; a frontend or M-RoPE on a family no reference config pairs it
  with is refused.

Tolerances: 1e-5 for f32 logits and K/V (the same arithmetic in two
frameworks, summed in another order); bf16 logits within 0.1 absolute, as
the encdec family's (every matmul output and residual rounded to 8
mantissa bits, in another order in each framework).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import quant as JQ
from repro.models.transformer import LM as JaxLM
from repro.serving import state_transfer as jax_transfer
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import quant as Q
from repro_torch.models.transformer import LM
from repro_torch.serving import state_transfer
from repro_torch.serving.engine import InferenceEngine
from tests._torch_pairs import Bridged, configs, fresh, prompt, weights

ARCH = "qwen2-vl-72b"
MAX_LEN = 64
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ATOL = 0.1
S = 24                   # prompt tokens: 8 vision slots, then 16 text


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs(ARCH, smoke=True)
    assert tcfg.mrope_sections == (4, 2, 2) and tcfg.frontend == "vision"
    assert tcfg.num_frontend_tokens == 8
    jp, tp = weights(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def jax_engine(pair):
    jcfg, _, jp, _ = pair
    return JaxEngine(jcfg, params=jp, slots=3, max_len=MAX_LEN)


def _spec(leaves):
    return [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in leaves]


def _embeds(cfg, b, seed=0):
    """The same patch embeddings for both packages: numpy, scaled like the
    frontend stub's."""
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.num_frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _streams(b, s, nv, width, repeat_t=False):
    """[3, b, s] int32 M-RoPE positions of an image of nv patches in rows
    of ``width`` at the start of each prompt: stream 0 ``arange`` (every
    image token at 0 with ``repeat_t``, the text after it from 1), streams
    1-2 the patch's row and column, then each stream continues from the
    last image position + 1. Row r adds r to streams 1-2, so rows differ."""
    i = np.arange(s)
    img = i < nv
    t = np.where(img, 0, i - nv + 1) if repeat_t else i
    h = np.where(img, i // width, i)
    w = np.where(img, i % width, i)
    out = np.stack([t, h, w])[:, None].repeat(b, 1)
    out[1:] += np.arange(b)[None, :, None]
    return out.astype(np.int32)


def _batches(tokens, embeds=None, positions=None):
    """(reference batch, port batch) of the same numpy inputs."""
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens)}
    for key, a in (("vision_embeds", embeds), ("positions", positions)):
        if a is not None:
            jb[key], tb[key] = jnp.asarray(a), torch.from_numpy(a)
    return jb, tb


def _prefill_both(pair, tokens, embeds=None, positions=None):
    jcfg, tcfg, jp, tp = pair
    jb, tb = _batches(tokens, embeds, positions)
    lj, cj = JaxLM(jcfg).prefill(jp, jb, MAX_LEN)
    with torch.no_grad():
        lt, ct = LM(tcfg).prefill(tp, tb, MAX_LEN)
    return (lj, cj), (lt, ct)


def _assert_cache_close(cj, ct):
    jl, tl = jax.tree.leaves(cj), bridge.leaves(ct)
    assert _spec(tl) == _spec(jl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


# -- weights ------------------------------------------------------------------

def test_init_tree_matches_reference_in_bf16():
    """Leaves, shapes and dtypes of the port's seeded init are the
    reference's, ``vision_adapter`` [d, d] bf16 among them."""
    spec = JaxLM(jax_smoke_config(ARCH)).param_specs()
    tp = LM(get_smoke_config(ARCH)).init(0, "cpu")
    assert _spec(bridge.leaves(tp)) == _spec(jax.tree.leaves(spec))
    d = get_smoke_config(ARCH).d_model
    assert tuple(tp["vision_adapter"].shape) == (d, d)
    assert tp["vision_adapter"].dtype == torch.bfloat16


def test_vision_adapter_is_drawn_after_every_other_leaf():
    """The same seed without the frontend draws every other leaf bit for
    bit: adding ``vision_adapter`` moves no other model's weights."""
    cfg = get_smoke_config(ARCH)
    with_v = LM(cfg).init(4, "cpu")
    without = LM(dataclasses.replace(cfg, frontend="")).init(4, "cpu")
    assert "vision_adapter" not in without
    rest = {k: v for k, v in with_v.items() if k != "vision_adapter"}
    a, b = bridge.leaves(rest), bridge.leaves(without)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_int8_init_is_quantize_tree_of_the_bf16_init():
    """Quantised as drawn, bit for bit ``quantize_tree`` of the bf16 init,
    and the reference's ``quantize_tree`` quantises the same leaves
    (``vision_adapter`` too: ``EXCLUDE`` does not name it)."""
    cfg = get_smoke_config(ARCH)
    want = Q.quantize_tree(LM(cfg).init(3, "cpu"))
    got = LM(dataclasses.replace(cfg, serve_weight_dtype="int8")).init(
        3, "cpu")
    assert bridge.tree_map(lambda t: (tuple(t.shape), t.dtype), got) == \
        bridge.tree_map(lambda t: (tuple(t.shape), t.dtype), want)
    for a, b in zip(bridge.leaves(want), bridge.leaves(got)):
        assert torch.equal(a, b)
    assert Q.is_quantized(got["vision_adapter"])
    ref = JQ.quantize_tree(JaxLM(jax_smoke_config(ARCH)).init(
        jax.random.key(3)))
    assert set(ref["vision_adapter"]) == {"q", "s"}
    assert _spec(bridge.leaves(got)) == _spec(jax.tree.leaves(ref))


@pytest.mark.parametrize("quantized", [False, True])
def test_bridge_round_trips_the_tree(quantized):
    """Reference tree -> port -> numpy -> port: every leaf keeps the
    reference's dtype and value (bf16 matrices, f32 scales, int8 values)."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = JaxLM(jcfg).init(jax.random.key(2))
    if quantized:
        jp = JQ.quantize_tree(jp)
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert _spec(bridge.leaves(tp)) == _spec(jax.tree.leaves(jp))
    for a, b in zip(jax.tree.leaves(jp), bridge.leaves(tp)):
        np.testing.assert_array_equal(bridge.to_numpy(b),
                                      np.asarray(a, np.float32)
                                      if b.is_floating_point()
                                      else np.asarray(a))
    back = bridge.params_to_torch(bridge.tree_to_numpy(tp), tcfg, "cpu")
    for a, b in zip(bridge.leaves(tp), bridge.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- prefill and decode, f32 --------------------------------------------------

@pytest.mark.parametrize("case", ["text", "vision", "vision_streams",
                                  "repeated_t"])
def test_prefill_matches_reference(pair, case):
    """Logits and K/V within 1e-5: text only or with the image, at
    default positions, distinct explicit streams, or a stream 0 that
    repeats a position (the mask's positions)."""
    tcfg = pair[1]
    b, nv = 2, tcfg.num_frontend_tokens
    tokens = np.stack([prompt(S, tcfg.vocab_size, 10 + r) for r in range(b)])
    embeds = None if case == "text" else _embeds(tcfg, b)
    positions = None
    if case in ("vision_streams", "repeated_t"):
        positions = _streams(b, S, nv, 4, repeat_t=case == "repeated_t")
    (lj, cj), (lt, ct) = _prefill_both(pair, tokens, embeds, positions)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_cache_close(cj, ct)
    if embeds is not None:       # the image changed what the text sees
        (lj0, _), _ = _prefill_both(pair, tokens, None, positions)
        assert np.abs(np.asarray(lj0) - np.asarray(lj)).max() > 1e-3


def test_default_positions_are_three_streams_not_a_1d_arange(pair):
    """The guard for M-RoPE's default positions at s >= 3: the port's
    default prefill is the reference's, and its positions are [3, 1, s];
    the same prompt given a 1-D ``arange`` (what ``rope_for`` would see if
    ``prefill`` built one) rotates by other angles and misses the
    reference."""
    tcfg = pair[1]
    tokens = prompt(S, tcfg.vocab_size, 5)[None]
    (lj, cj), (lt, ct) = _prefill_both(pair, tokens)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_cache_close(cj, ct)
    pos = LM(tcfg)._positions({}, S, "cpu")
    assert tuple(pos.shape) == (3, 1, S)
    assert all(torch.equal(pos[i, 0], torch.arange(S, dtype=torch.int32))
               for i in range(3))
    flat = {"tokens": torch.from_numpy(tokens),
            "positions": torch.arange(S, dtype=torch.int32)}
    with torch.no_grad():
        lf, _ = LM(tcfg).prefill(pair[3], flat, MAX_LEN)
    assert np.abs(lf.numpy() - np.asarray(lj)).max() > 1e-3


@settings(max_examples=4, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16), width=st.sampled_from([1, 2, 4, 8]),
       repeat_t=st.booleans())
def test_prefill_matches_reference_property(pair, seed, width, repeat_t):
    """Any image grid width and prompt, with and without a repeated
    stream 0: logits within 1e-5 of the reference's."""
    tcfg = pair[1]
    tokens = prompt(S, tcfg.vocab_size, seed)[None]
    positions = _streams(1, S, tcfg.num_frontend_tokens, width, repeat_t)
    (lj, _), (lt, _) = _prefill_both(pair, tokens, _embeds(tcfg, 1, seed),
                                     positions)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_greedy_decode_after_vision_prefill(pair):
    """16 greedy steps after a prefill with the image and explicit
    streams: the same tokens, logits and K/V within 1e-5."""
    jcfg, tcfg, jp, tp = pair
    tokens = prompt(S, tcfg.vocab_size, 7)[None]
    positions = _streams(1, S, tcfg.num_frontend_tokens, 4)
    (lj, cj), (lt, ct) = _prefill_both(pair, tokens, _embeds(tcfg, 1, 3),
                                       positions)
    tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    seen = []
    for _ in range(16):
        lj, cj = JaxLM(jcfg).decode_step(jp, cj, jnp.asarray(tok))
        with torch.no_grad():
            lt, ct = LM(tcfg).decode_step(tp, ct, torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tok = np.asarray(jnp.argmax(lj[:, 0], -1))[:, None].astype(np.int32)
        assert int(lt[0, 0].argmax()) == int(tok[0, 0])
        seen.append(int(tok[0, 0]))
    _assert_cache_close(cj, ct)
    assert int(ct["pos"][0]) == S + 16 and len(set(seen)) > 1


# -- engines ------------------------------------------------------------------

def _admit(engine, vocab):
    return [engine.prefill_session(sid, prompt(n, vocab, n))["first_token"]
            for sid, n in (("a", 9), ("b", 20), ("c", 33))]


@pytest.mark.parametrize("paged", [False, True])
def test_engine_streams_token_identical(pair, jax_engine, paged):
    """Text-only sessions (the reference's engine builds no vision batch)
    through dense and paged engines: the reference engine's streams."""
    _, tcfg, _, tp = pair
    teng = InferenceEngine(tcfg, params=tp, slots=3, max_len=MAX_LEN,
                           paged=paged, device="cpu")
    assert teng.paged is paged
    jeng = fresh(jax_engine)
    assert _admit(teng, tcfg.vocab_size) == _admit(jeng, tcfg.vocab_size)
    for _ in range(3):
        assert teng.decode_round(steps=4) == jeng.decode_round(steps=4)


def test_session_moves_from_the_reference_mid_stream(pair, jax_engine):
    """reference -> port through the reference's own transfer: the
    fingerprint holds on the hop and the port engine continues the
    session token for token."""
    _, tcfg, _, tp = pair
    jeng = fresh(jax_engine)
    teng = InferenceEngine(tcfg, params=tp, slots=3, max_len=MAX_LEN,
                           device="cpu")
    _admit(jeng, tcfg.vocab_size)
    jeng.decode_round(steps=5)
    for sid in ("a", "c"):
        before = jax_transfer.fingerprint(jeng.export_slot(sid))
        meta = jax_transfer.transfer(jeng, Bridged(teng), sid)
        assert meta["fingerprint"] == before == state_transfer.fingerprint(
            teng.export_slot(sid))
    for _ in range(3):
        got, want = teng.decode_round(steps=4), jeng.decode_round(steps=4)
        assert got == {sid: want[sid] for sid in ("a", "c")}


# -- bf16 and the full config -------------------------------------------------

def test_bf16_stays_within_tolerance():
    """bf16 weights (the reference's init, bridged), the image and
    explicit streams: prefill and two decode steps within 0.1."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = JaxLM(jcfg).init(jax.random.key(1))
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tokens = prompt(S, tcfg.vocab_size, 2)[None]
    jb, tb = _batches(tokens, _embeds(tcfg, 1, 8),
                      _streams(1, S, tcfg.num_frontend_tokens, 4))
    jl, jc = JaxLM(jcfg).prefill(jp, jb, MAX_LEN)
    with torch.no_grad():
        tl, tc = LM(tcfg).prefill(tp, tb, MAX_LEN)
    assert tc["layers"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=BF16_ATOL)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for _ in range(2):
        jl, jc = JaxLM(jcfg).decode_step(jp, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl, tc = LM(tcfg).decode_step(tp, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl),
                                   atol=BF16_ATOL)
        tok = np.argmax(np.asarray(jl[:, 0]), -1)[:, None].astype(np.int32)


def test_mrope_slices_are_the_gather_bit_for_bit():
    """``apply_mrope`` builds its angles section by section; gathering
    each half-dim's stream (the reference's formula, and the port's
    before it) gives the same bits."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 32)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 5000, (3, 2, 5)).astype(np.int32))
    sections = (8, 4, 4)
    sec_ids = torch.repeat_interleave(torch.arange(3), torch.tensor(sections))
    angles = torch.movedim(pos.float()[sec_ids], 0, -1) \
        * L.rope_frequencies(32, 1e6)
    assert torch.equal(L.apply_mrope(x, pos, 1e6, sections),
                       L._rotate(x, angles))


@pytest.mark.parametrize("arch,change", [
    ("edge-tiny", dict(frontend="audio")),
    ("seamless-m4t-medium", dict(frontend="vision")),
    ("seamless-m4t-medium", dict(mrope_sections=(4, 2, 2))),
    ("mixtral-8x7b", dict(frontend="vision")),
    ("recurrentgemma-2b", dict(mrope_sections=(4, 2, 2))),
    ("mamba2-1.3b", dict(frontend="vision"))])
def test_unpaired_frontends_are_refused(arch, change):
    """A frontend or M-RoPE on a family no reference config pairs it with
    raises, naming the ROADMAP."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LM(dataclasses.replace(get_smoke_config(arch), **change))


def test_full_config_constructs():
    """The served config: 80 dense layers, M-RoPE (16, 24, 24) over head
    dim 128, 256 vision tokens."""
    cfg = get_config(ARCH)
    lm = LM(cfg)
    assert lm.cfg.family == "dense" and lm.cfg.frontend == "vision"
    assert (cfg.num_layers, cfg.d_model, cfg.head_dim) == (80, 8192, 128)
    assert cfg.mrope_sections == (16, 24, 24)
    assert cfg.num_frontend_tokens == 256

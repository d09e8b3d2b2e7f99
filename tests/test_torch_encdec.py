"""The port's encoder-decoder family (seamless-m4t-medium, audio frontend
stub) against the reference package's, on the CPU with bridged weights at
the smoke size (2 encoder + 2 decoder layers, source_len 24, head_dim 16).

* ``LM.prefill`` with ``frames`` gives the reference's logits and decode
  cache (self K/V, cross K/V); a right-padded prompt with its ``length``
  gives the exact-length cache where it is read; cross K/V follow the
  frames' length, not ``cfg.source_len``, as in the reference.
* Greedy ``decode_step`` streams are token-identical to the reference's,
  and decode leaves the cross K/V bit-unchanged.
* Caches, the seeded init and the bridge keep the reference's leaves,
  shapes and dtypes; the frontend stubs make batches of the reference's
  shapes.
* A prefill calls the flash-attention wrapper once per encoder layer,
  once per decoder self attention and once per cross attention.

Tolerances: 1e-4 for f32 logits after the 4-layer stack, 1e-5 for f32
cache leaves (two frameworks, another summation order); bf16 logits within
0.1 absolute (logits of order 3, seen up to 0.05 apart over three seeds:
every matmul output and each layer's residual is rounded to 8 mantissa
bits, in another order in each framework).
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
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import frontends as FE
from repro_torch.models import kvcache as KV
from repro_torch.models.transformer import LM
from tests._torch_pairs import configs, prompt, weights

ARCH = "seamless-m4t-medium"
MAX_LEN = 64
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs(ARCH, smoke=True)
    jp, tp = weights(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _frames(cfg, b, src=None, seed=0):
    """The same frame embeddings for both packages (their generators
    differ): numpy, scaled like the frontend stub's."""
    src = src or cfg.source_len
    return (np.random.default_rng(seed).standard_normal(
        (b, src, cfg.d_model)) * 0.02).astype(np.float32)


def _prefill_both(pair, tokens, frames, length=None):
    jcfg, tcfg, jp, tp = pair
    jb = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(tokens),
          "frames": torch.from_numpy(frames)}
    if length is not None:
        jb["length"], tb["length"] = jnp.int32(length), length
    jl, jc = JaxLM(jcfg).prefill(jp, jb, MAX_LEN)
    tl, tc = LM(tcfg).prefill(tp, tb, MAX_LEN)
    return (np.asarray(jl), jc), (tl.numpy(), tc)


def _spec(tree):
    return [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in tree]


class TestPrefill:
    def test_logits_and_cache_match_reference(self, pair):
        _, tcfg, _, _ = pair
        s = 20
        tokens = np.stack([prompt(s, tcfg.vocab_size, i) for i in (1, 2)])
        (jl, jc), (tl, tc) = _prefill_both(pair, tokens, _frames(tcfg, 2))
        np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tc["layers"][key].numpy()[:, :, :s],
                np.asarray(jc["layers"][key])[:, :, :s], **CACHE_TOL)
        for key in ("cross_k", "cross_v"):
            assert tc[key].shape == jc[key].shape
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **CACHE_TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))

    def test_right_padded_prompt_gives_the_exact_length_cache(self, pair):
        """A 13-token prompt right-padded to the 32 bucket with ``length``
        13: the logits and every cache row decode reads equal the
        exact-length prefill's, and match the reference's padded
        prefill."""
        _, tcfg, _, tp = pair
        n, bucket = 13, 32
        toks = prompt(n, tcfg.vocab_size, 7)[None]
        padded = np.zeros((1, bucket), np.int32)
        padded[:, :n] = toks
        frames = _frames(tcfg, 1, seed=3)
        (jl, jc), (tl, tc) = _prefill_both(pair, padded, frames, length=n)
        el, ec = LM(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks),
                                       "frames": torch.from_numpy(frames)},
                                  MAX_LEN)
        np.testing.assert_allclose(tl, el.numpy(), **LOGIT_TOL)
        np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
        assert int(tc["pos"][0]) == int(ec["pos"][0]) == n
        for key in ("k", "v"):
            np.testing.assert_allclose(tc["layers"][key].numpy()[:, :, :n],
                                       ec["layers"][key].numpy()[:, :, :n],
                                       **CACHE_TOL)
        for key in ("cross_k", "cross_v"):
            np.testing.assert_allclose(tc[key].numpy(), ec[key].numpy(),
                                       **CACHE_TOL)

    def test_cross_kv_follow_the_frames_length(self, pair):
        """Frames of 17 rows (source_len is 24): cross K/V of 17 rows in
        both packages, and the same logits."""
        _, tcfg, _, _ = pair
        tokens = prompt(11, tcfg.vocab_size, 4)[None]
        (jl, jc), (tl, tc) = _prefill_both(pair, tokens,
                                           _frames(tcfg, 1, src=17))
        assert tc["cross_k"].shape[2] == jc["cross_k"].shape[2] == 17
        np.testing.assert_allclose(tl, jl, **LOGIT_TOL)

    def test_prefill_calls_the_flash_wrapper_for_all_three_attentions(
            self, pair, monkeypatch):
        """2 encoder self attentions, 2 causal decoder self attentions and
        2 cross attentions at the smoke size: 6 calls, all of them through
        the wrapper (36 at seamless-m4t-medium's 12 + 12 layers)."""
        _, tcfg, _, tp = pair
        seen = []

        def spy(*args, causal, **kw):
            seen.append(causal)
            return A.blocked_attention(*args, causal=causal, window=0, **kw)
        monkeypatch.setattr(A, "flash_attention", spy)
        LM(tcfg).prefill(tp, {"tokens": torch.from_numpy(
            prompt(9, tcfg.vocab_size)[None]), "frames": torch.from_numpy(
                _frames(tcfg, 1))}, MAX_LEN)
        assert sorted(seen) == [False] * 4 + [True] * 2


class TestDecode:
    def test_greedy_streams_token_identical(self, pair):
        """A batch of two 18-token prompts with their own frames, 16 greedy
        steps, each side feeding back its own argmax: the same tokens as
        the reference, logits within tolerance at every step."""
        jcfg, tcfg, jp, tp = pair
        tokens = np.stack([prompt(18, tcfg.vocab_size, i) for i in (5, 6)])
        (jl, jc), (tl, tc) = _prefill_both(pair, tokens, _frames(tcfg, 2))
        jt = np.argmax(jl, -1)[:, None].astype(np.int32)
        tt = torch.from_numpy(np.argmax(tl, -1)[:, None].astype(np.int32))
        jlm, tlm = JaxLM(jcfg), LM(tcfg)
        streams = ([], [])
        for _ in range(16):
            jl, jc = jlm.decode_step(jp, jc, jnp.asarray(jt))
            tl, tc = tlm.decode_step(tp, tc, tt)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
            jt = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(
                np.int32)
            tt = tl[:, 0].argmax(-1)[:, None].to(torch.int32)
            streams[0].append(jt[:, 0].tolist())
            streams[1].append(tt[:, 0].tolist())
        assert streams[0] == streams[1]
        assert len({tuple(s) for s in streams[0]}) > 1   # not one token

    def test_decode_leaves_cross_kv_bit_unchanged(self, pair):
        _, tcfg, _, tp = pair
        lm = LM(tcfg)
        _, cache = lm.prefill(tp, {"tokens": torch.from_numpy(
            prompt(10, tcfg.vocab_size, 9)[None]), "frames": torch.from_numpy(
                _frames(tcfg, 1))}, MAX_LEN)
        before = {k: cache[k].clone() for k in ("cross_k", "cross_v")}
        tok = torch.zeros((1, 1), dtype=torch.int32)
        for _ in range(3):
            _, cache = lm.decode_step(tp, cache, tok)
        for key, t in before.items():
            assert torch.equal(cache[key], t)
        assert int(cache["pos"][0]) == 13

    def test_bf16_stays_within_tolerance(self):
        """bf16 weights (the reference's init, bridged) and frames: prefill
        and two decode steps within the stated bf16 tolerance."""
        jcfg = jax_smoke_config(ARCH)
        tcfg = get_smoke_config(ARCH)
        jp = JaxLM(jcfg).init(jax.random.key(1))
        tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), tcfg,
                                    "cpu")
        tokens = prompt(16, tcfg.vocab_size, 2)[None]
        frames = _frames(tcfg, 1, seed=8)
        jl, jc = JaxLM(jcfg).prefill(jp, {"tokens": jnp.asarray(tokens),
                                          "frames": jnp.asarray(frames)},
                                     MAX_LEN)
        tl, tc = LM(tcfg).prefill(tp, {"tokens": torch.from_numpy(tokens),
                                       "frames": torch.from_numpy(frames)},
                                  MAX_LEN)
        assert tc["cross_k"].dtype == torch.bfloat16
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.1)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        for _ in range(2):
            jl, jc = JaxLM(jcfg).decode_step(jp, jc, jnp.asarray(tok))
            tl, tc = LM(tcfg).decode_step(tp, tc, torch.from_numpy(tok))
            np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl),
                                       atol=0.1)
            tok = np.argmax(np.asarray(jl[:, 0]), -1)[:, None].astype(
                np.int32)


class TestLayouts:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_init_cache_and_cache_bytes_match_reference(self, dtype):
        jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype)
        tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
        for batch, max_len in ((1, 64), (3, 96)):
            jc = JKV.init_cache(jcfg, batch, max_len)
            tc = KV.init_cache(tcfg, batch, max_len, device="cpu")
            assert _spec(bridge.leaves(tc)) == _spec(jax.tree.leaves(jc))
            assert KV.cache_bytes(tcfg, batch, max_len) == \
                JKV.cache_bytes(jcfg, batch, max_len)
        assert not KV.supports_paging(tcfg)

    def test_init_tree_matches_reference_in_bf16(self):
        """The port's seeded init: the reference's leaves, shapes and dtypes
        (enc_layers, layers with norm_x and xattn, enc_norm, adapter)."""
        spec = JaxLM(jax_smoke_config(ARCH)).param_specs()
        tp = LM(get_smoke_config(ARCH)).init(0, "cpu")
        assert _spec(bridge.leaves(tp)) == _spec(jax.tree.leaves(spec))
        assert {"enc_layers", "enc_norm", "adapter"} <= set(tp)
        assert {"norm_x", "xattn"} <= set(tp["layers"])

    def test_bridge_keeps_reference_dtypes_in_bf16(self):
        """Reference bf16 params and a cache with cross K/V, carried as
        float32 numpy: bf16 matrices (adapter, xattn, enc_layers), f32 norm
        scales; cross_k/cross_v at the top level in bf16; values exact."""
        jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
        jp = JaxLM(jcfg).init(jax.random.key(0))
        as_f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        tp = bridge.params_to_torch(as_f32, tcfg, "cpu")
        assert _spec(bridge.leaves(tp)) == _spec(jax.tree.leaves(jp))
        for a, b in zip(jax.tree.leaves(jp), bridge.leaves(tp)):
            np.testing.assert_array_equal(b.float().numpy(),
                                          np.asarray(a, np.float32))
        assert tp["adapter"].dtype == torch.bfloat16
        assert tp["enc_norm"]["scale"].dtype == torch.float32
        jc = JKV.init_cache(jcfg, 2, MAX_LEN)
        payload = {"cache": jax.tree.map(
            lambda a: np.asarray(a, np.float32) if a.dtype != jnp.int32
            else np.asarray(a), jc), "position": 3, "last_token": 1}
        tc = bridge.payload_to_torch(payload, tcfg, "cpu")["cache"]
        assert _spec(bridge.leaves(tc)) == _spec(jax.tree.leaves(jc))
        assert tc["cross_k"].dtype == tc["cross_v"].dtype == torch.bfloat16


class TestFrontends:
    def test_stubs_make_the_reference_shapes(self):
        """Audio frames [b, source_len, d] at scale 0.02 (or a given
        length), vision embeddings [b, num_frontend_tokens, d], and
        batches with the reference's keys, shapes and dtypes; the same
        seed gives the same draws."""
        from repro.models import frontends as JFE
        audio = get_smoke_config(ARCH)
        vision = get_smoke_config("qwen2-vl-72b")

        def gen(seed=0):
            return torch.Generator(device="cpu").manual_seed(seed)
        frames = FE.fake_audio_frames(audio, gen(), 2)
        assert frames.shape == (2, audio.source_len, audio.d_model)
        assert 0.01 < float(frames.std()) < 0.03
        assert FE.fake_audio_frames(audio, gen(), 1, 5).shape[1] == 5
        assert torch.equal(FE.fake_audio_frames(audio, gen(3), 2),
                           FE.fake_audio_frames(audio, gen(3), 2))
        assert FE.fake_vision_embeds(vision, gen(), 3).shape == (
            3, vision.num_frontend_tokens, vision.d_model)
        for cfg, arch in ((audio, ARCH), (vision, "qwen2-vl-72b")):
            tb = FE.make_batch(cfg, gen(), 2, 12)
            jb = JFE.make_batch(jax_smoke_config(arch), jax.random.key(0),
                                2, 12)
            assert sorted(tb) == sorted(jb)
            assert _spec(bridge.leaves(tb)) == _spec(jax.tree.leaves(jb))
            assert torch.equal(tb["labels"][:, :-1], tb["tokens"][:, 1:]) \
                or cfg.frontend == "vision"
        nv = vision.num_frontend_tokens
        assert bool((FE.make_batch(vision, gen(), 1, 12)["labels"][:, :nv]
                     == -1).all())

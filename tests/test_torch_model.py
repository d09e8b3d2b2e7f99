"""The port's model layers, cache layouts and dense LM against the reference
package on the same numpy inputs and bridged weights (float32).

Tolerances: 1e-6 for elementwise layers; 1e-5 where a matmul or a
transcendental (RoPE's cos/sin, softmax) enters, since the two frameworks
sum and round in different orders; 1e-4 for logits after a 4-layer stack.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import kvcache as JKV
from repro.models import layers as JL
from repro.models import quant as JQ
from repro.models.transformer import LM as JaxLM
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import quant as Q
from repro_torch.models.transformer import LM, layer_params
from tests._torch_pairs import configs, prompt, weights


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def tiny():
    """edge-tiny in both packages with the same (bridged) weights."""
    jcfg, tcfg = configs()
    return (jcfg, tcfg) + weights(jcfg, tcfg)


class TestLayers:
    def test_rmsnorm(self):
        x, s = _rand((2, 5, 64), 0), _rand((64,), 1)
        ref = JL.rmsnorm_apply({"scale": jnp.asarray(s)}, jnp.asarray(x),
                               1e-6)
        out = L.rmsnorm_apply({"scale": _t(s)}, _t(x), 1e-6)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=1e-6, rtol=1e-6)

    @pytest.mark.parametrize("batched_positions", [False, True])
    def test_rope_half_split(self, batched_positions):
        x = _rand((2, 7, 4, 32), 2)
        pos = (np.random.default_rng(3).integers(0, 500, size=(2, 7))
               if batched_positions else np.arange(7)).astype(np.int32)
        ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
        out = L.apply_rope(_t(x), _t(pos), 10_000.0)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)

    def test_mrope_sections(self):
        x = _rand((2, 5, 3, 16), 4)
        pos = np.random.default_rng(5).integers(0, 64, size=(3, 2, 5)) \
            .astype(np.int32)
        ref = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (4, 2, 2))
        out = L.apply_mrope(_t(x), _t(pos), 1e6, (4, 2, 2))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)

    def test_swiglu(self):
        x = _rand((2, 3, 32), 6)
        p = {k: _rand(s, i) / 6 for i, (k, s) in enumerate(
            (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32))))}
        ref = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x))
        out = L.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)

    def test_softcap(self):
        x = _rand((4, 9), 7) * 80
        np.testing.assert_allclose(
            L.softcap(_t(x), 30.0).numpy(),
            np.asarray(JL.softcap(jnp.asarray(x), 30.0)), atol=1e-5)
        assert torch.equal(L.softcap(_t(x), 0.0), _t(x))

    def test_int8_dequant_on_read(self):
        """A weight quantised by the reference crosses the bridge as
        {q: int8, s: f32} and dequantises to the reference's bf16 values."""
        w = _rand((3, 64, 80), 8)
        jq = JQ.quantize_weight(jnp.asarray(w))
        tq = {k: _t(v) for k, v in jq.items()}
        assert Q.is_quantized(tq) and not Q.is_quantized(_t(w))
        ref = np.asarray(JQ.as_weight(jq).astype(jnp.float32))
        np.testing.assert_array_equal(Q.as_weight(tq).float().numpy(), ref)
        x = _rand((2, 64), 9)
        np.testing.assert_allclose(
            L.matmul(_t(x), tq).numpy(), x @ ref, atol=1e-4, rtol=1e-4)


class TestCacheLayouts:
    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_cache_bytes_match_every_config(self, arch):
        for jcfg, tcfg in ((jax_config(arch), get_config(arch)),
                           (jax_smoke_config(arch), get_smoke_config(arch))):
            for batch, max_len in ((1, 4096), (8, 2048), (3, 100)):
                assert KV.cache_bytes(tcfg, batch, max_len) == \
                    JKV.cache_bytes(jcfg, batch, max_len)
                assert KV.kv_buffer_len(tcfg, max_len) == \
                    JKV.kv_buffer_len(jcfg, max_len)
            assert KV.supports_paging(tcfg) == JKV.supports_paging(jcfg)
            if not JKV.supports_paging(jcfg):
                continue
            for max_len, page in ((2048, 128), (96, 128), (64, 16)):
                pl = KV.page_len(tcfg, max_len, page)
                assert pl == JKV.page_len(jcfg, max_len, page)
                pps = KV.pages_per_slot(max_len, pl)
                assert pps == JKV.pages_per_slot(max_len, pl)
                assert KV.page_bytes(tcfg, pl) == JKV.page_bytes(jcfg, pl)
                assert KV.paged_cache_bytes(tcfg, 8, max_len, 1 + 8 * pps,
                                            pl) == \
                    JKV.paged_cache_bytes(jcfg, 8, max_len, 1 + 8 * pps, pl)

    @pytest.mark.parametrize("paged", [False, True])
    def test_layout_trees_match(self, paged):
        """Same leaves in the same (sorted-key) order, shapes and dtypes."""
        jcfg, tcfg = configs()
        if paged:
            j = JKV.init_paged_cache(jcfg, 3, 96, 9, 32)
            t = KV.init_paged_cache(tcfg, 3, 96, 9, 32, device="cpu")
        else:
            j = JKV.init_cache(jcfg, 3, 96)
            t = KV.init_cache(tcfg, 3, 96, device="cpu")
        jl, tl = jax.tree.leaves(j), bridge.leaves(t)
        assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
        assert [str(a.dtype) for a in jl] == \
            [str(b.dtype).replace("torch.", "") for b in tl]


class TestBridge:
    def test_param_leaves_walk_in_reference_order(self, tiny):
        _, _, jp, tp = tiny
        jl, tl = jax.tree.leaves(jp), bridge.leaves(tp)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())

    @pytest.mark.parametrize("arch,quantized", [
        ("minitron-8b", False), ("qwen3-moe-30b-a3b", False),
        ("qwen3-moe-30b-a3b", True)])
    def test_params_keep_the_reference_dtypes_in_bf16(self, arch, quantized):
        """At a bf16 config every port leaf has the reference leaf's shape
        and dtype: bf16 matrices, f32 norm scales, the f32 MoE router, and
        (int8-quantised trees) int8 values with f32 scales."""
        jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
        assert jcfg.dtype == tcfg.dtype == "bfloat16"
        jp = JaxLM(jcfg).init(jax.random.key(0))
        if quantized:
            jp = JQ.quantize_tree(jp, min_size=1)
        tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        jl, tl = jax.tree.leaves(jp), bridge.leaves(tp)
        assert [(tuple(a.shape), str(a.dtype)) for a in jl] == \
            [(tuple(b.shape), str(b.dtype).replace("torch.", ""))
             for b in tl]
        if arch.startswith("qwen3"):
            router = tp["layers"]["moe"]["router"]
            assert router.dtype == torch.float32
            np.testing.assert_array_equal(
                router.numpy(), np.asarray(jp["layers"]["moe"]["router"]))

    @pytest.mark.parametrize("arch", ["minitron-8b", "qwen3-moe-30b-a3b"])
    def test_params_round_trip_through_float32_numpy_in_bf16(self, arch):
        """bf16 crosses the bridge as float32 numpy (``to_numpy``), so a
        port tree sent out and back keeps every leaf's dtype and value: the
        dtype follows the leaf's key, not the dtype it arrives in."""
        jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
        jp = JaxLM(jcfg).init(jax.random.key(1))
        tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        back = bridge.params_to_torch(bridge.tree_to_numpy(tp), tcfg, "cpu")
        assert all(a.dtype == np.float32
                   for a in bridge.leaves(bridge.tree_to_numpy(tp)))
        for a, b in zip(bridge.leaves(tp), bridge.leaves(back)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert any(a.dtype == torch.bfloat16 for a in bridge.leaves(back))

    def test_bf16_crosses_as_exact_float32(self):
        """A reference bf16 array (numpy cannot compute in its dtype) lands
        in the port exactly, and bf16 port tensors leave as float32."""
        x = jnp.asarray(_rand((4, 8), 10)).astype(jnp.bfloat16)
        t = bridge.to_torch(np.asarray(x), dtype=torch.bfloat16)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(bridge.to_numpy(t),
                                      np.asarray(x.astype(jnp.float32)))


class TestAttention:
    @pytest.mark.parametrize("sq,block_q,block_kv", [(37, 16, 32),
                                                     (64, 64, 128)])
    def test_blocked_prefill_attention(self, sq, block_q, block_kv):
        q, k, v = (_rand((2, sq, 4, 16), s) for s in (11, 12, 13))
        pos = np.arange(sq, dtype=np.int32)
        kw = dict(causal=True, window=0, block_q=block_q, block_kv=block_kv)
        ref = JA.blocked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   jnp.asarray(pos), jnp.asarray(pos), **kw)
        out = A.blocked_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                  **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)

    def test_window_and_cross_attention_are_not_ported_yet(self):
        """Softcapped logits on the linear-buffer decode kernels still
        raise, naming the ROADMAP. Sliding-window decode and cross attention
        are ported since: held against the reference in
        test_torch_recurrent.py and test_torch_encdec.py; here cross
        attention only runs."""
        _, tcfg = configs()
        x = torch.zeros((1, 1, tcfg.d_model))
        capped = dataclasses.replace(tcfg, attn_logits_softcap=30.0)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            A.decode_self_attention({}, capped, x, None, None,
                                    torch.zeros(1, dtype=torch.int32))
        _, params = weights(*configs())
        p = layer_params(params["layers"], 0)["attn"]
        mem = torch.ones((1, 5, tcfg.d_model))
        out = A.cross_attention(p, tcfg, x, mem,
                                torch.arange(5, dtype=torch.int32))
        assert out.shape == x.shape and bool(torch.isfinite(out).all())


class TestLM:
    @pytest.mark.parametrize("arch,smoke", [("edge-tiny", False),
                                            ("minitron-8b", True)])
    def test_prefill_logits_and_cache(self, tiny, arch, smoke):
        """Right-padded bucket with the true length, as the engine runs it:
        logits, the valid cache rows and pos match the reference."""
        if arch == "edge-tiny":
            jcfg, tcfg, jp, tp = tiny
        else:
            jcfg, tcfg = configs(arch, smoke)
            jp, tp = weights(jcfg, tcfg)
        n, width, max_len = 21, 32, 64
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = prompt(n, jcfg.vocab_size)
        jl, jc = JaxLM(jcfg).prefill(
            jp, {"tokens": jnp.asarray(toks), "length": jnp.int32(n)},
            max_len)
        with torch.no_grad():
            tl, tc = LM(tcfg).prefill(
                tp, {"tokens": torch.from_numpy(toks), "length": n}, max_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4)
        for key in ("k", "v"):
            assert tuple(tc["layers"][key].shape) == \
                tuple(jc["layers"][key].shape)
            np.testing.assert_allclose(
                tc["layers"][key][:, :, :n].numpy(),
                np.asarray(jc["layers"][key])[:, :, :n], atol=1e-5,
                rtol=1e-5)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))

    @pytest.mark.parametrize("paged", [False, True])
    def test_decode_steps_with_inactive_rows(self, tiny, paged):
        """Two rows from two prompts, row 1 inactive: logits match, and the
        inactive row's cache rows are left exactly as they were."""
        jcfg, tcfg, jp, tp = tiny
        max_len, page = 64, 16
        jlm, tlm = JaxLM(jcfg), LM(tcfg)
        toks = np.stack([prompt(20, jcfg.vocab_size, 1),
                         prompt(20, jcfg.vocab_size, 2)])
        _, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len)
        jc = jax.tree.map(np.asarray, jc)
        if paged:
            # rows laid out page by page at shuffled pool positions
            pps = max_len // page
            ids = 1 + np.random.default_rng(3).permutation(2 * pps)
            block = ids.reshape(2, pps).astype(np.int32)
            pool = {}
            for key in ("k", "v"):
                src = jc["layers"][key]              # [L, 2, S, kh, hd]
                p = np.zeros((src.shape[0], 1 + 2 * pps, page)
                             + src.shape[3:], np.float32)
                p[:, block.reshape(-1)] = src.reshape(
                    (src.shape[0], 2 * pps, page) + src.shape[3:])
                pool[key] = p
            jc = {"layers": pool, "block": block, "pos": jc["pos"]}
        tc = bridge.tree_to_torch(jc)
        jc = jax.tree.map(jnp.asarray, jc)
        jax_step = jax.jit(JaxLM(dataclasses.replace(
            jcfg, use_pallas_decode=True)).decode_step)
        active = np.array([True, False])
        frozen = {k: tc["layers"][k].clone() for k in ("k", "v")}
        tok = np.array([[5], [7]], np.int32)
        for step in range(3):
            jlog, jc = jax_step(jp, jc, jnp.asarray(tok),
                                active=jnp.asarray(active))
            with torch.no_grad():
                tlog, tc = tlm.decode_step(tp, tc, torch.from_numpy(tok),
                                           active=torch.from_numpy(active))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       atol=1e-4, rtol=1e-4)
            tok = np.asarray(jnp.argmax(jlog[:, 0], -1))[:, None].astype(
                np.int32)
        for key in ("k", "v"):
            got, ref = tc["layers"][key].numpy(), np.asarray(jc["layers"][key])
            if paged:     # the inactive row's pages; page 0 is scratch
                rows = block[1]
                np.testing.assert_array_equal(got[:, rows],
                                              frozen[key].numpy()[:, rows])
                np.testing.assert_allclose(got[:, 1:], ref[:, 1:],
                                           atol=1e-5, rtol=1e-5)
            else:
                np.testing.assert_array_equal(got[:, 1],
                                              frozen[key].numpy()[:, 1])
                np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b",
                                      "mixtral-8x7b", "seamless-m4t-medium",
                                      "qwen2-vl-72b"])
    def test_other_families_are_not_ported_yet(self, arch):
        """Every config the port once refused constructs now: the
        recurrent families, encdec, mixtral's windowed MoE and qwen2-vl's
        vision frontend with M-RoPE (a dense model; test_torch_recurrent.py,
        test_torch_encdec.py, test_torch_mixtral.py and test_torch_qwen2vl.py
        hold them to the reference)."""
        cfg = LM(get_smoke_config(arch)).cfg
        if arch == "qwen2-vl-72b":
            assert (cfg.family, cfg.frontend) == ("dense", "vision")
            assert cfg.mrope_sections
            return
        assert cfg.family in ("ssm", "hybrid", "encdec", "moe")

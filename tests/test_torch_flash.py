"""The port's ``flash_attention`` wrapper on the CPU (its plain version, the
port's blocked loop) against the reference package's Pallas
``flash_attention`` in interpret mode, its ``ref.attention_ref`` oracle and
its jnp ``blocked_attention``, on the same numpy inputs; and the model's
routing of whole-sequence attention through the wrapper.

Layouts: the port takes [b, s, h, d] with positions; the Pallas kernel and
its oracle take [B, H, S, D], so the tests transpose. Tolerances: 1e-5 in
f32 (the same function in f32, summed in another order); 0.035 in bf16, the
reference's own kernel tolerance (tests/test_kernels.py), since the
inputs and outputs carry 8 mantissa bits. Rows with no valid key are
garbage in the plain loop (uniform weights over masked keys) and zeros from
the CUDA kernel; the model never reads them, and the comparisons skip them.
The CUDA kernel itself is held to this plain version on the card by
chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as pallas_flash)
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import attention as JA
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.models import attention as A

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.035, rtol=0)


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def _inputs(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jnp(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _port(q, k, v, qpos, kpos, causal, dtype, block_q=64, block_kv=128):
    out = FA.flash_attention(_torch(q, dtype), _torch(k, dtype),
                             _torch(v, dtype), torch.from_numpy(qpos),
                             torch.from_numpy(kpos), causal=causal,
                             block_q=block_q, block_kv=block_kv)
    assert out.dtype == getattr(torch, dtype)
    return out.float().numpy()


def _to_bhsd(a):
    return np.moveaxis(np.asarray(a, dtype=np.float32), 1, 2)


def _valid_rows(qpos, kpos, causal):
    valid = np.broadcast_to(kpos[None, :] >= 0, (len(qpos), len(kpos)))
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    return valid.any(axis=1)


class TestPlainVersion:
    # the cases of tests/test_kernels.py::TestFlashAttention, plus head dim
    # 16 (the smoke configs' width)
    @pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,dtype", [
        (2, 4, 2, 256, 256, 64, True, "float32"),
        (1, 8, 8, 130, 130, 128, True, "bfloat16"),
        (2, 4, 1, 128, 384, 64, False, "float32"),     # cross-shaped
        (1, 2, 2, 64, 64, 128, True, "bfloat16"),
        (1, 16, 4, 257, 257, 64, True, "float32"),     # ragged block edge
        (2, 4, 2, 100, 100, 16, True, "float32"),
    ])
    def test_matches_pallas_and_ref(self, B, Hq, Hkv, Sq, Skv, D, causal,
                                    dtype):
        q, k, v = _inputs(Sq + D, B, Sq, Skv, Hq, Hkv, D)
        out = _port(q, k, v, np.arange(Sq, dtype=np.int32),
                    np.arange(Skv, dtype=np.int32), causal, dtype)
        j = [_jnp(np.moveaxis(a, 1, 2), dtype) for a in (q, k, v)]
        tol = _tol(dtype)
        np.testing.assert_allclose(
            out, _to_bhsd(pallas_flash(*j, causal=causal, interpret=True)),
            **tol)
        np.testing.assert_allclose(
            out, _to_bhsd(attention_ref(*j, causal=causal)), **tol)

    @pytest.mark.parametrize("D", [16, 64, 128])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_reference_blocked_attention_with_sentinels(
            self, D, causal, dtype):
        """Key positions with -1 sentinels (a padded tail and a hole),
        queries starting past 0, sq != skv: the reference's jnp
        ``blocked_attention`` with the same blocks."""
        sq, skv = 70, 150
        q, k, v = _inputs(D, 2, sq, skv, 4, 2, D)
        qpos = np.arange(sq, dtype=np.int32) + 40
        kpos = np.arange(skv, dtype=np.int32)
        kpos[30:50] = -1
        kpos[-9:] = -1
        out = _port(q, k, v, qpos, kpos, causal, dtype, 32, 64)
        ref = JA.blocked_attention(
            *(_jnp(a, dtype) for a in (q, k, v)), jnp.asarray(qpos),
            jnp.asarray(kpos), causal=causal, window=0, block_q=32,
            block_kv=64)
        rows = _valid_rows(qpos, kpos, causal)
        assert rows.all() or causal
        np.testing.assert_allclose(
            out[:, rows], np.asarray(ref, dtype=np.float32)[:, rows],
            **_tol(dtype))

    @settings(max_examples=4, deadline=None, database=None)
    @given(sq=st.integers(1, 140), skv=st.integers(1, 140),
           g=st.sampled_from([1, 2, 4]), D=st.sampled_from([16, 32, 64]),
           causal=st.booleans(), seed=st.integers(0, 2**16))
    def test_ragged_shapes_property(self, sq, skv, g, D, causal, seed):
        q, k, v = _inputs(seed, 1, sq, skv, 2 * g, 2, D)
        qpos = np.arange(sq, dtype=np.int32)
        kpos = np.arange(skv, dtype=np.int32)
        out = _port(q, k, v, qpos, kpos, causal, "float32", 16, 32)
        ref = JA.blocked_attention(
            *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(qpos),
            jnp.asarray(kpos), causal=causal, window=0, block_q=16,
            block_kv=32)
        rows = _valid_rows(qpos, kpos, causal)
        np.testing.assert_allclose(out[:, rows], np.asarray(ref)[:, rows],
                                   **F32_TOL)

    def test_causal_alignment_follows_positions(self):
        """At sq != skv the reference's kernel and oracle disagree: the
        Pallas kernel aligns the causal mask top-left (key index <= query
        index), ``attention_ref`` bottom-right (``tril(k=skv-sq)``). The
        port follows the positions it is given, so each alignment is one
        choice of query positions."""
        sq, skv = 48, 112
        q, k, v = _inputs(3, 1, sq, skv, 4, 2, 32)
        kpos = np.arange(skv, dtype=np.int32)
        j = [jnp.asarray(np.moveaxis(a, 1, 2)) for a in (q, k, v)]
        top_left = _port(q, k, v, np.arange(sq, dtype=np.int32), kpos, True,
                         "float32")
        bottom_right = _port(q, k, v, np.arange(sq, dtype=np.int32)
                             + (skv - sq), kpos, True, "float32")
        np.testing.assert_allclose(
            top_left, _to_bhsd(pallas_flash(*j, causal=True,
                                            interpret=True)), **F32_TOL)
        np.testing.assert_allclose(
            bottom_right, _to_bhsd(attention_ref(*j, causal=True)),
            **F32_TOL)
        assert np.abs(top_left - bottom_right).max() > 0.1


class TestWrapper:
    def test_cpu_tensors_take_the_plain_version_without_counting(self):
        """On CPU tensors the wrapper is the plain blocked loop, bit for
        bit, and counts no launch."""
        q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 37, 37, 4, 2,
                                                         16))
        pos = torch.arange(37, dtype=torch.int32)
        before = dict(FA.LAUNCHES)
        out = FA.flash_attention(q, k, v, pos, pos, causal=True, block_q=16,
                                 block_kv=32)
        assert torch.equal(out, FA.blocked_attention(
            q, k, v, pos, pos, causal=True, window=0, block_q=16,
            block_kv=32))
        assert FA.LAUNCHES == before

    @pytest.mark.parametrize("bad", ["device", "head_dim", "dtypes",
                                     "positions"])
    def test_other_devices_raise_instead_of_falling_back(self, bad):
        """A tensor that is not on the CPU never reaches the plain version:
        anything but valid CUDA tensors raises before a launch."""
        meta = dict(device="meta", dtype=torch.float32)
        d = 24 if bad == "head_dim" else 32
        q = torch.empty((1, 8, 4, d), **meta)
        k = torch.empty((1, 8, 2, d), device="meta",
                        dtype=torch.bfloat16 if bad == "dtypes"
                        else torch.float32)
        pos = torch.empty((8,), device="meta",
                          dtype=torch.int64 if bad == "positions"
                          else torch.int32)
        with pytest.raises(ValueError):
            FA.flash_attention(q, k, k, pos, pos, causal=True)

    def test_bf16_plain_version_is_close_to_f32(self):
        q, k, v = _inputs(5, 1, 96, 96, 8, 2, 64)
        pos = np.arange(96, dtype=np.int32)
        np.testing.assert_allclose(
            _port(q, k, v, pos, pos, True, "bfloat16"),
            _port(q, k, v, pos, pos, True, "float32"), atol=5e-2, rtol=5e-2)


class _Spy:
    """Counts the model's calls of the flash_attention wrapper."""

    def __init__(self, monkeypatch):
        self.calls = 0

        def spy(*args, **kw):
            self.calls += 1
            return FA.flash_attention(*args, **kw)
        monkeypatch.setattr(A, "flash_attention", spy)


class TestModelRouting:
    @pytest.mark.parametrize("window,softcap,causal,calls", [
        (0, 0.0, True, 1), (0, 0.0, False, 1), (16, 0.0, True, 0),
        (16, 0.0, False, 0), (0, 30.0, True, 0), (0, 30.0, False, 0)])
    def test_full_attention_calls_the_wrapper_without_window_and_softcap(
            self, monkeypatch, window, softcap, causal, calls):
        """``full_attention`` goes to the wrapper exactly when the config
        has no sliding window and no logit softcap, and then gives the
        plain blocked loop's result bit for bit."""
        spy = _Spy(monkeypatch)
        cfg = dataclasses.replace(get_config("edge-tiny"),
                                  dtype="float32", sliding_window=window,
                                  attn_logits_softcap=softcap)
        q, k, v = (torch.from_numpy(a) for a in _inputs(
            2, 2, 40, 40, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim))
        pos = torch.arange(40, dtype=torch.int32)
        out = A.full_attention(q, k, v, pos, pos, cfg, causal=causal)
        assert spy.calls == calls
        if calls:
            assert torch.equal(out, FA.blocked_attention(
                q, k, v, pos, pos, causal=causal, window=0,
                block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv))

    @pytest.mark.parametrize("arch,calls", [
        ("minitron-8b", 2), ("qwen3-moe-30b-a3b", 2),
        ("recurrentgemma-2b", 0), ("mamba2-1.3b", 0)])
    def test_prefill_launch_sites_per_family(self, monkeypatch, arch, calls):
        """One wrapper call per full-attention layer of a prefill (the
        smoke configs: 2 layers), none for the hybrid's windowed layers or
        the SSM."""
        from repro_torch.models.transformer import LM
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        lm = LM(cfg)
        params = lm.init(0, "cpu")
        spy = _Spy(monkeypatch)
        tokens = torch.arange(20, dtype=torch.int32)[None] % cfg.vocab_size
        lm.prefill(params, {"tokens": tokens}, 32)
        assert spy.calls == calls

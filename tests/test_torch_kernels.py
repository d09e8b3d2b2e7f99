"""The port's decode-attention wrappers on the CPU (their plain versions)
against the reference package's Pallas kernels in interpret mode and its
ref.py oracles, on the same numpy inputs.

Tolerance: 1e-5 absolute and relative in f32 — the three compute the same
masked softmax in f32 and differ only in summation order. The CUDA kernels
themselves are checked against these plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.decode_attention.decode_attention import (
    decode_attention as pallas_decode, paged_decode_attention as pallas_paged)
from repro.kernels.decode_attention.ref import (decode_attention_ref,
                                                paged_decode_attention_ref)
from repro_torch.kernels.decode_attention import decode_attention as DA

TOL = dict(atol=1e-5, rtol=1e-5)


def _dense_case(seed, B, Hq, Hkv, S, D):
    """q [B, Hq, D] and a cache in the port engine's layout [B, S, Hkv, D];
    lengths ragged, always covering 1 and S."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    ck = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    cv = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = 1, S
    return q, ck, cv, lengths


def _port_dense(q, ck, cv, lengths):
    # the engine hands the kernel a transposed VIEW of its cache
    return DA.decode_attention(
        torch.from_numpy(q), torch.from_numpy(ck).transpose(1, 2),
        torch.from_numpy(cv).transpose(1, 2),
        torch.from_numpy(lengths)).numpy()


def _jax_dense(q, ck, cv, lengths, block_kv):
    k, v = np.moveaxis(ck, 1, 2), np.moveaxis(cv, 1, 2)
    args = [jnp.asarray(a) for a in (q, k, v, lengths)]
    return (np.asarray(pallas_decode(*args, block_kv=block_kv,
                                     interpret=True)),
            np.asarray(decode_attention_ref(*args)))


def _paged_case(seed, B, Hkv, g, pps, page, D, extra=3):
    """A page pool whose rows' pages sit at shuffled pool positions; table
    entries past a row's length stay 0 (the scratch page); every page no
    row owns — page 0 included — holds finite garbage."""
    rng = np.random.default_rng(seed)
    S = pps * page
    q = rng.standard_normal((B, Hkv * g, D)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    lengths[0] = 1
    P = 1 + B * pps + extra
    perm = 1 + rng.permutation(P - 1)
    pool_k = np.full((P, page, Hkv, D), 1e4, np.float32)
    pool_v = np.full((P, page, Hkv, D), -1e4, np.float32)
    tables = np.zeros((B, pps), np.int32)
    k_lin = np.zeros((B, S, Hkv, D), np.float32)
    v_lin = np.zeros((B, S, Hkv, D), np.float32)
    for b in range(B):
        used = -(-int(lengths[b]) // page)
        tables[b, :used] = perm[b * pps:b * pps + used]
        for j in range(used):
            kk = rng.standard_normal((page, Hkv, D)).astype(np.float32)
            vv = rng.standard_normal((page, Hkv, D)).astype(np.float32)
            pool_k[tables[b, j]], pool_v[tables[b, j]] = kk, vv
            k_lin[b, j * page:(j + 1) * page] = kk
            v_lin[b, j * page:(j + 1) * page] = vv
    return q, pool_k, pool_v, lengths, tables, k_lin, v_lin


def _port_paged(q, pk, pv, lengths, tables):
    return DA.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, pk, pv, lengths, tables))).numpy()


class TestDenseDecodeAttention:
    @pytest.mark.parametrize("B,Hq,Hkv,S,D", [
        (4, 8, 2, 300, 64),      # ragged kv-block edge
        (2, 8, 4, 64, 32),       # edge-tiny heads
        (3, 32, 8, 128, 128),    # minitron heads
    ])
    def test_matches_pallas_and_ref(self, B, Hq, Hkv, S, D):
        q, ck, cv, lengths = _dense_case(B * 100 + S, B, Hq, Hkv, S, D)
        out = _port_dense(q, ck, cv, lengths)
        pal, ref = _jax_dense(q, ck, cv, lengths, block_kv=128)
        np.testing.assert_allclose(out, pal, **TOL)
        np.testing.assert_allclose(out, ref, **TOL)

    @settings(max_examples=3, deadline=None, database=None)
    @given(B=st.integers(1, 4), g=st.integers(1, 4), S=st.integers(2, 160),
           D=st.sampled_from([32, 64]), seed=st.integers(0, 10_000))
    def test_ragged_lengths_property(self, B, g, S, D, seed):
        """Continuous batching: arbitrary per-row lengths stay exact."""
        q, ck, cv, lengths = _dense_case(seed, B, 2 * g, 2, S, D)
        out = _port_dense(q, ck, cv, lengths)
        pal, ref = _jax_dense(q, ck, cv, lengths, block_kv=64)
        np.testing.assert_allclose(out, pal, **TOL)
        np.testing.assert_allclose(out, ref, **TOL)


class TestPagedDecodeAttention:
    @pytest.mark.parametrize("B,Hkv,g,pps,page,D", [
        (3, 4, 2, 4, 16, 32),     # the engine smoke shape
        (2, 2, 4, 8, 32, 64),
        (4, 8, 4, 2, 16, 128),    # minitron heads
    ])
    def test_matches_pallas_and_refs(self, B, Hkv, g, pps, page, D):
        """Shuffled pool + tables == the Pallas kernel == its gather oracle
        == the dense oracle on the same logical rows."""
        q, pk, pv, lengths, tables, k_lin, v_lin = _paged_case(
            11 + B, B, Hkv, g, pps, page, D)
        out = _port_paged(q, pk, pv, lengths, tables)
        j = [jnp.asarray(a) for a in (q, pk, pv, lengths, tables)]
        pal = np.asarray(pallas_paged(*j, interpret=True))
        ref = np.asarray(paged_decode_attention_ref(*j))
        dense = np.asarray(decode_attention_ref(
            j[0], jnp.asarray(np.moveaxis(k_lin, 1, 2)),
            jnp.asarray(np.moveaxis(v_lin, 1, 2)), j[3]))
        for other in (pal, ref, dense):
            np.testing.assert_allclose(out, other, **TOL)
        # the dense wrapper on the linear view gives the same rows' answer
        np.testing.assert_allclose(
            out, _port_dense(q, k_lin, v_lin, lengths), **TOL)

    @settings(max_examples=3, deadline=None, database=None)
    @given(B=st.integers(1, 4), Hkv=st.sampled_from([1, 2, 4]),
           pps=st.integers(1, 5), page=st.sampled_from([8, 16]),
           seed=st.integers(0, 10_000))
    def test_ragged_tables_property(self, B, Hkv, pps, page, seed):
        """Arbitrary table permutations and ragged lengths stay exact;
        scratch-page entries and unowned garbage pages are never read."""
        q, pk, pv, lengths, tables, k_lin, v_lin = _paged_case(
            seed, B, Hkv, 2, pps, page, 64)
        out = _port_paged(q, pk, pv, lengths, tables)
        j = [jnp.asarray(a) for a in (q, pk, pv, lengths, tables)]
        np.testing.assert_allclose(
            out, np.asarray(pallas_paged(*j, interpret=True)), **TOL)
        np.testing.assert_allclose(
            out, _port_dense(q, k_lin, v_lin, lengths), **TOL)


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version_without_counting(self):
        q, ck, cv, lengths = _dense_case(0, 2, 4, 2, 16, 32)
        before = dict(DA.LAUNCHES)
        out = _port_dense(q, ck, cv, lengths)
        ref = DA.decode_attention_ref(
            torch.from_numpy(q), torch.from_numpy(ck).transpose(1, 2),
            torch.from_numpy(cv).transpose(1, 2), torch.from_numpy(lengths))
        assert np.array_equal(out, ref.numpy())
        assert DA.LAUNCHES == before

    @pytest.mark.parametrize("paged", [False, True])
    def test_other_devices_raise_instead_of_falling_back(self, paged):
        """A tensor that is not on the CPU never reaches the plain version:
        anything but a valid CUDA tensor raises before a launch."""
        meta = dict(device="meta", dtype=torch.float32)
        q = torch.empty((2, 4, 32), **meta)
        lengths = torch.empty((2,), device="meta", dtype=torch.int32)
        with pytest.raises(ValueError):
            if paged:
                kv = torch.empty((3, 16, 2, 32), **meta)
                DA.paged_decode_attention(
                    q, kv, kv, lengths,
                    torch.empty((2, 2), device="meta", dtype=torch.int32))
            else:
                kv = torch.empty((2, 2, 16, 32), **meta)
                DA.decode_attention(q, kv, kv, lengths)

    def test_bf16_plain_version_is_close_to_f32(self):
        """The plain version computes in f32 whatever the input dtype; with
        bf16 inputs and output (8 mantissa bits) it stays within 5e-2."""
        q, ck, cv, lengths = _dense_case(5, 2, 8, 4, 48, 64)
        t = [torch.from_numpy(a) for a in (q, ck, cv)]
        lens = torch.from_numpy(lengths)
        f32 = DA.decode_attention(t[0], t[1].transpose(1, 2),
                                  t[2].transpose(1, 2), lens)
        b = [x.to(torch.bfloat16) for x in t]
        bf = DA.decode_attention(b[0], b[1].transpose(1, 2),
                                 b[2].transpose(1, 2), lens)
        assert bf.dtype == torch.bfloat16
        np.testing.assert_allclose(bf.float().numpy(), f32.numpy(),
                                   atol=5e-2, rtol=5e-2)

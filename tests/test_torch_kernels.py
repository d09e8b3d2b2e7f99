"""The port's kernel wrappers on the CPU (their plain versions) against the
reference package's Pallas kernels in interpret mode and its ref.py
oracles, on the same numpy inputs: decode attention (dense and paged), the
grouped expert GEMM (plain and fused SwiGLU), the RG-LRU scan and the SSD
chunked scan (also against the model functions they compute, ``_scan_lru``
and ``_ssd_chunked``, with a carried state in and out).

Tolerance: 1e-5 absolute and relative in f32 — the three compute the same
function in f32 and differ only in summation order; 1e-4 for the SSD scan,
whose outputs are 16- to 128-term sums taken in another order. The CUDA
kernels themselves are checked against these plain versions on the card by
chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.decode_attention.decode_attention import (
    decode_attention as pallas_decode, paged_decode_attention as pallas_paged)
from repro.kernels.decode_attention.ref import (decode_attention_ref,
                                                paged_decode_attention_ref)
from repro.kernels.moe_gemm.moe_gemm import (
    moe_ffn_fused as pallas_moe_ffn_fused, moe_gemm as pallas_moe_gemm)
from repro.kernels.moe_gemm.ref import moe_ffn_fused_ref, moe_gemm_ref
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref
from repro.kernels.rglru_scan.rglru_scan import rglru_scan as pallas_rglru
from repro.kernels.ssd_chunk.ssd_chunk import ssd_chunk as pallas_ssd
from repro.models.rglru import _scan_lru
from repro.models.ssd import _ssd_chunked
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention as DA
from repro_torch.kernels.moe_gemm import moe_gemm as MG
from repro_torch.kernels.rglru_scan import rglru_scan as RS
from repro_torch.kernels.ssd_chunk import ssd_chunk as SC

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


# ---------------------------------------------------------------------------
# grouped expert GEMM (+ fused SwiGLU)
# ---------------------------------------------------------------------------

def _grouped_case(seed, E, C, D, F, empty=()):
    """x [E, C, D], w_gate / w_up [E, D, F]; experts in ``empty`` get all-zero
    capacity rows (an expert no token was routed to)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    x[list(empty)] = 0.0
    wg = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    return x, wg, wu


def _check_grouped(x, wg, wu, **blocks):
    """The port's plain versions == the Pallas kernels (interpret mode) ==
    the reference's ref.py, for both kernels."""
    j = [jnp.asarray(a) for a in (x, wg, wu)]
    t = [torch.from_numpy(a) for a in (x, wg, wu)]
    plain = MG.moe_gemm(t[0], t[1]).numpy()
    np.testing.assert_allclose(
        plain, np.asarray(pallas_moe_gemm(j[0], j[1], interpret=True,
                                          **blocks)), **TOL)
    np.testing.assert_allclose(plain, np.asarray(moe_gemm_ref(j[0], j[1])),
                               **TOL)
    fused = MG.moe_ffn_fused(*t).numpy()
    np.testing.assert_allclose(
        fused, np.asarray(pallas_moe_ffn_fused(*j, interpret=True,
                                               **blocks)), **TOL)
    np.testing.assert_allclose(fused, np.asarray(moe_ffn_fused_ref(*j)),
                               **TOL)


class TestGroupedGemm:
    @pytest.mark.parametrize("E,C,D,F,empty", [
        (4, 8, 64, 64, ()),          # the MoE smoke config at decode
        (3, 13, 40, 24, (1,)),       # C off every tile, an empty expert
        (9, 8, 128, 8, (0,)),        # adapter route h @ A: F = rank 8
        (9, 8, 8, 128, (0, 4)),      # adapter route t @ B: D = rank 8
        (2, 160, 48, 72, ()),        # prefill-sized C: several C tiles
    ])
    def test_matches_pallas_and_ref(self, E, C, D, F, empty):
        _check_grouped(*_grouped_case(E * 1000 + C, E, C, D, F, empty))

    @settings(max_examples=3, deadline=None, database=None)
    @given(E=st.integers(1, 5), C=st.integers(1, 40), D=st.integers(1, 48),
           F=st.integers(1, 40), seed=st.integers(0, 10_000))
    def test_ragged_shapes_property(self, E, C, D, F, seed):
        """Any E, C, D, F — none a multiple of a tile — stays exact, with
        small Pallas blocks so that its pad-and-slice path is taken too."""
        _check_grouped(*_grouped_case(seed, E, C, D, F, (0,)),
                       block_c=8, block_f=16)

    def test_empty_expert_rows_give_zero(self):
        x, wg, wu = _grouped_case(3, 3, 8, 16, 16, empty=(2,))
        t = [torch.from_numpy(a) for a in (x, wg, wu)]
        assert not MG.moe_gemm(t[0], t[1])[2].any()
        assert not MG.moe_ffn_fused(*t)[2].any()

    def test_cpu_tensors_take_the_plain_version_without_counting(self):
        x, wg, wu = (torch.from_numpy(a) for a in
                     _grouped_case(0, 2, 4, 8, 8))
        before = dict(MG.LAUNCHES)
        assert torch.equal(MG.moe_gemm(x, wg), MG.moe_gemm_ref(x, wg))
        assert torch.equal(MG.moe_ffn_fused(x, wg, wu),
                           MG.moe_ffn_fused_ref(x, wg, wu))
        assert MG.LAUNCHES == before

    @pytest.mark.parametrize("fused", [False, True])
    def test_other_devices_raise_instead_of_falling_back(self, fused):
        x = torch.empty((2, 4, 8), device="meta")
        w = torch.empty((2, 8, 8), device="meta")
        with pytest.raises(ValueError):
            if fused:
                MG.moe_ffn_fused(x, w, w)
            else:
                MG.moe_gemm(x, w)

    def test_bf16_plain_version_is_close_to_f32(self):
        """The plain versions accumulate in f32 whatever the input dtype and
        write x's dtype: with bf16 inputs and output (8 mantissa bits) they
        stay within 5e-2 of the f32 result."""
        x, wg, wu = (torch.from_numpy(a) for a in
                     _grouped_case(5, 3, 8, 64, 32))
        bf = [t.to(torch.bfloat16) for t in (x, wg, wu)]
        for got, want in ((MG.moe_gemm(bf[0], bf[1]), MG.moe_gemm(x, wg)),
                          (MG.moe_ffn_fused(*bf), MG.moe_ffn_fused(x, wg,
                                                                   wu))):
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                       atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

def _rglru_case(seed, B, T, W, h0=True):
    """a in (0.5, 1) (the model's decays lie in (0, 1)), b normal, h0
    normal or zero."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, T, W)).astype(np.float32)
    b = rng.standard_normal((B, T, W)).astype(np.float32)
    h0v = (rng.standard_normal((B, W)) if h0 else np.zeros((B, W))).astype(
        np.float32)
    return a, b, h0v


def _port_rglru(a, b, h0):
    return RS.rglru_scan(*(torch.from_numpy(x) for x in (a, b, h0))).numpy()


class TestRglruScan:
    @pytest.mark.parametrize("B,T,W", [
        (1, 37, 64),        # T not a multiple of any block or chunk
        (2, 300, 16),       # two of the reference's 256-step chunks
        (3, 1, 8),          # a single step
    ])
    def test_matches_scan_lru_with_a_carried_state(self, B, T, W):
        a, b, h0 = _rglru_case(T * 10 + B, B, T, W)
        want = np.asarray(_scan_lru(*(jnp.asarray(x) for x in (a, b, h0))))
        np.testing.assert_allclose(_port_rglru(a, b, h0), want, **TOL)

    @pytest.mark.parametrize("B,T,W", [(2, 40, 64), (1, 96, 130)])
    def test_matches_pallas_and_ref_from_zero(self, B, T, W):
        """From h0 = 0, the function of the Pallas kernel (interpret mode,
        its pad-and-slice path: T and W off its blocks) and of ref.py."""
        a, b, h0 = _rglru_case(T + W, B, T, W, h0=False)
        got = _port_rglru(a, b, h0)
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        np.testing.assert_allclose(
            got, np.asarray(pallas_rglru(ja, jb, block_t=16, block_w=128,
                                         interpret=True)), **TOL)
        np.testing.assert_allclose(got, np.asarray(jax_rglru_ref(ja, jb)),
                                   **TOL)

    @settings(max_examples=3, deadline=None, database=None)
    @given(B=st.integers(1, 3), T=st.integers(1, 600), W=st.integers(1, 24),
           seed=st.integers(0, 10_000))
    def test_ragged_shapes_property(self, B, T, W, seed):
        a, b, h0 = _rglru_case(seed, B, T, W)
        want = np.asarray(_scan_lru(*(jnp.asarray(x) for x in (a, b, h0))))
        np.testing.assert_allclose(_port_rglru(a, b, h0), want, **TOL)

    def test_identity_steps_carry_the_state(self):
        """Padded steps arrive as a = 1, b = 0: the state passes through
        them, so h[:, -1] is the state at the true length (up to the
        log-depth scan's other grouping of the same products)."""
        a, b, h0 = _rglru_case(4, 2, 24, 16)
        a[:, 17:], b[:, 17:] = 1.0, 0.0
        h = _port_rglru(a, b, h0)
        np.testing.assert_allclose(h[:, -1], h[:, 16], **TOL)

    def test_cpu_tensors_take_the_plain_version_without_counting(self):
        a, b, h0 = (torch.from_numpy(x) for x in _rglru_case(0, 2, 9, 8))
        before = dict(RS.LAUNCHES)
        assert torch.equal(RS.rglru_scan(a, b, h0), RS.rglru_scan_ref(a, b,
                                                                      h0))
        assert RS.LAUNCHES == before

    def test_other_devices_raise_instead_of_falling_back(self):
        a = torch.empty((1, 8, 16), device="meta")
        with pytest.raises(ValueError):
            RS.rglru_scan(a, a, torch.empty((1, 16), device="meta"))


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------

SSD_TOL = dict(atol=1e-4, rtol=1e-4)


def _ssd_case(seed, b, l, nh, hp, g, n, S0=True):
    """The model's ranges: dt in [1e-3, 0.1] (post-softplus of the init's
    bias), A = -(1..nh), x, B, C and S0 normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, nh, hp)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (b, l, nh)).astype(np.float32)
    A = -np.arange(1, nh + 1, dtype=np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    s0 = (rng.standard_normal((b, nh, hp, n)) if S0
          else np.zeros((b, nh, hp, n))).astype(np.float32)
    return x, dt, A, B, C, s0


def _port_ssd(case, chunk):
    y, S = SC.ssd_chunk(*(torch.from_numpy(a) for a in case), chunk)
    return y.numpy(), S.numpy()


class TestSsdChunk:
    @pytest.mark.parametrize("b,l,nh,hp,g,n,chunk", [
        (2, 37, 8, 16, 1, 16, 16),     # mamba2 smoke widths, ragged l
        (1, 64, 4, 8, 2, 16, 16),      # two groups, whole chunks
        (2, 10, 4, 8, 2, 8, 16),       # l below the chunk: Q = l
        (1, 150, 2, 8, 1, 12, 64),     # the last chunk ragged past 128
    ])
    def test_matches_ssd_chunked_with_a_carried_state(self, b, l, nh, hp, g,
                                                      n, chunk):
        case = _ssd_case(l * 7 + nh, b, l, nh, hp, g, n)
        cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                                  ssm_chunk=chunk)
        yj, Sj = _ssd_chunked(cfg, *(jnp.asarray(a) for a in case))
        y, S = _port_ssd(case, chunk)
        np.testing.assert_allclose(y, np.asarray(yj), **SSD_TOL)
        np.testing.assert_allclose(S, np.asarray(Sj), **SSD_TOL)

    @pytest.mark.parametrize("b,l,nh,hp,g,n,chunk", [
        (1, 48, 4, 16, 1, 16, 16), (2, 40, 4, 8, 2, 8, 16)])
    def test_matches_pallas_from_zero(self, b, l, nh, hp, g, n, chunk):
        """From S0 = 0, the Pallas kernel (interpret mode) on its own
        layouts: heads before time, B and C expanded to heads, y cast to
        x's dtype; l = 40 is ragged against its chunk."""
        x, dt, A, B, C, s0 = _ssd_case(l + g, b, l, nh, hp, g, n, S0=False)
        y, _ = _port_ssd((x, dt, A, B, C, s0), chunk)
        hpg = nh // g
        Bh, Ch = (np.repeat(m, hpg, axis=2) for m in (B, C))
        yp = pallas_ssd(jnp.asarray(np.moveaxis(x, 1, 2)),
                        jnp.asarray(np.moveaxis(dt, 1, 2)),
                        jnp.asarray(np.moveaxis(Bh, 1, 2)),
                        jnp.asarray(np.moveaxis(Ch, 1, 2)), jnp.asarray(A),
                        chunk=chunk, interpret=True)
        np.testing.assert_allclose(y.astype(x.dtype),
                                   np.moveaxis(np.asarray(yp), 2, 1),
                                   **SSD_TOL)

    def test_zero_dt_steps_carry_the_state(self):
        """Padded steps arrive with dt = 0: the recurrence is the identity
        there, so S_final is the state at the true length."""
        case = list(_ssd_case(9, 1, 40, 4, 8, 1, 8))
        _, S_short = _port_ssd([a[:, :29] if a.ndim > 1 and i != 5 else a
                                for i, a in enumerate(case)], 16)
        case[1][:, 29:] = 0.0
        _, S_pad = _port_ssd(case, 16)
        np.testing.assert_allclose(S_pad, S_short, **SSD_TOL)

    def test_cpu_tensors_take_the_plain_version_without_counting(self):
        case = [torch.from_numpy(a) for a in _ssd_case(0, 1, 20, 2, 8, 1, 8)]
        before = dict(SC.LAUNCHES)
        for got, want in zip(SC.ssd_chunk(*case, 16),
                             SC.ssd_chunk_ref(*case, 16)):
            assert torch.equal(got, want)
        assert SC.LAUNCHES == before

    def test_other_devices_raise_instead_of_falling_back(self):
        m = dict(device="meta")
        with pytest.raises(ValueError):
            SC.ssd_chunk(torch.empty((1, 8, 2, 4), **m),
                         torch.empty((1, 8, 2), **m), torch.empty((2,), **m),
                         torch.empty((1, 8, 1, 4), **m),
                         torch.empty((1, 8, 1, 4), **m),
                         torch.empty((1, 2, 4, 4), **m), 16)

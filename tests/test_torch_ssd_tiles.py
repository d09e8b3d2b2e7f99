"""The bf16 route of the SSD chunked scan (``csrc/ssd_chunk.cu``, namespace
``tc``: ``ssd_states``, ``ssd_outputs``), transliterated into
numpy lane by lane and held to the plain version, to the reference's
``_ssd_chunked`` and, from a zero state, to the Pallas kernel in interpret
mode.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to
their plain version there). This transliteration follows their index
arithmetic step for step: the in-chunk prefix sum as one warp computes it
(4 rows a lane, then a shuffle scan), the shared-memory tiles with their
padded pitches and zero fill past the chunk, the state and the head width,
the ldmatrix lane addresses (``.trans`` where the stored layout is the
fragment's transpose), the m16n8k16 fragment layouts, the hi + lo bf16
split of every f32 operand, the score tile's accumulators reused as the A
fragments of ``M x``, the state carried across chunks in the
accumulators, and the stores through shared memory. Shared memory starts
as NaN (and B's tile, staged over the dead state tiles, over NaN again),
so any element a kernel reads without having written it shows in a kept
output. The 16-byte and the scalar staging paths put the same values in
shared memory, so one transliteration covers both.

Inputs x, B and C are bf16 values (rounded once in the test), as the route
takes them, so the products with them are exact; the plain version sees the
same values in f32. Tolerance 1e-4 absolute and relative: the split leaves
~2^-17 of each f32 operand, and the f32 sums run in another order.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.ssd_chunk.ssd_chunk import ssd_chunk as pallas_ssd
from repro.models.ssd import _ssd_chunked
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.build import SOURCES, _HERE
from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
from tests.test_torch_moe_tiles import G, LANES, TG, _ldmatrix_x4, _mma

TOL = dict(atol=1e-4, rtol=1e-4)

# the kernels' tile constants (namespace tc of ssd_chunk.cu)
KQ, KN, KP, KPS, KNS = 128, 128, 64, 64, 64
QPITCH, XPITCH, SXPITCH, NSPITCH = KN + 8, KP + 8, KPS + 8, KNS + 8
YPITCH = KP + 8                          # the staged output (f32)
LR, LM = LANES % 8, LANES // 8
F32 = np.float32


def _bf16(v):
    return torch.from_numpy(np.ascontiguousarray(v, F32)).to(
        torch.bfloat16).float().numpy()


def _split(v):
    hi = _bf16(v)
    return hi, _bf16(np.asarray(v, F32) - hi)


def _fma(a, b, c):
    """fmaf: one rounding of the exact a * b + c (f64 holds a * b exactly)."""
    d = np.float64
    return (np.asarray(a, d) * np.asarray(b, d) + np.asarray(c, d)).astype(F32)


def _chunk_cum(dt, A, bb, h, c0, qlen):
    """dts [kQ] (zeros past qlen) and cum [kQ] as chunk_cum computes them:
    lane l sums rows 4 l .. 4 l + 3 in order, the lanes' totals are scanned
    by shuffles (offsets 1, 2, 4, 8, 16), and each row adds its lane's
    exclusive prefix."""
    dts = np.zeros(KQ, F32)
    dts[:qlen] = dt[bb, c0:c0 + qlen, h]
    dA = (dts * F32(A[h])).reshape(32, 4)
    loc = np.zeros((32, 4), F32)
    run = np.zeros(32, F32)
    for r in range(4):
        run = (run + dA[:, r]).astype(F32)
        loc[:, r] = run
    incl = run.copy()
    for o in (1, 2, 4, 8, 16):
        shifted = np.concatenate([np.zeros(o, F32), incl[:-o]])
        incl = np.where(LANES >= o, incl + shifted, incl).astype(F32)
    excl = np.concatenate([np.zeros(1, F32), incl[:-1]])
    return dts, (excl[:, None] + loc).astype(F32).reshape(KQ)


def _stage(smem, off, pitch, src, rows, valid_rows, width, cols):
    """stage<W>: rows [0, rows) x columns [0, width) into smem at ``off``
    with row pitch ``pitch``; zeros past (valid_rows, cols)."""
    for r in range(rows):
        row = np.zeros(width, F32)
        if r < valid_rows:
            row[:cols] = src[r, :cols]
        smem[off + r * pitch:off + r * pitch + width] = row


def _a_frag(m):
    """A fragment [32, 4, 2] from two n8 accumulator tiles m[t][:, q]."""
    return np.stack([np.stack([m[0][:, 0], m[0][:, 1]], 1),
                     np.stack([m[0][:, 2], m[0][:, 3]], 1),
                     np.stack([m[1][:, 0], m[1][:, 1]], 1),
                     np.stack([m[1][:, 2], m[1][:, 3]], 1)], axis=1)


def tc_transliteration(x, dt, A, B, C, S0, chunk, split=_split,
                       return_ws=False):
    """(y, S_final) as the three kernels of the bf16 route compute them;
    ``split`` is the hi + lo split of the f32 operands. With ``return_ws``
    also the workspace ssd_states leaves: the state entering each chunk."""
    b, L, nh, hp = x.shape
    Gn, n = B.shape[2], B.shape[3]
    Q = min(chunk, L)
    nc, hpt = -(-L // Q), -(-hp // KP)
    hpg = nh // Gn
    ws = np.full((b, nc, nh, hp, n), np.nan, F32)
    S_final = np.full((b, nh, hp, n), np.nan, F32)
    y = np.full((b, L, nh, hp), np.nan, F32)

    def block_ids():
        for bb in range(b):
            for h in range(nh):
                for c in range(nc):
                    for pt in range(hpt):
                        p0, c0 = pt * KP, c * Q
                        yield (bb, h, c, pt, p0, min(KP, hp - p0), c0,
                               min(Q, L - c0))

    # ---- ssd_states: the state carried across the chunks ------------------
    tiles = [(pt * KPS, k0) for pt in range(-(-hp // KPS))
             for k0 in range(0, n, KNS)]
    for bb in range(b):
        for h in range(nh):
            grp = h // hpg
            for p0, k0 in tiles:
                hpl, nsl = min(KPS, hp - p0), min(KNS, n - k0)
                warps = [(w & 3, w >> 2) for w in range(8)]

                # warp (wm, wn)'s accumulators: rows 16 wm + G (+ 8),
                # columns 32 wn + 8 t + 2 TG (+ 1) of the tile
                def cells(wm, wn, t, q):
                    p = 16 * wm + G + (q >> 1) * 8
                    k = 32 * wn + 8 * t + 2 * TG + (q & 1)
                    return p, k, (p < hpl) & (k < nsl)

                def state_io(wm, wn, get=None, put=None):
                    for t in range(4):
                        for q in range(4):
                            p, k, ok = cells(wm, wn, t, q)
                            if get is not None:
                                acc[wm, wn][t][ok, q] = get[p0 + p[ok],
                                                            k0 + k[ok]]
                            else:
                                put[p0 + p[ok], k0 + k[ok]] = \
                                    acc[wm, wn][t][ok, q]

                acc = {}
                for wm, wn in warps:
                    acc[wm, wn] = np.zeros((4, 32, 4), F32)
                    state_io(wm, wn, get=S0[bb, h])
                for c in range(nc):
                    c0 = c * Q
                    qlen = min(Q, L - c0)
                    q16 = (qlen + 15) & ~15
                    bs, xs = 0, KQ * NSPITCH
                    vh = xs + KQ * SXPITCH
                    vl = vh + KQ * SXPITCH
                    smem = np.full(vl + KQ * SXPITCH, np.nan, F32)
                    _stage(smem, bs, NSPITCH,
                           B[bb, c0:c0 + qlen, grp, k0:k0 + nsl], q16, qlen,
                           KNS, nsl)
                    _stage(smem, xs, SXPITCH,
                           x[bb, c0:c0 + qlen, h, p0:p0 + hpl], q16, qlen,
                           KPS, hpl)
                    dts, cum = _chunk_cum(dt, A, bb, h, c0, qlen)
                    clast = cum[KQ - 1]
                    wgt = (dts * np.exp(clast - cum)).astype(F32)
                    for j in range(q16):
                        v = smem[xs + j * SXPITCH:xs + j * SXPITCH + KPS]
                        hi, lo = split(v * wgt[j])
                        smem[vh + j * SXPITCH:vh + j * SXPITCH + KPS] = hi
                        smem[vl + j * SXPITCH:vl + j * SXPITCH + KPS] = lo
                    for wm, wn in warps:             # S_in[c] out
                        state_io(wm, wn, put=ws[bb, c, h])
                    for wm, wn in warps:
                        acc[wm, wn] *= np.exp(clast)
                        if 16 * wm >= hpl or 32 * wn >= nsl:
                            continue
                        a_lane = ((LR + (LM >> 1) * 8) * SXPITCH + 16 * wm
                                  + (LM & 1) * 8)
                        b_lane = ((LR + (LM & 1) * 8) * NSPITCH + 32 * wn
                                  + (LM >> 1) * 8)
                        for ks in range(q16 // 16):
                            ah = _ldmatrix_x4(
                                smem, vh + a_lane + ks * 16 * SXPITCH, True)
                            al = _ldmatrix_x4(
                                smem, vl + a_lane + ks * 16 * SXPITCH, True)
                            for q in range(min(2, (nsl - 32 * wn + 15) // 16)):
                                bf = _ldmatrix_x4(
                                    smem, bs + b_lane + ks * 16 * NSPITCH
                                    + 16 * q, True)
                                for t, (r0, r1) in ((2 * q, (0, 1)),
                                                    (2 * q + 1, (2, 3))):
                                    _mma(acc[wm, wn][t], ah, bf[:, r0],
                                         bf[:, r1])
                                    _mma(acc[wm, wn][t], al, bf[:, r0],
                                         bf[:, r1])
                for wm, wn in warps:                 # S_final
                    state_io(wm, wn, put=S_final[bb, h])

    # ---- ssd_outputs ------------------------------------------------------
    for bb, h, c, pt, p0, hpl, c0, qlen in block_ids():
        q16 = (qlen + 15) & ~15
        grp = h // hpg
        cs, xs = 0, KQ * QPITCH
        sh = xs + KQ * XPITCH            # S_in hi and lo, then B over them
        sl, bs = sh + KP * QPITCH, sh
        smem = np.full(sh + KQ * QPITCH, np.nan, F32)
        dts, cum = _chunk_cum(dt, A, bb, h, c0, qlen)
        _stage(smem, cs, QPITCH, C[bb, c0:c0 + qlen, grp], q16, qlen, KN, n)
        _stage(smem, xs, XPITCH, x[bb, c0:c0 + qlen, h, p0:p0 + hpl], q16,
               qlen, KP, hpl)
        sin = np.zeros((KP, KN), F32)
        sin[:hpl, :n] = ws[bb, c, h, p0:p0 + hpl]
        hi, lo = split(sin)
        for p in range(KP):
            smem[sh + p * QPITCH:sh + p * QPITCH + KN] = hi[p]
            smem[sl + p * QPITCH:sl + p * QPITCH + KN] = lo[p]
        nkn, npq = -(-n // 16), -(-hpl // 16)
        active = [w for w in range(8) if 16 * w < qlen]
        cf, acc = {}, {}
        b_lane = (LR + (LM >> 1) * 8) * QPITCH + (LM & 1) * 8
        for warp in active:              # carried state, every warp
            i0 = 16 * warp
            c_lane = (i0 + LR + (LM & 1) * 8) * QPITCH + (LM >> 1) * 8
            cf[warp] = [_ldmatrix_x4(smem, cs + c_lane + 16 * ks, False)
                        for ks in range(nkn)]
            acc[warp] = np.zeros((8, 32, 4), F32)
            for ks in range(nkn):
                for q in range(npq):
                    off = 16 * q * QPITCH + 16 * ks
                    bh = _ldmatrix_x4(smem, sh + b_lane + off, False)
                    bl = _ldmatrix_x4(smem, sl + b_lane + off, False)
                    for t, (r0, r1) in ((2 * q, (0, 1)), (2 * q + 1, (2, 3))):
                        _mma(acc[warp][t], cf[warp][ks], bh[:, r0],
                             bh[:, r1])
                        _mma(acc[warp][t], cf[warp][ks], bl[:, r0],
                             bl[:, r1])
            acc[warp][:, :, 0:2] *= np.exp(cum[i0 + G])[None, :, None]
            acc[warp][:, :, 2:4] *= np.exp(cum[i0 + G + 8])[None, :, None]
        smem[sh:] = np.nan               # S_in is dead: B is staged over it
        _stage(smem, bs, QPITCH, B[bb, c0:c0 + qlen, grp], q16, qlen, KN, n)
        x_lane = (LR + (LM & 1) * 8) * XPITCH + (LM >> 1) * 8
        ys = np.full(KQ * YPITCH, np.nan, F32)   # over C and x at the end
        for warp in active:              # the diagonal
            ia, ib = 16 * warp + G, 16 * warp + G + 8
            for jp in range(min(warp + 1, q16 // 16)):
                gacc = np.zeros((2, 32, 4), F32)
                for ks in range(nkn):
                    bf = _ldmatrix_x4(
                        smem, bs + b_lane + 16 * jp * QPITCH + 16 * ks, False)
                    _mma(gacc[0], cf[warp][ks], bf[:, 0], bf[:, 1])
                    _mma(gacc[1], cf[warp][ks], bf[:, 2], bf[:, 3])
                mh, ml = np.zeros((2, 32, 4), F32), np.zeros((2, 32, 4), F32)
                for t in range(2):
                    for q in range(4):
                        i = ia if q < 2 else ib
                        j = 16 * jp + 8 * t + 2 * TG + (q & 1)
                        m = np.where(j <= i, gacc[t][:, q] * np.exp(
                            cum[i] - cum[j]) * dts[j], F32(0.0)).astype(F32)
                        mh[t][:, q], ml[t][:, q] = split(m)
                ah, al = _a_frag(mh), _a_frag(ml)
                for q in range(npq):
                    bf = _ldmatrix_x4(
                        smem, xs + x_lane + 16 * jp * XPITCH + 16 * q, True)
                    for t, (r0, r1) in ((2 * q, (0, 1)), (2 * q + 1, (2, 3))):
                        _mma(acc[warp][t], ah, bf[:, r0], bf[:, r1])
                        _mma(acc[warp][t], al, bf[:, r0], bf[:, r1])
            for t in range(8):           # y through [i][p]
                p = 8 * t + 2 * TG
                for q in range(4):
                    i = ia if q < 2 else ib
                    ys[i * YPITCH + p + (q & 1)] = acc[warp][t][:, q]
        for i in range(qlen):            # rows of 16-byte stores
            for p in range(0, hpl, 4):
                m = min(4, hpl - p)
                y[bb, c0 + i, h, p0 + p:p0 + p + m] = \
                    ys[i * YPITCH + p:i * YPITCH + p + m]
    return (y, S_final, ws) if return_ws else (y, S_final)


def _case(seed, b, l, nh, hp, g, n, S0=True):
    """The model's ranges (dt in [1e-3, 0.1], A = -(1..nh)); x, B and C
    rounded to bf16 values, as the route receives them."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((b, l, nh, hp)))
    dt = rng.uniform(1e-3, 0.1, (b, l, nh)).astype(F32)
    A = -np.arange(1, nh + 1, dtype=F32)
    B = _bf16(rng.standard_normal((b, l, g, n)))
    C = _bf16(rng.standard_normal((b, l, g, n)))
    s0 = (rng.standard_normal((b, nh, hp, n)) if S0
          else np.zeros((b, nh, hp, n))).astype(F32)
    return x, dt, A, B, C, s0


def _plain(case, chunk):
    y, S = SC.ssd_chunk_ref(*(torch.from_numpy(a) for a in case), chunk)
    return y.numpy(), S.numpy()


@pytest.mark.parametrize("b,l,nh,hp,g,n,chunk", [
    (2, 37, 4, 16, 1, 16, 16),      # smoke widths, a ragged last chunk
    (1, 10, 2, 8, 2, 8, 16),        # l below the chunk: Q = l = 10
    (1, 40, 4, 24, 2, 40, 32),      # g 2; hp, n off 16; last chunk of 8
    (1, 70, 2, 72, 1, 20, 64),      # hp 72: a second hp tile of 8 columns
    (1, 130, 2, 64, 1, 128, 128),   # mamba2-1.3b's widths, two chunks
])
def test_transliteration_matches_plain_and_ssd_chunked(b, l, nh, hp, g, n,
                                                       chunk):
    case = _case(l * 13 + hp, b, l, nh, hp, g, n)
    y, S = tc_transliteration(*case, chunk)
    yp, Sp = _plain(case, chunk)
    np.testing.assert_allclose(y, yp, **TOL)
    np.testing.assert_allclose(S, Sp, **TOL)
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              ssm_chunk=chunk)
    yj, Sj = _ssd_chunked(cfg, *(jnp.asarray(a) for a in case))
    np.testing.assert_allclose(y, np.asarray(yj), **TOL)
    np.testing.assert_allclose(S, np.asarray(Sj), **TOL)


@pytest.mark.parametrize("b,l,nh,hp,g,n,chunk", [
    (1, 48, 4, 16, 1, 16, 16), (1, 40, 4, 8, 2, 8, 16)])
def test_transliteration_matches_pallas_from_zero(b, l, nh, hp, g, n, chunk):
    """From S0 = 0, the Pallas kernel in interpret mode on its own layouts
    (heads before time, B and C expanded to heads); l 40 is ragged."""
    x, dt, A, B, C, s0 = _case(l + g, b, l, nh, hp, g, n, S0=False)
    y, _ = tc_transliteration(x, dt, A, B, C, s0, chunk)
    hpg = nh // g
    Bh, Ch = (np.repeat(m, hpg, axis=2) for m in (B, C))
    yp = pallas_ssd(*(jnp.asarray(np.moveaxis(a, 1, 2))
                      for a in (x, dt, Bh, Ch)), jnp.asarray(A),
                    chunk=chunk, interpret=True)
    np.testing.assert_allclose(y, np.moveaxis(np.asarray(yp), 2, 1), **TOL)


def test_zero_dt_steps_carry_the_state():
    """Padded steps arrive with dt = 0: the chunk's decay is then exp(0) =
    1 past the true length and their weights 0, so S_final is the state at
    the true length."""
    case = list(_case(9, 1, 40, 4, 8, 1, 16))
    _, S_short = tc_transliteration(*[a[:, :29] if a.ndim > 1 and i != 5
                                      else a for i, a in enumerate(case)], 16)
    case[1][:, 29:] = 0.0
    _, S_pad = tc_transliteration(*case, 16)
    np.testing.assert_allclose(S_pad, S_short, **TOL)


@settings(max_examples=6, deadline=None)
@given(l=st.integers(1, 45), hp=st.sampled_from([8, 16, 24]),
       n=st.sampled_from([8, 16, 24]), g=st.sampled_from([1, 2]),
       chunk=st.sampled_from([16, 32]), seed=st.integers(0, 2 ** 16))
def test_ragged_shapes_property(l, hp, n, g, chunk, seed):
    case = _case(seed, 1, l, 2, hp, g, n)
    y, S = tc_transliteration(*case, chunk)
    yp, Sp = _plain(case, chunk)
    np.testing.assert_allclose(y, yp, **TOL)
    np.testing.assert_allclose(S, Sp, **TOL)


def test_one_bf16_rounding_would_not_hold_the_tolerance():
    """Why the split: with the f32 operands rounded once to bf16 (no lo
    half) the same case misses the tolerance the split keeps."""
    case = _case(5, 1, 64, 2, 16, 1, 16)

    def hi_only(v):
        hi = _bf16(v)
        return hi, np.zeros_like(hi)

    y, _ = tc_transliteration(*case, 32, split=hi_only)
    yp, _ = _plain(case, 32)
    assert not np.allclose(y, yp, **TOL)


# ---------------------------------------------------------------------------
# the backward: ssd_chunk_bwd.cu (ssd_states_bwd, ssd_chunk_bwd,
# ssd_bc_reduce), transliterated thread by thread on NaN-filled shared
# memory and held to the plain backward
# ---------------------------------------------------------------------------

_BSRC = (_HERE / SOURCES["ssd_chunk_bwd"]).read_text()


def _bconst(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _BSRC).group(1))


BQ, BK, BR, BTHREADS = _bconst("kQ"), _bconst("kK"), _bconst("kR"), \
    _bconst("kThreads")
assert "constexpr int kAP = kK + 1;" in _BSRC
assert "constexpr int kTP = kR + 4;" in _BSRC
BAP, BTP = BK + 1, BR + 4
TID = np.arange(BTHREADS)
ROW, C0 = TID % 64, (TID // 64) * 4          # thread (r, g): row r, 4 g


def _r16(v):
    return (v + 15) & ~15


def _exp0(v):
    return np.exp(np.minimum(np.asarray(v, F32), F32(0))).astype(F32)


def _mm(acc, a, lda, b, ldb, K, nq):
    """mm<NQ>: acc[thread, q, e] += A[r][k] B[k][4 g + 16 q + e], k in
    order, one fmaf each (A and B flat shared-memory arrays)."""
    for k in range(K):
        av = a[ROW * lda + k][:, None]
        for q in range(nq):
            bv = b[(k * ldb + C0 + 16 * q)[:, None] + np.arange(4)]
            acc[:, q] = _fma(av, bv, acc[:, q])


def _stage_rows(dst, pitch, src, nr, rows, K, kp, scale=None):
    """stage_rows: rows [0, nr) of src (2-d) into dst at the pitch, scaled
    by scale[i]; zeros past (rows, K) up to column kp."""
    for i in range(nr):
        v = np.zeros(kp, F32)
        if i < rows:
            v[:K] = src[i, :K]
            if scale is not None:
                v = (v * scale[i]).astype(F32)
        dst[i * pitch:i * pitch + kp] = v


def _stage_cols(dst, src, rows, K, kp, scale=None):
    """stage_cols: rows [0, 64) transposed into dst[k][i], pitch kTP."""
    for i in range(BR):
        v = np.zeros(kp, F32)
        if i < rows:
            v[:K] = src[i, :K]
            if scale is not None:
                v = (v * scale[i]).astype(F32)
        dst[np.arange(kp) * BTP + i] = v


def _rowsum(part, r0, qlen):
    """row_sum: each row's four column-group partials, added in order."""
    red = part.reshape(4, 64)
    out = np.zeros(64, F32)
    for g in range(4):
        out = (out + red[g]).astype(F32)
    return {r0 + r: out[r] for r in range(64) if r0 + r < qlen}


def bwd_transliteration(x, dt, A, B, C, S0, dy, dSf, chunk, ws=None):
    """(dx, ddt, dA, dB, dC, dS0) as the three backward kernels compute
    them; ``ws`` the forward's S_in workspace (the bf16 route), else the
    first kernel recomputes it."""
    b, L, nh, hp = x.shape
    G, n = B.shape[2], B.shape[3]
    Q = min(chunk, L)
    nc, hpg = -(-L // Q), nh // G
    S_in = np.full((b, nc, nh, hp, n), np.nan, F32) if ws is None else ws
    dS_out = np.full((b, nc, nh, hp, n), np.nan, F32)
    dS0 = np.full((b, nh, hp, n), np.nan, F32)
    dx = np.full(x.shape, np.nan, F32)
    ddt = np.full(dt.shape, np.nan, F32)
    pdB = np.full((b, L, nh, n), np.nan, F32)
    pdC = np.full((b, L, nh, n), np.nan, F32)
    pdA = np.full((b, nc, nh), np.nan, F32)

    # ---- (a) ssd_states_bwd ----------------------------------------------
    for bb in range(b):
        for h in range(nh):
            grp = h // hpg
            for p0 in range(0, hp, BR):
                for k0 in range(0, n, BR):
                    hpl, nsl = min(BR, hp - p0), min(BR, n - k0)
                    kk = (C0[:, None, None] + 16 * np.arange(4)[None, :, None]
                          + np.arange(4)[None, None, :])       # [thr, q, e]
                    rr = np.broadcast_to(ROW[:, None, None], kk.shape)
                    ok = (rr < hpl) & (kk < nsl)

                    def load(state):
                        out = np.zeros(kk.shape, F32)
                        out[ok] = state[p0 + rr[ok], k0 + kk[ok]]
                        return out

                    def store(state, acc):
                        state[p0 + rr[ok], k0 + kk[ok]] = acc[ok]

                    def chunk_step(acc, c, fwd):
                        c0 = c * Q
                        qlen = min(Q, L - c0)
                        dts, cum = _chunk_cum(dt, A, bb, h, c0, qlen)
                        clast = cum[BQ - 1]
                        scale = ((_exp0(clast - cum) * dts).astype(F32)
                                 if fwd else _exp0(cum))
                        sa = np.full(BR * BAP, np.nan, F32)
                        sb = np.full(BQ * BR, np.nan, F32)
                        src = x[bb, c0:c0 + qlen, h] if fwd else \
                            dy[bb, c0:c0 + qlen, h]
                        for j in range(BQ):
                            v = np.zeros(BR, F32)
                            if j < qlen:
                                v[:hpl] = src[j, p0:p0 + hpl]
                                v = (v * scale[j]).astype(F32)
                            sa[np.arange(BR) * BAP + j] = v
                        rows = B if fwd else C
                        for j in range(BQ):
                            v = np.zeros(BR, F32)
                            if j < qlen:
                                v[:nsl] = rows[bb, c0 + j, grp, k0:k0 + nsl]
                            sb[j * BR:(j + 1) * BR] = v
                        acc = (acc * _exp0(clast)).astype(F32)
                        _mm(acc, sa, BAP, sb, BR, qlen, 4)
                        return acc

                    if ws is None:
                        acc = load(S0[bb, h])
                        for c in range(nc):
                            store(S_in[bb, c, h], acc)
                            acc = chunk_step(acc, c, True)
                    acc = load(dSf[bb, h])
                    for c in reversed(range(nc)):
                        store(dS_out[bb, c, h], acc)
                        acc = chunk_step(acc, c, False)
                    store(dS0[bb, h], acc)

    # ---- (b) ssd_chunk_bwd -------------------------------------------------
    hp16, n16 = _r16(hp), _r16(n)
    for bb in range(b):
        for h in range(nh):
            grp = h // hpg
            for c in range(nc):
                c0 = c * Q
                qlen = min(Q, L - c0)
                nb = -(-qlen // BR)
                dts, cum = _chunk_cum(dt, A, bb, h, c0, qlen)
                clast = cum[BQ - 1]
                ecum, edec = _exp0(cum), _exp0(clast - cum)
                rowdot, coldot, vv, ddtd = ({} for _ in range(4))
                sin, dso = S_in[bb, c, h], dS_out[bb, c, h]
                k2 = np.zeros(BTHREADS, F32)
                flat_s, flat_d = sin.reshape(-1), dso.reshape(-1)
                for t in range(BTHREADS):
                    for e in range(t, hp * n, BTHREADS):
                        k2[t] = _fma(flat_d[e], flat_s[e], k2[t])
                xr = x[bb, c0:c0 + qlen, h]
                dyr = dy[bb, c0:c0 + qlen, h]
                Br, Cr = B[bb, c0:c0 + qlen, grp], C[bb, c0:c0 + qlen, grp]

                dg = np.full(BR, np.nan, F32)

                def sub_block(sacc, rb, cb, lower, split=True):
                    """The masked, decayed sub-block; on the diagonal (in
                    passes D and E) its diagonal goes to dg and is 0 in the
                    block."""
                    ss = np.full(BR * (BR + 1), np.nan, F32)
                    for q in range(4):
                        for e in range(4):
                            col = C0 + 16 * q + e
                            i = rb + ROW if lower else cb + col
                            j = cb + col if lower else rb + ROW
                            valid = (i < qlen) & (j <= i)
                            ic, jc = np.minimum(i, BQ - 1), np.minimum(j,
                                                                       BQ - 1)
                            v = np.where(valid, (sacc[:, q, e] * _exp0(
                                cum[ic] - cum[jc])).astype(F32), F32(0))
                            on = (col == ROW) & (rb == cb) & split
                            dg[ROW[on]] = v[on]
                            ss[ROW * (BR + 1) + col] = np.where(on, F32(0),
                                                                v)
                    return ss

                # pass D: dC rows
                sb1 = np.full(BK * BK, np.nan, F32)
                _stage_rows(sb1, n16, sin, hp, hp, n, n16)
                for ib in range(nb):
                    rb = ib * BR
                    sa = np.full(BR * BAP, np.nan, F32)
                    _stage_rows(sa, BAP, dyr[rb:], BR, qlen - rb, hp,
                                hp)
                    acc = np.zeros((BTHREADS, 8, 4), F32)
                    _mm(acc, sa, BAP, sb1, n16, hp, n16 // 16)
                    acc = (acc * ecum[np.minimum(rb + ROW, BQ - 1)][:, None,
                                                                    None]
                           ).astype(F32)
                    for jb in range(ib + 1):
                        cb = jb * BR
                        sb2 = np.full(BK * BTP, np.nan, F32)
                        sb3 = np.full(BR * BK, np.nan, F32)
                        _stage_cols(sb2, xr[cb:], qlen - cb, hp, hp,
                                    dts[cb:])
                        _stage_rows(sb3, n16, Br[cb:], BR, qlen - cb,
                                    n, n16)
                        sacc = np.zeros((BTHREADS, 4, 4), F32)
                        _mm(sacc, sa, BAP, sb2, BTP, hp, 4)
                        ss = sub_block(sacc, rb, cb, True)
                        _mm(acc, ss, BR + 1, sb3, n16, BR, n16 // 16)
                    part = np.zeros(BTHREADS, F32)
                    i = rb + ROW
                    for q in range(8):
                        for e in range(4):
                            k = C0 + 16 * q + e
                            m = (i < qlen) & (k < n)
                            part[m] = _fma(Cr[i[m], k[m]], acc[m, q, e],
                                           part[m])
                            pdC[bb, c0 + i[m], h, k[m]] = _fma(
                                dg[ROW[m]], Br[i[m], k[m]], acc[m, q, e])
                    rowdot.update(_rowsum(part, rb, qlen))
                # pass E: dB rows
                _stage_rows(sb1, n16, dso, hp, hp, n, n16)
                for jb in range(nb):
                    rb = jb * BR
                    sa = np.full(BR * BAP, np.nan, F32)
                    _stage_rows(sa, BAP, xr[rb:], BR, qlen - rb, hp,
                                hp, dts[rb:])
                    acc = np.zeros((BTHREADS, 8, 4), F32)
                    _mm(acc, sa, BAP, sb1, n16, hp, n16 // 16)
                    j = rb + ROW
                    part = np.zeros(BTHREADS, F32)
                    for q in range(8):
                        for e in range(4):
                            k = C0 + 16 * q + e
                            acc[:, q, e] = (acc[:, q, e] * edec[
                                np.minimum(j, BQ - 1)]).astype(F32)
                            m = (j < qlen) & (k < n)
                            part[m] = _fma(Br[j[m], k[m]], acc[m, q, e],
                                           part[m])
                    vv.update(_rowsum(part, rb, qlen))
                    for ib in range(jb, nb):
                        cb = ib * BR
                        sb2 = np.full(BK * BTP, np.nan, F32)
                        sb3 = np.full(BR * BK, np.nan, F32)
                        _stage_cols(sb2, dyr[cb:], qlen - cb, hp, hp)
                        _stage_rows(sb3, n16, Cr[cb:], BR, qlen - cb,
                                    n, n16)
                        sacc = np.zeros((BTHREADS, 4, 4), F32)
                        _mm(sacc, sa, BAP, sb2, BTP, hp, 4)
                        ss = sub_block(sacc, rb, cb, False)
                        _mm(acc, ss, BR + 1, sb3, n16, BR, n16 // 16)
                    part = np.zeros(BTHREADS, F32)
                    for q in range(8):
                        for e in range(4):
                            k = C0 + 16 * q + e
                            m = (j < qlen) & (k < n)
                            part[m] = _fma(Br[j[m], k[m]], acc[m, q, e],
                                           part[m])
                            pdB[bb, c0 + j[m], h, k[m]] = _fma(
                                dg[ROW[m]], Cr[j[m], k[m]], acc[m, q, e])
                    coldot.update(_rowsum(part, rb, qlen))
                # pass X: dxdt rows
                sb1 = np.full(BK * BK, np.nan, F32)
                for p in range(hp16):
                    for k in range(n16):
                        sb1[k * hp16 + p] = dso[p, k] if (p < hp and k < n) \
                            else 0.0
                for jb in range(nb):
                    rb = jb * BR
                    sa = np.full(BR * BAP, np.nan, F32)
                    _stage_rows(sa, BAP, Br[rb:], BR, qlen - rb, n, n)
                    acc = np.zeros((BTHREADS, 8, 4), F32)
                    _mm(acc, sa, BAP, sb1, hp16, n, hp16 // 16)
                    j = rb + ROW
                    acc = (acc * edec[np.minimum(j, BQ - 1)][:, None, None]
                           ).astype(F32)
                    for ib in range(jb, nb):
                        cb = ib * BR
                        sb2 = np.full(BK * BTP, np.nan, F32)
                        sb3 = np.full(BR * BK, np.nan, F32)
                        _stage_cols(sb2, Cr[cb:], qlen - cb, n, n)
                        _stage_rows(sb3, hp16, dyr[cb:], BR,
                                    qlen - cb, hp, hp16)
                        sacc = np.zeros((BTHREADS, 4, 4), F32)
                        _mm(sacc, sa, BAP, sb2, BTP, n, 4)
                        ss = sub_block(sacc, rb, cb, False, split=False)
                        _mm(acc, ss, BR + 1, sb3, hp16, BR, hp16 // 16)
                    part = np.zeros(BTHREADS, F32)
                    dj = dts[np.minimum(j, BQ - 1)]
                    for q in range(8):
                        for e in range(4):
                            p = C0 + 16 * q + e
                            m = (j < qlen) & (p < hp)
                            dx[bb, c0 + j[m], h, p[m]] = \
                                (dj[m] * acc[m, q, e]).astype(F32)
                            part[m] = _fma(xr[j[m], p[m]], acc[m, q, e],
                                           part[m])
                    ddtd.update(_rowsum(part, rb, qlen))
                # thread 0: K, dcum's reverse sum, ddt and the share of dA
                kk = F32(0)
                for t in range(BTHREADS):
                    kk = F32(kk + k2[t])
                kk = F32(kk * _exp0(clast))
                for j in range(qlen):
                    kk = F32(kk + vv[j])
                run, da = F32(0), F32(0)
                for i in reversed(range(BQ)):
                    d = F32(rowdot[i] - coldot[i]) if i < qlen else F32(0)
                    run = F32(run + F32(d + (kk if i == BQ - 1 else F32(0))))
                    if i < qlen:
                        ddt[bb, c0 + i, h] = _fma(F32(A[h]), run, ddtd[i])
                    da = _fma(dts[i], run, da)
                pdA[bb, c, h] = da

    # ---- (c) ssd_bc_reduce -------------------------------------------------
    dB = np.zeros((b, L, G, n), F32)
    dC = np.zeros((b, L, G, n), F32)
    for j in range(hpg):
        dB = (dB + pdB.reshape(b, L, G, hpg, n)[:, :, :, j]).astype(F32)
        dC = (dC + pdC.reshape(b, L, G, hpg, n)[:, :, :, j]).astype(F32)
    dA = np.zeros(nh, F32)
    for bb in range(b):
        for c in range(nc):
            dA = (dA + pdA[bb, c]).astype(F32)
    return dx, ddt, dA, dB, dC, dS0


def _bwd_case(seed, b, l, nh, hp, g, n, dtype=F32):
    """The forward's inputs (``_case``: x, B and C bf16 values when
    ``dtype`` is bf16's stand-in) with nonzero S0, and the cotangents of y
    and S_final."""
    rng = np.random.default_rng(seed + 1)
    case = list(_case(seed, b, l, nh, hp, g, n))
    if dtype is F32:
        for i in (0, 3, 4):
            case[i] = rng.standard_normal(case[i].shape).astype(F32)
    dy = rng.standard_normal((b, l, nh, hp)).astype(F32)
    dSf = rng.standard_normal((b, nh, hp, n)).astype(F32)
    return case, dy, dSf


def _plain_bwd(case, dy, dSf, chunk, dtype=torch.float32):
    out = SC.ssd_chunk_bwd_ref(
        *(torch.from_numpy(a).to(dtype) for a in list(case) + [dy, dSf]),
        chunk)
    return [t.numpy() for t in out]


#: of each gradient's largest magnitude: f32 sums in another order; dA
#: (5e-5) sums every step's share, with cancellation
BWD_REL = (1e-5, 1e-5, 5e-5, 1e-5, 1e-5, 1e-5)


def _assert_grads_close(got, want):
    for g_, w_, rel in zip(got, want, BWD_REL):
        assert np.isfinite(g_).all()
        scale = max(float(np.abs(w_).max()), 1e-30)
        assert float(np.abs(g_ - w_).max()) <= rel * scale


@pytest.mark.parametrize("b,l,nh,hp,g,n,chunk", [
    (2, 37, 4, 16, 1, 16, 16),      # smoke widths, a ragged last chunk
    (1, 10, 2, 8, 2, 8, 16),        # l below the chunk, g 2
    (1, 150, 2, 12, 1, 20, 128),    # two 64-row sub-blocks, 22 rows last
    (1, 70, 2, 72, 1, 24, 64),      # hp 72: two state tiles' rows
])
def test_bwd_transliteration_matches_the_plain_backward(b, l, nh, hp, g, n,
                                                        chunk):
    """The three backward kernels' order (the states' reverse walk with
    the f32 route's recompute, the chunk kernel's passes D, E, X over
    64-row sub-blocks, the fixed-order sums) equal the plain backward."""
    case, dy, dSf = _bwd_case(l * 7 + hp, b, l, nh, hp, g, n)
    _assert_grads_close(bwd_transliteration(*case, dy, dSf, chunk),
                        _plain_bwd(case, dy, dSf, chunk))


def test_bwd_transliteration_reads_the_forward_workspace():
    """The bf16 route: S_in from the forward's workspace (here the
    recompute's), not recomputed, gives the same gradients."""
    case, dy, dSf = _bwd_case(3, 1, 40, 2, 8, 1, 8)
    x, dt, A, B, C, S0 = case
    Q, nc = 16, 3
    ws = np.empty((1, nc, 2, 8, 8), F32)
    S = torch.from_numpy(S0)
    for c in range(nc):
        ws[:, c] = S.numpy()
        sl = slice(c * Q, min((c + 1) * Q, 40))
        _, S = SC.ssd_chunk_ref(*(torch.from_numpy(np.ascontiguousarray(
            a[:, sl])) for a in (x, dt)), torch.from_numpy(A),
            *(torch.from_numpy(np.ascontiguousarray(a[:, sl]))
              for a in (B, C)), S, Q)
    _assert_grads_close(bwd_transliteration(*case, dy, dSf, Q, ws=ws),
                        _plain_bwd(case, dy, dSf, Q))


def test_bwd_transliteration_is_finite_at_a_large_decay_span():
    """A chunk's decay span past 88 (dt 0.7, A down to -64, Q 128): every
    exponent the kernels form is clamped at 0, so every gradient is finite
    and equals the plain backward evaluated in f64. (The f32 plain
    version's dA is 6.5e-5 of its largest magnitude off that here: cum
    reaches -90, where an f32 ulp is 8e-6; the kernels' dcum keeps the
    diagonal term, which the row and column dots share, out of both.)"""
    case, dy, dSf = _bwd_case(11, 1, 130, 2, 8, 1, 8)
    case[1][:] = 0.7
    case[2][:] = [-1.0, -64.0]
    got = bwd_transliteration(*case, dy, dSf, 128)
    _assert_grads_close(got, _plain_bwd(case, dy, dSf, 128, torch.float64))


def test_bwd_transliteration_rows_do_not_depend_on_b():
    """Row 1 of a b-2 call's gradients equal the same row alone, bit for
    bit (dA aside: it sums the rows)."""
    case, dy, dSf = _bwd_case(5, 2, 20, 2, 8, 1, 8)
    both = bwd_transliteration(*case, dy, dSf, 16)
    one = bwd_transliteration(*[a[1:] if a.ndim > 1 else a for a in case],
                              dy[1:], dSf[1:], 16)
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(both[i][1:], one[i])


# ---------------------------------------------------------------------------
# the backward's tensor-core route (bf16 inputs, hp <= 64): namespace tc of
# ssd_chunk_bwd.cu (states_bwd, chunk_bwd), then ssd_bc_reduce over the
# slices' shares, transliterated warp by warp on NaN-filled shared memory
# with the ldmatrix lane addresses and m16n8k16 fragment layouts
# ---------------------------------------------------------------------------

TP = _bconst("kP")
assert SC.TC_HEAD_BWD == TP               # the wrapper's route choice
TSLICE, TSW = _bconst("kSliceHeads"), _bconst("kSW")
for _line in ("constexpr int kCP = kK + 8;", "constexpr int kXP = kP + 8;",
              "constexpr int kSWP = kSW + 8;",
              "constexpr int kDYP = kSW + 4;"):
    assert _line in _BSRC
TCP, TXP, TSWP, TDYP = BK + 8, TP + 8, TSW + 8, TSW + 4
TRB = BQ // 16
TILES = [(ib, jb) for ib in range(TRB) for jb in range(ib + 1)]   # tile t
PKA = ((LM >> 1) | ((LM & 1) << 1)) * 64 + LR * 8   # A of a packed tile
PKT = LM * 64 + LR * 8                              # A of its transpose


def _tid(ib, jb):
    return ib * (ib + 1) // 2 + jb


def _arow(r, pitch):
    """A fragment rows 16 r .. of a [rows][k] tile (plain ldmatrix)."""
    return (16 * r + LR + (LM & 1) * 8) * pitch + (LM >> 1) * 8


def _nt(pitch):
    """B fragment of a [n][k] tile (plain ldmatrix)."""
    return (LR + (LM >> 1) * 8) * pitch + (LM & 1) * 8


def _tr(pitch):
    """B fragment of a [k][n] tile (ldmatrix.trans)."""
    return (LR + (LM & 1) * 8) * pitch + (LM >> 1) * 8


def _quad_sum(v):
    """quad_sum: + lane ^ 1, then + lane ^ 2."""
    v = (v + v[LANES ^ 1]).astype(F32)
    return (v + v[LANES ^ 2]).astype(F32)


def _mma_pair(acc, t, a, bf):
    """The two n8 tiles of a B fragment pair: acc[t] from regs 0, 1 and
    acc[t + 1] from regs 2, 3."""
    _mma(acc[t], a, bf[:, 0], bf[:, 1])
    _mma(acc[t + 1], a, bf[:, 2], bf[:, 3])


def _stage_split(hi, lo, pitch, src, rows, valid_rows, width, cols, split,
                 scale=None):
    """stage_split: rows of src (2-d) times scale[r], split hi + lo into the
    two tiles at the pitch; zeros past (valid_rows, cols)."""
    for r in range(rows):
        v = np.zeros(width, F32)
        if r < valid_rows:
            v[:cols] = src[r, :cols]
            if scale is not None:
                v = (v * scale[r]).astype(F32)
        h, lw = split(v)
        hi[r * pitch:r * pitch + width] = h
        lo[r * pitch:r * pitch + width] = lw


def _slice_heads(nh, g):
    """slice_heads: the largest power of two <= kSliceHeads dividing a
    group's heads."""
    hs = TSLICE
    while (nh // g) % hs:
        hs //= 2
    return hs


def tc_bwd_transliteration(x, dt, A, B, C, S0, dy, dSf, chunk, ws=None,
                           hs=None, split=_split, split_dy=None,
                           stats=None):
    """(dx, ddt, dA, dB, dC, dS0) as the tensor-core route computes them,
    dx, dB and dC before their bf16 rounding. ``ws`` is the forward's
    workspace; without it the forward's kernels recompute it (the
    wrapper's recompute). ``split`` splits the f32 operands, ``split_dy``
    (default ``split``) those made from dy. ``stats`` counts the score
    tiles of C·B^T made, and the blocks."""
    split_dy = split_dy or split
    b, L, nh, hp = x.shape
    Gn, n = B.shape[2], B.shape[3]
    assert hp <= TP
    Q = min(chunk, L)
    nc, hpg = -(-L // Q), nh // Gn
    hs = hs or _slice_heads(nh, Gn)
    nsh = nh // hs
    if ws is None:
        ws = tc_transliteration(x, dt, A, B, C, S0, chunk, return_ws=True)[2]
    dS_out = np.full((b, nc, nh, hp, n), np.nan, F32)
    dS0 = np.full((b, nh, hp, n), np.nan, F32)

    # ---- states_bwd: dS carried from the last chunk in the accumulators --
    for bb in range(b):
        for h in range(nh):
            grp = h // hpg
            for k0 in range(0, n, TSW):
                nsl = min(TSW, n - k0)

                def cells(wm, wn, t, q):
                    p = 16 * wm + G + (q >> 1) * 8
                    k = 32 * wn + 8 * t + 2 * TG + (q & 1)
                    return p, k, (p < hp) & (k < nsl)

                def state_io(acc, wm, wn, get=None, put=None):
                    for t in range(4):
                        for q in range(4):
                            p, k, ok = cells(wm, wn, t, q)
                            if get is not None:
                                acc[t][ok, q] = get[p[ok], k0 + k[ok]]
                            else:
                                put[p[ok], k0 + k[ok]] = acc[t][ok, q]

                warps = [(w & 3, w >> 2) for w in range(8)]
                acc = {}
                for wm, wn in warps:
                    acc[wm, wn] = np.zeros((4, 32, 4), F32)
                    state_io(acc[wm, wn], wm, wn, get=dSf[bb, h])
                for c in reversed(range(nc)):
                    c0 = c * Q
                    qlen = min(Q, L - c0)
                    q16 = (qlen + 15) & ~15
                    cs = np.full(BQ * TSWP, np.nan, F32)
                    dys = np.full(BQ * TDYP, np.nan, F32)
                    _stage(cs, 0, TSWP, C[bb, c0:c0 + qlen, grp, k0:k0 + nsl],
                           q16, qlen, TSW, nsl)
                    _stage(dys, 0, TDYP, dy[bb, c0:c0 + qlen, h], q16, qlen,
                           TSW, hp)
                    _, cum = _chunk_cum(dt, A, bb, h, c0, qlen)
                    vh = np.full(BQ * TSWP, np.nan, F32)
                    vl = np.full(BQ * TSWP, np.nan, F32)
                    for j in range(q16):
                        hi, lo = split_dy((dys[j * TDYP:j * TDYP + TSW]
                                           * _exp0(cum[j])).astype(F32))
                        vh[j * TSWP:j * TSWP + TSW] = hi
                        vl[j * TSWP:j * TSWP + TSW] = lo
                    for wm, wn in warps:           # dS_out[c]
                        state_io(acc[wm, wn], wm, wn, put=dS_out[bb, c, h])
                    for wm, wn in warps:
                        acc[wm, wn] *= _exp0(cum[BQ - 1])
                        if 16 * wm >= hp or 32 * wn >= nsl:
                            continue
                        a_lane = ((LR + (LM >> 1) * 8) * TSWP + 16 * wm
                                  + (LM & 1) * 8)
                        b_lane = ((LR + (LM & 1) * 8) * TSWP + 32 * wn
                                  + (LM >> 1) * 8)
                        for ks in range(q16 // 16):
                            ah = _ldmatrix_x4(vh, a_lane + ks * 16 * TSWP,
                                              True)
                            al = _ldmatrix_x4(vl, a_lane + ks * 16 * TSWP,
                                              True)
                            for q in range(min(2, (nsl - 32 * wn + 15) // 16)):
                                bf = _ldmatrix_x4(
                                    cs, b_lane + ks * 16 * TSWP + 16 * q, True)
                                for a_ in (ah, al):
                                    _mma_pair(acc[wm, wn], 2 * q, a_, bf)
                for wm, wn in warps:
                    state_io(acc[wm, wn], wm, wn, put=dS0[bb, h])

    # ---- chunk_bwd: one block per (chunk, slice, batch row) ---------------
    dx = np.full(x.shape, np.nan, F32)
    ddt = np.full(dt.shape, np.nan, F32)
    pdB = np.full((b, L, nsh, n), np.nan, F32)
    pdC = np.full((b, L, nsh, n), np.nan, F32)
    pdA = np.full((b, nc, nh), np.nan, F32)
    nt_c, nt_x, tr_c, tr_x = _nt(TCP), _nt(TXP), _tr(TCP), _tr(TXP)
    ia_all = [16 * w + G for w in range(8)]
    for bb in range(b):
        for c in range(nc):
            for slc in range(nsh):
                h0 = slc * hs
                grp = h0 // hpg
                c0 = c * Q
                qlen = min(Q, L - c0)
                sC = np.full(BQ * TCP, np.nan, F32)
                sB = np.full(BQ * TCP, np.nan, F32)
                _stage(sC, 0, TCP, C[bb, c0:c0 + qlen, grp], BQ, qlen, BK, n)
                _stage(sB, 0, TCP, B[bb, c0:c0 + qlen, grp], BQ, qlen, BK, n)
                gt = []                            # C B^T, once a slice
                for ib, jb in TILES:
                    acc = np.zeros((2, 32, 4), F32)
                    for ks in range(BK // 16):
                        af = _ldmatrix_x4(sC, _arow(ib, TCP) + 16 * ks, False)
                        bf = _ldmatrix_x4(sB, nt_c + 16 * jb * TCP + 16 * ks,
                                          False)
                        _mma_pair(acc, 0, af, bf)
                    gt.append(acc)
                if stats is not None:
                    stats["G"] = stats.get("G", 0) + len(gt)
                    stats["blocks"] = stats.get("blocks", 0) + 1
                wsum = [np.zeros((2, 32, 4), F32) for _ in TILES]
                heads = []                        # dts, cum, dcum, x·dxdt, K
                for hh in range(hs):
                    h = h0 + hh
                    sX = np.full(BQ * TXP, np.nan, F32)
                    _stage(sX, 0, TXP, x[bb, c0:c0 + qlen, h], BQ, qlen, TP,
                           hp)
                    sDh, sDl = (np.full(BQ * TXP, np.nan, F32)
                                for _ in range(2))
                    _stage_split(sDh, sDl, TXP, dy[bb, c0:c0 + qlen, h], BQ,
                                 qlen, TP, hp, split_dy)
                    sSh, sSl = (np.full(TP * TCP, np.nan, F32)
                                for _ in range(2))
                    _stage_split(sSh, sSl, TCP, ws[bb, c, h], TP, hp, BK, n,
                                 split)
                    dts, cum = _chunk_cum(dt, A, bb, h, c0, qlen)
                    clast = cum[BQ - 1]
                    U = np.full(BQ, np.nan, F32)
                    V = np.full(BQ, np.nan, F32)

                    def state_product(a_src, a_row, w):
                        """[16 strip rows, kP] = A rows . S^T (S split)."""
                        acc = np.zeros((TP // 8, 32, 4), F32)
                        for ks in range(BK // 16):
                            af = _ldmatrix_x4(a_src, _arow(a_row, TCP)
                                              + 16 * ks, False)
                            for q in range(TP // 16):
                                off = 16 * q * TCP + 16 * ks
                                for s_ in (sSh, sSl):
                                    bf = _ldmatrix_x4(s_, nt_c + off, False)
                                    _mma(acc[2 * q], af, bf[:, 0], bf[:, 1])
                                for s_ in (sSh, sSl):
                                    bf = _ldmatrix_x4(s_, nt_c + off, False)
                                    _mma(acc[2 * q + 1], af, bf[:, 2],
                                         bf[:, 3])
                        return acc

                    def strip_dot(acc, w, rows_of):
                        """Each strip row's dot of the accumulators with a
                        row of `rows_of(i, p)`, fmaf in order, quad sum."""
                        ia = ia_all[w]
                        out = []
                        for rh in range(2):
                            i = ia + 8 * rh
                            v = np.zeros(32, F32)
                            for t in range(TP // 8):
                                p = 8 * t + 2 * TG
                                v = _fma(acc[t][:, 2 * rh], rows_of(i, p), v)
                                v = _fma(acc[t][:, 2 * rh + 1],
                                         rows_of(i, p + 1), v)
                            out.append(_quad_sum(v))
                        return out

                    def dy_at(i, p):
                        return (sDh[i * TXP + p]
                                + sDl[i * TXP + p]).astype(F32)

                    def x_at(i, p):
                        return sX[i * TXP + p]

                    for w in range(8):                # U from C S_in^T
                        z = state_product(sC, w, w)
                        ua, ub = strip_dot(z, w, dy_at)
                        ia = ia_all[w]
                        U[ia] = (_exp0(cum[ia]) * ua).astype(F32)
                        U[ia + 8] = (_exp0(cum[ia + 8]) * ub).astype(F32)
                    # dS_out over S_in; each thread's <dS_out, S_in> share
                    kpart = np.zeros(BTHREADS, F32)
                    for it in range(TP * (BK // 4) // BTHREADS):
                        e = TID + BTHREADS * it
                        r, c4 = e // (BK // 4), (e % (BK // 4)) * 4
                        for q in range(4):
                            ok = (r < hp) & (c4 + q < n)
                            rr, kk = np.minimum(r, hp - 1), np.minimum(c4 + q,
                                                                       n - 1)
                            kpart = np.where(ok, _fma(
                                dS_out[bb, c, h][rr, kk], ws[bb, c, h][rr, kk],
                                kpart), kpart)
                    sSh[:], sSl[:] = np.nan, np.nan
                    _stage_split(sSh, sSl, TCP, dS_out[bb, c, h], TP, hp, BK,
                                 n, split)
                    dxa = []
                    for w in range(8):                # dxdt's state term
                        acc = state_product(sB, w, w)
                        ia = ia_all[w]
                        acc[:, :, 0:2] *= _exp0(clast - cum[ia])[None, :, None]
                        acc[:, :, 2:4] *= _exp0(clast - cum[ia + 8])[None, :,
                                                                     None]
                        va, vb = strip_dot(acc, w, x_at)
                        V[ia] = (dts[ia] * va).astype(F32)
                        V[ia + 8] = (dts[ia + 8] * vb).astype(F32)
                        dxa.append(acc)
                    # the score tiles
                    rowp = np.full((len(TILES), 16), np.nan, F32)
                    colp = np.full((len(TILES), 16), np.nan, F32)
                    sMh = np.full(len(TILES) * 256, np.nan, F32)
                    sMl = np.full(len(TILES) * 256, np.nan, F32)
                    for t, (ib, jb) in enumerate(TILES):
                        ra = np.zeros((2, 32, 4), F32)
                        for ks in range(TP // 16):
                            bf = _ldmatrix_x4(sX, nt_x + 16 * jb * TXP
                                              + 16 * ks, False)
                            ah = _ldmatrix_x4(sDh, _arow(ib, TXP) + 16 * ks,
                                              False)
                            al = _ldmatrix_x4(sDl, _arow(ib, TXP) + 16 * ks,
                                              False)
                            _mma(ra[0], ah, bf[:, 0], bf[:, 1])
                            _mma(ra[0], al, bf[:, 0], bf[:, 1])
                            _mma(ra[1], ah, bf[:, 2], bf[:, 3])
                            _mma(ra[1], al, bf[:, 2], bf[:, 3])
                        rp = np.zeros((2, 32), F32)
                        cp = np.zeros((2, 2, 32), F32)
                        for t2 in range(2):
                            for rh in range(2):
                                i = 16 * ib + G + 8 * rh
                                mv = []
                                for e in range(2):
                                    q = 2 * rh + e
                                    j = 16 * jb + 8 * t2 + 2 * TG + e
                                    ok = (j <= i) & (i < qlen)
                                    Lv = np.where(ok, _exp0(cum[i] - cum[j]),
                                                  F32(0))
                                    wv = ((ra[t2][:, q] * dts[j]).astype(F32)
                                          * Lv).astype(F32)
                                    tt = np.where(i == j, F32(0),
                                                  gt[t][t2][:, q] * wv)
                                    mv.append((gt[t][t2][:, q] * Lv).astype(
                                        F32))
                                    rp[rh] = (rp[rh] + tt).astype(F32)
                                    cp[t2, e] = (cp[t2, e] + tt).astype(F32)
                                    wsum[t][t2][:, q] += wv
                                off = t * 256 + (2 * rh + t2) * 64 + G * 8 \
                                    + 2 * TG
                                for e in range(2):
                                    sMh[off + e], sMl[off + e] = split(mv[e])
                        first = TG == 0
                        rowp[t, G[first]] = _quad_sum(rp[0])[first]
                        rowp[t, G[first] + 8] = _quad_sum(rp[1])[first]
                        for t2 in range(2):
                            for e in range(2):
                                v = cp[t2, e]
                                for o in (4, 8, 16):
                                    v = (v + v[LANES ^ o]).astype(F32)
                                col = 8 * t2 + 2 * TG + e
                                colp[t, col[G == 0]] = v[G == 0]
                    dcum = np.zeros(BQ, F32)
                    for i in range(BQ):               # threads 0-127
                        rb, rr = i >> 4, i & 15
                        rs = cs_ = F32(0)
                        for jb in range(rb + 1):
                            rs = F32(rs + rowp[_tid(rb, jb), rr])
                        for i2 in range(rb, TRB):
                            cs_ = F32(cs_ + colp[_tid(i2, rb), rr])
                        dcum[i] = F32(F32(rs - cs_) + F32(U[i] - V[i]))
                    kd = np.zeros(32, F32)            # warp 7: K
                    vs = np.zeros(32, F32)
                    for e in range(BTHREADS // 32):
                        kd = (kd + kpart[LANES * 8 + e]).astype(F32)
                    for e in range(BQ // 32):
                        j = LANES * 4 + e
                        vs = np.where(j < qlen, vs + V[j], vs).astype(F32)
                    for o in (16, 8, 4, 2, 1):
                        kd = (kd + kd[LANES ^ o]).astype(F32)
                        vs = (vs + vs[LANES ^ o]).astype(F32)
                    K = F32(F32(kd[0] * _exp0(clast)) + vs[0])
                    ddtd = np.zeros(BQ, F32)
                    for w in range(8):                # dxdt += M^T dy
                        acc = dxa[w]
                        for ib in range(w, TRB):
                            t = _tid(ib, w)
                            ah = _ldmatrix_x4(sMh, t * 256 + PKT, True)
                            al = _ldmatrix_x4(sMl, t * 256 + PKT, True)
                            for q in range(TP // 16):
                                off = 16 * ib * TXP + 16 * q
                                bh = _ldmatrix_x4(sDh, tr_x + off, True)
                                bl = _ldmatrix_x4(sDl, tr_x + off, True)
                                for t_, r0, r1 in ((2 * q, 0, 1),
                                                   (2 * q + 1, 2, 3)):
                                    _mma(acc[t_], ah, bh[:, r0], bh[:, r1])
                                    _mma(acc[t_], al, bh[:, r0], bh[:, r1])
                                    _mma(acc[t_], ah, bl[:, r0], bl[:, r1])
                        pa, pb = strip_dot(acc, w, x_at)
                        ia = ia_all[w]
                        ddtd[ia], ddtd[ia + 8] = pa, pb
                        for t in range(TP // 8):
                            for rh in range(2):
                                j = ia + 8 * rh
                                for e in range(2):
                                    p = 8 * t + 2 * TG + e
                                    m = (j < qlen) & (p < hp)
                                    dx[bb, c0 + j[m], h, p[m]] = (
                                        dts[j[m]] * acc[t][m, 2 * rh + e]
                                    ).astype(F32)
                    heads.append((dts, cum, dcum, ddtd, K))
                # the slice's W into the packed tiles
                sMh = np.full(len(TILES) * 256, np.nan, F32)
                sMl = np.full(len(TILES) * 256, np.nan, F32)
                for t in range(len(TILES)):
                    for t2 in range(2):
                        for rh in range(2):
                            off = t * 256 + (2 * rh + t2) * 64 + G * 8 + 2 * TG
                            for e in range(2):
                                sMh[off + e], sMl[off + e] = split(
                                    wsum[t][t2][:, 2 * rh + e])
                for dc in (True, False):             # dC, then dB
                    accs = [np.zeros((BK // 8, 32, 4), F32) for _ in range(8)]
                    for hh in range(hs):
                        h = h0 + hh
                        dts, cum = heads[hh][:2]
                        sDh, sDl = (np.full(BQ * TXP, np.nan, F32)
                                    for _ in range(2))
                        if dc:
                            _stage_split(sDh, sDl, TXP,
                                         dy[bb, c0:c0 + qlen, h], BQ, qlen,
                                         TP, hp, split_dy, _exp0(cum))
                        else:
                            _stage_split(sDh, sDl, TXP, x[bb, c0:c0 + qlen, h],
                                         BQ, qlen, TP, hp, split,
                                         (_exp0(cum[BQ - 1] - cum) * dts
                                          ).astype(F32))
                        sSh, sSl = (np.full(TP * TCP, np.nan, F32)
                                    for _ in range(2))
                        _stage_split(sSh, sSl, TCP,
                                     (ws if dc else dS_out)[bb, c, h], TP, hp,
                                     BK, n, split)
                        for w in range(8):
                            acc = accs[w]
                            if hh == 0:               # W B or W^T C
                                for kb in (range(w + 1) if dc
                                           else range(w, TRB)):
                                    t = _tid(w, kb) if dc else _tid(kb, w)
                                    lane = PKA if dc else PKT
                                    ah = _ldmatrix_x4(sMh, t * 256 + lane,
                                                      not dc)
                                    al = _ldmatrix_x4(sMl, t * 256 + lane,
                                                      not dc)
                                    for q in range(BK // 16):
                                        bf = _ldmatrix_x4(
                                            sB if dc else sC,
                                            tr_c + 16 * kb * TCP + 16 * q,
                                            True)
                                        _mma_pair(acc, 2 * q, ah, bf)
                                        _mma_pair(acc, 2 * q, al, bf)
                            for ks in range(TP // 16):   # the state term
                                ah = _ldmatrix_x4(sDh, _arow(w, TXP) + 16 * ks,
                                                  False)
                                al = _ldmatrix_x4(sDl, _arow(w, TXP) + 16 * ks,
                                                  False)
                                for q in range(BK // 16):
                                    off = 16 * ks * TCP + 16 * q
                                    bh = _ldmatrix_x4(sSh, tr_c + off, True)
                                    bl = _ldmatrix_x4(sSl, tr_c + off, True)
                                    for t_, r0, r1 in ((2 * q, 0, 1),
                                                       (2 * q + 1, 2, 3)):
                                        _mma(acc[t_], ah, bh[:, r0], bh[:, r1])
                                        _mma(acc[t_], al, bh[:, r0], bh[:, r1])
                                        _mma(acc[t_], ah, bl[:, r0], bl[:, r1])
                    out = pdC if dc else pdB
                    for w in range(8):
                        for t in range(BK // 8):
                            for rh in range(2):
                                i = ia_all[w] + 8 * rh
                                for e in range(2):
                                    k = 8 * t + 2 * TG + e
                                    m = (i < qlen) & (k < n)
                                    out[bb, c0 + i[m], slc, k[m]] = \
                                        accs[w][t][m, 2 * rh + e]
                for hh in range(hs):                 # thread hh
                    h = h0 + hh
                    dts, cum, dcum, ddtd, K = heads[hh]
                    run, da = F32(0), F32(0)
                    for i in reversed(range(BQ)):
                        d = dcum[i] if i < qlen else F32(0)
                        d = F32(d + (K if i == BQ - 1 else F32(0)))
                        run = F32(run + d)
                        if i < qlen:
                            ddt[bb, c0 + i, h] = F32(ddtd[i] + F32(A[h] * run))
                        da = _fma(dts[i], run, da)
                    pdA[bb, c, h] = da

    # ---- ssd_bc_reduce: the group's shares in order -----------------------
    spg = nsh // Gn
    dB = np.zeros((b, L, Gn, n), F32)
    dC = np.zeros((b, L, Gn, n), F32)
    for j in range(spg):
        dB = (dB + pdB.reshape(b, L, Gn, spg, n)[:, :, :, j]).astype(F32)
        dC = (dC + pdC.reshape(b, L, Gn, spg, n)[:, :, :, j]).astype(F32)
    dA = np.zeros(nh, F32)
    for bb in range(b):
        for c in range(nc):
            dA = (dA + pdA[bb, c]).astype(F32)
    return dx, ddt, dA, dB, dC, dS0


#: the card's tolerances (chip_smoke.py: SSD_BWD_TOL, SSD_BWD_DA) on the
#: route's f32 values, dx, dB and dC before their bf16 rounding
TC_REL = (1e-4, 1e-4, 2e-4, 1e-4, 1e-4, 1e-4)


def _assert_tc_close(got, want, rel=TC_REL):
    for g_, w_, r in zip(got, want, rel):
        assert np.isfinite(g_).all()
        scale = max(float(np.abs(w_).max()), 1e-30)
        assert float(np.abs(g_ - w_).max()) <= r * scale


def _tc_case(seed, b, l, nh, hp, g, n):
    """The bf16 route's inputs: x, B, C bf16 values, nonzero S0, dy and
    dS_final."""
    return _bwd_case(seed, b, l, nh, hp, g, n, dtype=None)


@pytest.mark.parametrize("b,l,nh,hp,g,n,chunk", [
    (2, 21, 4, 16, 1, 16, 16),      # smoke widths, a ragged last chunk
    (1, 10, 4, 8, 2, 8, 16),        # l below the chunk, g 2: slices of 2
    (1, 150, 4, 40, 1, 24, 128),    # hp, n off 16; 22 rows in chunk 2
    (1, 130, 8, 64, 1, 128, 128),   # mamba2-1.3b's widths, two slices
])
def test_tc_bwd_transliteration_matches_the_plain_backward(b, l, nh, hp, g,
                                                           n, chunk):
    """The tensor-core route (the states' reverse walk in the mma
    accumulators; per slice C·B^T once, each head's scores, U, V, dxdt,
    the slice's W and its dC, dB sums in head order; the shares summed
    in order) equals the plain backward, on the forward's workspace as
    its transliteration leaves it."""
    case, dy, dSf = _tc_case(l * 5 + hp, b, l, nh, hp, g, n)
    ws = tc_transliteration(*case, chunk, return_ws=True)[2]
    _assert_tc_close(tc_bwd_transliteration(*case, dy, dSf, chunk, ws=ws),
                     _plain_bwd(case, dy, dSf, chunk))


def test_tc_bwd_transliteration_recomputes_the_states_without_ws():
    """ws=None: the forward's ssd_states recomputes the states entering
    each chunk (the wrapper runs the forward's kernels), and the gradients
    are those with the workspace kept."""
    case, dy, dSf = _tc_case(21, 1, 20, 4, 8, 1, 8)
    ws = tc_transliteration(*case, 16, return_ws=True)[2]
    got = tc_bwd_transliteration(*case, dy, dSf, 16)
    kept = tc_bwd_transliteration(*case, dy, dSf, 16, ws=ws)
    for a_, k_ in zip(got, kept):
        np.testing.assert_array_equal(a_, k_)
    _assert_tc_close(got, _plain_bwd(case, dy, dSf, 16))


@pytest.mark.parametrize("hs", [1, 2, 4])
def test_tc_bwd_slices_make_cb_once_and_sum_heads_in_order(hs):
    """A block takes hs heads of one group: C·B^T's 36 tiles are made once
    a block (not once a head), the shares are nh / hs, and every slicing
    gives the plain backward."""
    case, dy, dSf = _tc_case(31, 1, 13, 4, 8, 1, 8)
    stats = {}
    got = tc_bwd_transliteration(*case, dy, dSf, 16, hs=hs, stats=stats)
    assert stats["blocks"] == 4 // hs               # one chunk, 4 heads
    assert stats["G"] == len(TILES) * stats["blocks"]
    _assert_tc_close(got, _plain_bwd(case, dy, dSf, 16))
    assert _slice_heads(64, 1) == TSLICE == 8       # mamba2: 256 blocks
    assert _slice_heads(6, 1) == 2 and _slice_heads(4, 2) == 2


def test_tc_bwd_one_bf16_rounding_of_dy_would_not_hold_the_tolerance():
    """Why dy is split: with every operand made from dy rounded once to
    bf16 (no lo half) the same case misses the tolerance the split
    keeps."""
    case, dy, dSf = _tc_case(41, 1, 64, 4, 16, 1, 16)

    def hi_only(v):
        hi = _bf16(v)
        return hi, np.zeros_like(hi)

    want = _plain_bwd(case, dy, dSf, 32)
    _assert_tc_close(tc_bwd_transliteration(*case, dy, dSf, 32), want)
    with pytest.raises(AssertionError):
        _assert_tc_close(tc_bwd_transliteration(*case, dy, dSf, 32,
                                                split_dy=hi_only), want)


def test_tc_bwd_transliteration_is_finite_at_a_large_decay_span():
    """A chunk's decay span past 88 (dt 0.7, A down to -64, Q 128): every
    exponent clamped at 0, every gradient finite and within the card's
    tolerances of the plain backward in f64."""
    case, dy, dSf = _tc_case(51, 1, 130, 2, 16, 1, 16)
    case[1][:] = 0.7
    case[2][:] = [-1.0, -64.0]
    with np.errstate(over="ignore"):    # the forward's masked-after exp
        ws = tc_transliteration(*case, 128, return_ws=True)[2]
    _assert_tc_close(tc_bwd_transliteration(*case, dy, dSf, 128, ws=ws),
                     _plain_bwd(case, dy, dSf, 128, torch.float64))


def test_tc_bwd_transliteration_rows_do_not_depend_on_b():
    """Row 1 of a b-2 call's gradients equal the same row alone, bit for
    bit (dA aside)."""
    case, dy, dSf = _tc_case(61, 2, 20, 2, 8, 1, 8)
    both = tc_bwd_transliteration(*case, dy, dSf, 16)
    one = tc_bwd_transliteration(*[a[1:] if a.ndim > 1 else a for a in case],
                                 dy[1:], dSf[1:], 16)
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(both[i][1:], one[i])

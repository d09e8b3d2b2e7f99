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

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.ssd_chunk.ssd_chunk import ssd_chunk as pallas_ssd
from repro.models.ssd import _ssd_chunked
from repro_torch.configs import get_smoke_config
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


def tc_transliteration(x, dt, A, B, C, S0, chunk, split=_split):
    """(y, S_final) as the three kernels of the bf16 route compute them;
    ``split`` is the hi + lo split of the f32 operands."""
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
    return y, S_final


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

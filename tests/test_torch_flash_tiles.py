"""The bf16 route of ``flash_attention`` (``csrc/flash_attention.cu``,
namespace ``tc``), transliterated into numpy lane by lane and held to the
reference's jnp ``blocked_attention`` on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to its
plain version there). This transliteration follows its steps: the Q tile
and the two-stage K/V ring filled by 16-byte copies with zero-fill past
``sq`` and ``skv``; the loop bounds from the positions and the skip of
tiles with no valid key, decided by every warp's vote on key positions
read a tile ahead; the ldmatrix lane addresses (plain for Q and K,
``.trans`` for V) over rows padded by 16 bytes; the m16n8k16 A/B/C
fragment layouts, one m16 tile a warp; the online softmax in the
log2 domain (max on the unscaled scores, quad shuffles, an explicit zero
for masked entries, the warp's skip of the mask on wholly valid tiles,
the alpha rescale of O skipped when no row's max moved); P reused from
the S accumulators as the A operand; and the epilogue through the warp's
own rows of the Q buffer. The kernel loads fragments one step ahead of
their products; that changes when, not what, so the model loads each
where it is used. Shared memory starts as NaN and the key-position slots
as a poison value, so anything the kernel reads before writing it shows.
Values stay f32: this checks indexing, not bf16 rounding. Tolerance 1e-5
(f32 sums in another order than the reference's).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import attention as JA

TOL = dict(atol=1e-5, rtol=1e-5)
BK = 64                                   # keys per kv-tile
NEG_INF = np.float32(-1e30)
INT_MIN = np.iinfo(np.int32).min
POISON = INT_MIN + 7                      # an unwritten key-position slot
LOG2E = 1.4426950408889634

LANES = np.arange(32)
G, TG = LANES // 4, LANES % 4             # groupID, thread in group
LR, LM = LANES % 8, LANES // 8            # ldmatrix row, matrix


def _ldmatrix_x4(smem, addrs, trans):
    """ldmatrix.m8n8.x4: lane l supplies row l % 8 of matrix l // 8 (8
    elements from addrs[l]). Returns [32 lanes, 4 regs, 2 halves]."""
    rows = smem[addrs[:, None] + np.arange(8)]           # [32, 8]
    mats = rows.reshape(4, 8, 8)                         # [matrix, row, col]
    if trans:
        mats = mats.transpose(0, 2, 1)
    # lane T gets row T // 4, columns 2 (T % 4) + {0, 1} of each matrix
    return mats[:, G, :].reshape(4, 32, 4, 2)[:, LANES, TG].transpose(1, 0, 2)


def _mma(acc, a, b0, b1):
    """acc [32, 4] += A . B, with A [16, 16] and B [16, 8] gathered from
    the lanes' fragments as PTX's m16n8k16 layout places them."""
    A = np.empty((16, 16), np.float32)
    B = np.empty((16, 8), np.float32)
    for j in range(2):
        A[G, 2 * TG + j] = a[:, 0, j]
        A[G + 8, 2 * TG + j] = a[:, 1, j]
        A[G, 2 * TG + 8 + j] = a[:, 2, j]
        A[G + 8, 2 * TG + 8 + j] = a[:, 3, j]
        B[2 * TG + j, G] = b0[:, j]
        B[2 * TG + 8 + j, G] = b1[:, j]
    Dm = A @ B
    acc += np.stack([Dm[G, 2 * TG], Dm[G, 2 * TG + 1], Dm[G + 8, 2 * TG],
                     Dm[G + 8, 2 * TG + 1]], axis=1)


def _shfl_xor(x, mask):
    return x[LANES ^ mask]


WARPS = 4                                 # a block: 4 warps of 16 q rows


def tc_transliteration(q, k, v, qpos, kpos, causal):
    """out [b, sq, hq, d] as flash_tc_kernel<d> computes it, from f32
    q [b, sq, hq, d], k/v [b, skv, hkv, d] and int positions."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    BQ, P, CPR = 16 * WARPS, d + 8, d // 8
    NS, NO = BK // 8, d // 8
    Q_OFF, KV_OFF, TILE = 0, BQ * P, BK * P   # element offsets
    scale_log2 = np.float32(1.0 / math.sqrt(d) * LOG2E)
    out = np.full((b, sq, hq, d), np.nan, np.float32)
    nqt = -(-sq // BQ)

    def k_off(slot):
        return KV_OFF + 2 * slot * TILE

    def v_off(slot):
        return KV_OFF + (2 * slot + 1) * TILE

    for bb in range(b):
        for h in range(hq):
            for bx in range(nqt):
                q0 = (nqt - 1 - bx) * BQ
                smem = np.full(BQ * P + 4 * TILE, np.nan, np.float32)
                skpos = np.full((2, BK), POISON, np.int64)
                for i in range(BQ * CPR):        # the Q tile, zeros past sq
                    r, c = i // CPR, (i % CPR) * 8
                    dst = Q_OFF + r * P + c
                    smem[dst:dst + 8] = (q[bb, q0 + r, h, c:c + 8]
                                         if q0 + r < sq else 0.0)
                sqpos = np.array([qpos[q0 + i] if q0 + i < sq else INT_MIN
                                  for i in range(BQ)], np.int64)

                # kv_range: first and last key valid for any row
                qmax = sqpos.max()
                ok = (kpos >= 0) & ((kpos <= qmax) if causal else True)
                idx = np.nonzero(ok)[0]
                t_lo = idx[0] // BK if idx.size else 0
                t_hi = idx[-1] // BK + 1 if idx.size else 0

                # a lane's rows: G and G + 8 of the warp's, as qp[w][0, 1]
                qp = [[sqpos[w * 16 + 8 * i + G] for i in range(2)]
                      for w in range(WARPS)]
                wq_min = [min(x.min() for x in qw) for qw in qp]

                def load_kp(t):
                    """[2, 32]: keys lane and lane + 32 of tile t."""
                    keys = t * BK + np.stack([LANES, LANES + 32])
                    kp = np.full((2, 32), -1, np.int64)
                    ok = (keys < skv) & (t < t_hi)
                    kp[ok] = kpos[keys[ok]]
                    return kp

                def next_live(t, kp):
                    """every warp's vote: the first tile >= t with a key
                    valid for some row of the block, and its kp"""
                    while t < t_hi and not ((kp >= 0) & (
                            (kp <= qmax) if causal else True)).any():
                        t += 1
                        kp = load_kp(t)
                    return t, kp

                def write_kpos(slot, kp):           # warp 0
                    skpos[slot, LANES] = kp[0]
                    skpos[slot, LANES + 32] = kp[1]

                def load_kv(t, slot):
                    k0 = t * BK
                    for i in range(BK * CPR):
                        r, c = i // CPR, (i % CPR) * 8
                        okr = k0 + r < skv
                        dst = r * P + c
                        smem[k_off(slot) + dst:k_off(slot) + dst + 8] = (
                            k[bb, k0 + r, h // g, c:c + 8] if okr else 0.0)
                        smem[v_off(slot) + dst:v_off(slot) + dst + 8] = (
                            v[bb, k0 + r, h // g, c:c + 8] if okr else 0.0)

                t, kp_cur = next_live(t_lo, load_kp(t_lo))
                if t < t_hi:
                    load_kv(t, 0)
                    write_kpos(0, kp_cur)
                kp_nxt = load_kp(t + 1)

                k_lane = ((LM >> 1) * 8 + LR) * P + (LM & 1) * 8
                v_lane = ((LM & 1) * 8 + LR) * P + (LM >> 1) * 8

                # [w][kk]: Q's A fragments, kept for the whole loop
                qf = [[_ldmatrix_x4(
                    smem, Q_OFF + (w * 16 + (LM & 1) * 8 + LR) * P
                    + kk * 16 + (LM >> 1) * 8, False)
                    for kk in range(d // 16)] for w in range(WARPS)]
                o = [np.zeros((NO, 32, 4), np.float32) for _ in range(WARPS)]
                m = [np.full((2, 32), NEG_INF, np.float32)
                     for _ in range(WARPS)]
                l = [np.zeros((2, 32), np.float32) for _ in range(WARPS)]

                n = 0
                while t < t_hi:
                    slot = n & 1
                    t_next, kp_nxt = next_live(t + 1, kp_nxt)
                    if t_next < t_hi:
                        load_kv(t_next, slot ^ 1)
                        write_kpos(slot ^ 1, kp_nxt)
                    lo_k, hi_k = kp_cur.min(0), kp_cur.max(0)
                    kp_cur, kp_nxt = kp_nxt, load_kp(t_next + 1)
                    kp_s = skpos[slot]
                    assert (kp_s != POISON).all()
                    for w in range(WARPS):
                        s = np.zeros((NS, 32, 4), np.float32)
                        for kk in range(d // 16):
                            for np_ in range(NS // 2):
                                bk = _ldmatrix_x4(
                                    smem, k_off(slot) + k_lane
                                    + np_ * 16 * P + kk * 16, False)
                                _mma(s[2 * np_], qf[w][kk], bk[:, 0],
                                     bk[:, 1])
                                _mma(s[2 * np_ + 1], qf[w][kk], bk[:, 2],
                                     bk[:, 3])
                        full = ((lo_k >= 0) & ((hi_k <= wq_min[w])
                                               if causal else True)).all()
                        valid = np.ones((NS, 32, 4), bool)
                        if not full:
                            for j in range(NS):
                                for e in range(4):
                                    kpe = kp_s[j * 8 + 2 * TG + (e & 1)]
                                    valid[j, :, e] = (kpe >= 0) & (
                                        (kpe <= qp[w][e >> 1])
                                        if causal else True)
                        # the max on the unscaled scores, p one FFMA and
                        # one ex2
                        mx = np.full((2, 32), NEG_INF, np.float32)
                        for e in range(4):
                            r = e >> 1
                            mx[r] = np.maximum(mx[r], np.where(
                                valid[:, :, e], s[:, :, e], NEG_INF).max(0))
                        alpha = np.empty((2, 32), np.float32)
                        for r in range(2):
                            mx[r] = np.maximum(mx[r], _shfl_xor(mx[r], 1))
                            mx[r] = np.maximum(mx[r], _shfl_xor(mx[r], 2))
                            mxs = np.where(mx[r] == NEG_INF, NEG_INF,
                                           mx[r] * scale_log2)
                            m_new = np.maximum(m[w][r], mxs)
                            alpha[r] = np.exp2(m[w][r] - m_new)
                            m[w][r] = m_new
                            l[w][r] *= alpha[r]
                        for e in range(4):
                            r = e >> 1
                            ok = valid[:, :, e]
                            p = np.where(ok, np.exp2(np.where(
                                ok, s[:, :, e] * scale_log2 - m[w][r], 0)),
                                np.float32(0))
                            s[:, :, e] = p
                            l[w][r] += p.sum(0)
                        if not (alpha == 1).all():      # a row's max moved
                            for e in range(4):
                                o[w][:, :, e] *= alpha[e >> 1]
                        for kk in range(NS // 2):        # P: C -> A
                            pa = np.stack([s[2 * kk][:, 0:2],
                                           s[2 * kk][:, 2:4],
                                           s[2 * kk + 1][:, 0:2],
                                           s[2 * kk + 1][:, 2:4]], axis=1)
                            for dp in range(NO // 2):
                                bv = _ldmatrix_x4(
                                    smem, v_off(slot) + v_lane
                                    + kk * 16 * P + dp * 16, True)
                                _mma(o[w][2 * dp], pa, bv[:, 0], bv[:, 1])
                                _mma(o[w][2 * dp + 1], pa, bv[:, 2],
                                     bv[:, 3])
                    t = t_next
                    n += 1

                for w in range(WARPS):               # epilogue
                    row0 = w * 16
                    for r in range(2):
                        lr_ = l[w][r] + _shfl_xor(l[w][r], 1)
                        lr_ = lr_ + _shfl_xor(lr_, 2)
                        inv = 1.0 / np.maximum(lr_, np.float32(1e-37))
                        for j in range(NO):
                            at = Q_OFF + (row0 + 8 * r + G) * P \
                                + j * 8 + 2 * TG
                            smem[at] = o[w][j][:, 2 * r] * inv
                            smem[at + 1] = o[w][j][:, 2 * r + 1] * inv
                    for i in range(16 * CPR):
                        r, c = row0 + i // CPR, (i % CPR) * 8
                        if q0 + r < sq:
                            src = Q_OFF + r * P + c
                            out[bb, q0 + r, h, c:c + 8] = smem[src:src + 8]
    return out


def _valid_rows(qpos, kpos, causal):
    ok = np.broadcast_to(kpos[None, :] >= 0, (qpos.size, kpos.size))
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    return ok.any(1)


def _positions(sq, skv, q_off, kind):
    qpos = np.arange(sq, dtype=np.int32) + q_off
    kpos = np.arange(skv, dtype=np.int32)
    if kind == "holes":                   # a whole dead tile and a tail
        kpos[skv // 3:skv // 3 + 70] = -1
        kpos[-5:] = -1
    elif kind == "first64":               # the first kv-tile all -1
        kpos[:64] = -1
    elif kind == "reversed":              # tile 0 holds the latest keys, so
        kpos = kpos[::-1].copy()          # a causal row's first processed
    return qpos, kpos                     # tile can have no valid key


@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,d,causal,q_off,kind", [
        (1, 130, 130, 4, 1, 128, True, 0, "plain"),     # g 4, d 128
        (2, 100, 70, 2, 2, 16, False, 0, "holes"),      # sq > skv, g 1
        (1, 70, 150, 4, 1, 64, True, 40, "holes"),      # q offset, g 4
        (1, 96, 180, 2, 1, 64, True, 30, "first64"),
        (1, 130, 130, 2, 2, 64, True, 0, "reversed"),
        (1, 40, 200, 2, 2, 128, False, 0, "reversed"),
        (1, 200, 200, 4, 1, 64, True, 0, "holes"),      # 4 q-tiles
        (1, 150, 180, 2, 1, 128, True, 30, "first64"),
        (1, 100, 130, 2, 2, 128, False, 0, "reversed"),
    ])
def test_transliteration_matches_blocked_attention(b, sq, skv, hq, hkv, d,
                                                    causal, q_off, kind):
    rng = np.random.default_rng(sq * 1000 + skv + d)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    qpos, kpos = _positions(sq, skv, q_off, kind)
    got = tc_transliteration(q, k, v, qpos, kpos, causal)
    want = np.asarray(JA.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(kpos), causal=causal, window=0, block_q=64,
        block_kv=64))
    rows = _valid_rows(qpos, kpos, causal)
    assert rows.any()
    np.testing.assert_allclose(got[:, rows], want[:, rows], **TOL)
    assert not got[:, ~rows].any()        # no valid key: zeros


def test_rows_with_no_valid_key_get_zeros_beside_rows_that_have_one():
    """Keys 0-63 at -1, causal, queries at positions 30-129: rows 0-33 of
    the first q-tile see no valid key while rows 34-63 do, so the block
    computes kv-tiles 1-2 for all 64 rows. Were p = exp(s - m) taken with m
    still the sentinel, a row with no valid key would weigh every masked
    key 1 (and come out as a mean of V); the explicit zero leaves it 0."""
    sq, skv = 100, 180
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, sq, 1, 16)).astype(np.float32)
    k = rng.standard_normal((1, skv, 1, 16)).astype(np.float32)
    v = rng.standard_normal((1, skv, 1, 16)).astype(np.float32)
    qpos, kpos = _positions(sq, skv, 30, "first64")
    rows = _valid_rows(qpos, kpos, True)
    assert not rows[:34].any() and rows[34:].all()
    got = tc_transliteration(q, k, v, qpos, kpos, True)
    assert not got[0, :34].any()
    keys = np.nonzero((kpos >= 0) & (kpos <= qpos[40]))[0]
    s = q[0, 40, 0] @ k[0, keys, 0].T / 4.0
    p = np.exp(s - s.max())
    np.testing.assert_allclose(got[0, 40, 0], p @ v[0, keys, 0] / p.sum(),
                               **TOL)

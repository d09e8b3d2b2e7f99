"""The backward of the port's flash attention on the CPU.

* The plain backward (``flash_attention_bwd_ref``, which the CPU runs and
  ``chip_smoke.py`` holds the CUDA kernels to on the card) against
  ``jax.vjp`` of the reference's jnp ``blocked_attention`` on the same
  numpy inputs and cotangent: causal and not, GQA (g 1, 2 and 4), sq != skv,
  keys at -1, a query offset, head dims 16, 64 and 128. Both sides go
  through their public forward (the port's ``flash_attention`` under
  autograd, i.e. ``FlashAttention``). Rows with no valid key get zeros from
  the port's kernel and backward and a mean of V from the reference's
  sentinel, so their cotangent is zero here (no model path makes such a
  row). Tolerances: f32 1e-5 (atol and rtol; the same function in f32,
  summed in another order); bf16 within 2% of the leaf's largest
  magnitude (q, k, v, dO and the outputs carry 8 mantissa bits, P is
  rounded to bf16 before dV on both sides, and the two frameworks round
  the other products at other places).
* ``torch.autograd.gradcheck`` of ``FlashAttention`` in float64 (the plain
  versions compute in f64 for f64 inputs).
* The forward's lse is the log-sum-exp of each row's scaled valid scores,
  and ``flash_attention`` records a graph only when autograd does.
* The bf16 route's two backward kernels (``csrc/flash_attention_bwd.cu``,
  namespace ``tc``: ``dkdv_tc_kernel`` and ``dq_tc_kernel``) transliterated
  into numpy lane by lane, as ``test_torch_flash_tiles.py`` does for the
  forward, against the plain backward: the cp.async copies with zero-fill
  past sq and skv, the query range a key tile can see and the key tiles a
  query tile skips, from the positions (the dQ kernel's vote one tile
  ahead); the two-stage rings and their per-slot positions, lse (log2
  domain) and D; the ldmatrix lane addresses (plain for [row][d] operands,
  .trans for [k][d] ones) over rows padded by 16 bytes; the m16n8k16
  fragment layouts; the mask; P and dS reused from the accumulators as A
  operands; the GQA loop over query heads in the dK/dV block; the
  epilogues' row guards. Shared memory starts as NaN and the position
  slots as a poison value, so anything read before it is written shows.
  Values stay f32: this checks indexing, not bf16 rounding. Tolerance
  1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.kernels.flash_attention import flash_attention as FA
from tests.test_torch_flash_tiles import (G, LM, LR, LANES, TG, _ldmatrix_x4,
                                          _mma)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_REL = 0.02                  # of the leaf's largest magnitude
INT_MIN = np.iinfo(np.int32).min
POISON = INT_MIN + 7
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread inside each test, the worker's count
    restored after it: these tests run thousands of tiny ops, which under
    a parallel test run's oversubscribed cores spend their time in
    thread hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _positions(sq, skv, q_off, kind):
    qpos = np.arange(sq, dtype=np.int32) + q_off
    kpos = np.arange(skv, dtype=np.int32)
    if kind == "holes":                   # a whole dead tile and a tail
        kpos[skv // 3:skv // 3 + 70] = -1
        kpos[-5:] = -1
    elif kind == "first64":               # the first kv-tile all -1
        kpos[:64] = -1
    elif kind == "reversed":
        kpos = kpos[::-1].copy()
    return qpos, kpos


def _valid(qpos, kpos, causal):
    ok = np.broadcast_to(kpos[None, :] >= 0, (qpos.size, kpos.size))
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    return ok


def _case(seed, b, sq, skv, hq, hkv, d, causal, q_off, kind):
    """f32 numpy q, k, v, dO (zero on rows with no valid key) and the
    positions."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    qpos, kpos = _positions(sq, skv, q_off, kind)
    rows = _valid(qpos, kpos, causal).any(1)
    do[:, ~rows] = 0.0
    return q, k, v, do, qpos, kpos


def _reference_grads(q, k, v, do, qpos, kpos, causal, dtype, block_q,
                     block_kv):
    jd = getattr(jnp, dtype)

    def f(q_, k_, v_):
        return JA.blocked_attention(q_, k_, v_, jnp.asarray(qpos),
                                    jnp.asarray(kpos), causal=causal,
                                    window=0, block_q=block_q,
                                    block_kv=block_kv)

    _, vjp = jax.vjp(f, *(jnp.asarray(x).astype(jd) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do).astype(jd))]


def _port_grads(q, k, v, do, qpos, kpos, causal, dtype, block_q, block_kv):
    td = getattr(torch, dtype)
    xs = [torch.from_numpy(x).to(td).requires_grad_(True) for x in (q, k, v)]
    out = FA.flash_attention(*xs, torch.from_numpy(qpos),
                             torch.from_numpy(kpos), causal=causal,
                             block_q=block_q, block_kv=block_kv)
    assert out.grad_fn is not None and out.dtype == td
    out.backward(torch.from_numpy(do).to(td))
    return [x.grad.float().numpy() for x in xs]


CASES = [   # b, sq, skv, hq, hkv, d, causal, q_off, kind
    (1, 40, 40, 4, 1, 16, True, 0, "plain"),          # g 4
    (2, 40, 70, 4, 1, 64, False, 0, "plain"),         # sq < skv, full
    (1, 70, 40, 2, 2, 16, False, 0, "plain"),         # sq > skv, g 1
    (1, 50, 90, 8, 2, 128, True, 20, "holes"),        # keys at -1, offset
    (1, 60, 96, 4, 2, 64, True, 30, "first64"),       # no valid key rows
    (1, 48, 48, 4, 1, 64, True, 0, "reversed"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_jax_grad_of_blocked_attention(case, dtype):
    b, sq, skv, hq, hkv, d, causal, q_off, kind = case
    q, k, v, do, qpos, kpos = _case(sq + skv + d, b, sq, skv, hq, hkv, d,
                                    causal, q_off, kind)
    want = _reference_grads(q, k, v, do, qpos, kpos, causal, dtype, 16, 32)
    got = _port_grads(q, k, v, do, qpos, kpos, causal, dtype, 16, 32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **F32_TOL, err_msg=name)
        else:
            bound = BF16_REL * np.abs(w).max()
            assert np.abs(g - w).max() <= bound, name


def test_gqa_sums_each_kv_head_over_its_query_heads():
    """dk, dv of g query heads sharing one KV head equal the sums of the
    per-head gradients with the KV head repeated (g 1 each)."""
    q, k, v, do, qpos, kpos = _case(5, 1, 30, 30, 4, 2, 16, True, 0, "plain")
    dq, dk, dv = _port_grads(q, k, v, do, qpos, kpos, True, "float32", 16,
                             16)
    krep, vrep = np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)
    dq1, dk1, dv1 = _port_grads(q, krep, vrep, do, qpos, kpos, True,
                                "float32", 16, 16)
    np.testing.assert_allclose(dq, dq1, **F32_TOL)
    np.testing.assert_allclose(dk, dk1.reshape(1, 30, 2, 2, 16).sum(3),
                               **F32_TOL)
    np.testing.assert_allclose(dv, dv1.reshape(1, 30, 2, 2, 16).sum(3),
                               **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_in_float64(causal):
    """Tiny on purpose: gradcheck evaluates the forward twice per input
    element. Two query heads over one KV head, blocks of 4 over 5 queries
    and 7 keys (ragged), a key at -1, queries offset past the keys' start."""
    gen = torch.Generator().manual_seed(int(causal))
    q = torch.randn(1, 5, 2, 4, dtype=torch.float64, generator=gen)
    k = torch.randn(1, 7, 1, 4, dtype=torch.float64, generator=gen)
    v = torch.randn(1, 7, 1, 4, dtype=torch.float64, generator=gen)
    qpos = torch.arange(5, dtype=torch.int32) + 2
    kpos = torch.arange(7, dtype=torch.int32)
    kpos[1] = -1
    inputs = tuple(t.requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda *x: FA.FlashAttention.apply(*x, qpos, kpos, causal, 4, 4),
        inputs)


def test_lse_is_the_log_sum_exp_of_each_rows_valid_scores():
    q, k, v, _, qpos, kpos = _case(7, 1, 20, 30, 2, 1, 16, True, 4, "plain")
    kpos[3] = -1
    out, lse = FA.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qpos), torch.from_numpy(kpos), causal=True,
        block_q=8, block_kv=16)
    assert lse.shape == (1, 2, 20) and lse.dtype == torch.float32
    s = np.einsum("qhd,kd->hqk", q[0], k[0, :, 0]) / 4.0
    s = np.where(_valid(qpos, kpos, True)[None], s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse[0].numpy(), want, **F32_TOL)
    plain = FA.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qpos), torch.from_numpy(kpos), causal=True,
        block_q=8, block_kv=16)
    assert torch.equal(out, plain)


def test_a_graph_is_recorded_only_when_autograd_records():
    q, k, v, _, qpos, kpos = _case(8, 1, 8, 8, 2, 1, 16, True, 0, "plain")
    args = (torch.from_numpy(qpos), torch.from_numpy(kpos))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    assert FA.flash_attention(*xs, *args, causal=True).grad_fn is not None
    with torch.no_grad():
        assert FA.flash_attention(*xs, *args, causal=True).grad_fn is None
    plain = [torch.from_numpy(x) for x in (q, k, v)]
    assert FA.flash_attention(*plain, *args, causal=True).grad_fn is None


# ---------------------------------------------------------------------------
# the bf16 route's kernels, transliterated
# ---------------------------------------------------------------------------

WARPS = 4
ROWS = 16 * WARPS                         # keys (dK/dV) or queries (dQ)
STEP_Q = 32                               # queries a dK/dV step
STEP_K = 64                               # keys a dQ step
A_LANE = ((LM & 1) * 8 + LR, (LM >> 1) * 8)       # (row, column) a lane
B_LANE = ((LM >> 1) * 8 + LR, (LM & 1) * 8)
T_LANE = ((LM & 1) * 8 + LR, (LM >> 1) * 8)       # .trans B


def _addr(base, lane, P, row=0, col=0):
    return base + (lane[0] + row) * P + lane[1] + col


def _mma_abt(smem, a, b, P, d, nt):
    """[nt, 32, 4] = A (16 rows at a) . B^T (nt * 8 rows at b)."""
    c = np.zeros((nt, 32, 4), np.float32)
    for kk in range(d // 16):
        af = _ldmatrix_x4(smem, _addr(a, A_LANE, P, col=kk * 16), False)
        for np_ in range(nt // 2):
            bf = _ldmatrix_x4(smem, _addr(b, B_LANE, P, row=np_ * 16,
                                          col=kk * 16), False)
            _mma(c[2 * np_], af, bf[:, 0], bf[:, 1])
            _mma(c[2 * np_ + 1], af, bf[:, 2], bf[:, 3])
    return c


def _mma_xb(smem, x, b, P, d, acc):
    """acc [d / 8, 32, 4] += X (the accumulators x as A) . B ([k][d] rows
    at b, .trans)."""
    for kk in range(x.shape[0] // 2):
        pa = np.stack([x[2 * kk][:, 0:2], x[2 * kk][:, 2:4],
                       x[2 * kk + 1][:, 0:2], x[2 * kk + 1][:, 2:4]], axis=1)
        for dp in range(d // 16):
            bv = _ldmatrix_x4(smem, _addr(b, T_LANE, P, row=kk * 16,
                                          col=dp * 16), True)
            _mma(acc[2 * dp], pa, bv[:, 0], bv[:, 1])
            _mma(acc[2 * dp + 1], pa, bv[:, 2], bv[:, 3])


def _copy_rows(smem, dst, src, r0, n, n_rows, P, d):
    """cp.async of rows [r0, r0 + n_rows) of src [*, d], zeros past n."""
    for r in range(n_rows):
        smem[dst + r * P:dst + r * P + d] = src[r0 + r] if r0 + r < n else 0


def _store_rows(out, acc, scale, row0, n):
    for r in range(2):
        row = row0 + G + 8 * r
        for j in range(acc.shape[0]):
            for e in range(2):
                ok = row < n
                out[row[ok], j * 8 + 2 * TG[ok] + e] = \
                    acc[j][ok, 2 * r + e] * scale


def _mask(key, qp, causal):
    return (key >= 0) & (qp != INT_MIN) & ((key <= qp) if causal else True)


def dkdv_transliteration(q, k, v, do, lse, dsum, qpos, kpos, causal):
    """(dk, dv) as dkdv_tc_kernel<d> computes them."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g, P = hq // hkv, d + 8
    scale = np.float32(1.0 / math.sqrt(d))
    scale_log2 = np.float32(scale * LOG2E)
    K_OFF, V_OFF, RING = 0, ROWS * P, 2 * ROWS * P
    STAGE = 2 * STEP_Q * P
    dk = np.full(k.shape, np.nan, np.float32)
    dv = np.full(k.shape, np.nan, np.float32)
    for bb in range(b):
        for kh in range(hkv):
            for bx in range(-(-skv // ROWS)):
                k0 = bx * ROWS
                smem = np.full(RING + 2 * STAGE, np.nan, np.float32)
                _copy_rows(smem, K_OFF, k[bb, :, kh], k0, skv, ROWS, P, d)
                _copy_rows(smem, V_OFF, v[bb, :, kh], k0, skv, ROWS, P, d)
                skpos = np.array([kpos[k0 + i] if k0 + i < skv else -1
                                  for i in range(ROWS)])
                live = skpos[skpos >= 0]
                n = sq if live.size else 0
                ok = (qpos[:n] >= live.min()) if (causal and n) \
                    else np.ones(n, bool)
                idx = np.nonzero(ok)[0]
                t_lo = idx[0] // STEP_Q if idx.size else 0
                nt = idx[-1] // STEP_Q + 1 - t_lo if idx.size else 0
                sqpos = np.full((2, STEP_Q), POISON, np.int64)
                slse = np.full((2, STEP_Q), np.nan, np.float32)
                sdd = np.full((2, STEP_Q), np.nan, np.float32)

                def load_item(n_, slot):
                    h = kh * g + n_ // nt
                    q0 = (t_lo + n_ % nt) * STEP_Q
                    qo = RING + slot * STAGE
                    _copy_rows(smem, qo, q[bb, :, h], q0, sq, STEP_Q, P, d)
                    _copy_rows(smem, qo + STEP_Q * P, do[bb, :, h], q0, sq,
                               STEP_Q, P, d)
                    for i in range(STEP_Q):
                        inn = q0 + i < sq
                        sqpos[slot, i] = qpos[q0 + i] if inn else INT_MIN
                        slse[slot, i] = lse[bb, h, q0 + i] * np.float32(
                            LOG2E) if inn else 0.0
                        sdd[slot, i] = dsum[bb, h, q0 + i] if inn else 0.0

                dka = np.zeros((WARPS, d // 8, 32, 4), np.float32)
                dva = np.zeros((WARPS, d // 8, 32, 4), np.float32)
                items = g * nt
                if items:
                    load_item(0, 0)
                for n_ in range(items):
                    slot = n_ & 1
                    if n_ + 1 < items:
                        load_item(n_ + 1, slot ^ 1)
                    qo = RING + slot * STAGE
                    assert (sqpos[slot] != POISON).all()
                    for w in range(WARPS):
                        kr0 = w * 16
                        s = _mma_abt(smem, K_OFF + kr0 * P, qo, P, d, 4)
                        dp = _mma_abt(smem, V_OFF + kr0 * P, qo + STEP_Q * P,
                                      P, d, 4)
                        for j in range(4):
                            for e in range(4):
                                c = j * 8 + 2 * TG + (e & 1)
                                key = skpos[kr0 + G + 8 * (e >> 1)]
                                ok_ = _mask(key, sqpos[slot, c], causal)
                                p = np.where(ok_, np.exp2(np.where(
                                    ok_, s[j, :, e] * scale_log2
                                    - slse[slot, c], 0)), np.float32(0))
                                s[j, :, e] = p
                                dp[j, :, e] = p * (dp[j, :, e]
                                                   - sdd[slot, c])
                        _mma_xb(smem, s, qo + STEP_Q * P, P, d, dva[w])
                        _mma_xb(smem, dp, qo, P, d, dka[w])
                for w in range(WARPS):
                    _store_rows(dk[bb, k0:, kh], dka[w], scale, w * 16,
                                skv - k0)
                    _store_rows(dv[bb, k0:, kh], dva[w], np.float32(1),
                                w * 16, skv - k0)
    return dk, dv


def dq_transliteration(q, k, v, do, lse, dsum, qpos, kpos, causal):
    """dq as dq_tc_kernel<d> computes it."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g, P = hq // hkv, d + 8
    scale = np.float32(1.0 / math.sqrt(d))
    scale_log2 = np.float32(scale * LOG2E)
    Q_OFF, DO_OFF, RING = 0, ROWS * P, 2 * ROWS * P
    STAGE = 2 * STEP_K * P
    dq = np.full(q.shape, np.nan, np.float32)
    nqt = -(-sq // ROWS)
    for bb in range(b):
        for h in range(hq):
            for bx in range(nqt):
                q0 = (nqt - 1 - bx) * ROWS
                smem = np.full(RING + 2 * STAGE, np.nan, np.float32)
                _copy_rows(smem, Q_OFF, q[bb, :, h], q0, sq, ROWS, P, d)
                _copy_rows(smem, DO_OFF, do[bb, :, h], q0, sq, ROWS, P, d)
                sqpos = np.array([qpos[q0 + i] if q0 + i < sq else INT_MIN
                                  for i in range(ROWS)], np.int64)
                qmax = sqpos.max()
                ok = (kpos >= 0) & ((kpos <= qmax) if causal else True)
                idx = np.nonzero(ok)[0]
                t_lo = idx[0] // STEP_K if idx.size else 0
                t_hi = idx[-1] // STEP_K + 1 if idx.size else 0
                rows = q0 + np.arange(ROWS)
                inn = rows < sq
                lse2 = np.where(inn, lse[bb, h, np.minimum(rows, sq - 1)]
                                * np.float32(LOG2E), 0).astype(np.float32)
                dd = np.where(inn, dsum[bb, h, np.minimum(rows, sq - 1)],
                              0).astype(np.float32)
                skpos = np.full((2, STEP_K), POISON, np.int64)

                def load_kp(t):
                    keys = t * STEP_K + np.stack([LANES, LANES + 32])
                    kp = np.full((2, 32), -1, np.int64)
                    ok_ = (keys < skv) & (t < t_hi)
                    kp[ok_] = kpos[keys[ok_]]
                    return kp

                def next_live(t, kp):
                    while t < t_hi and not ((kp >= 0) & (
                            (kp <= qmax) if causal else True)).any():
                        t += 1
                        kp = load_kp(t)
                    return t, kp

                def load_kv(t, slot, kp):
                    ko = RING + slot * STAGE
                    _copy_rows(smem, ko, k[bb, :, h // g], t * STEP_K, skv,
                               STEP_K, P, d)
                    _copy_rows(smem, ko + STEP_K * P, v[bb, :, h // g],
                               t * STEP_K, skv, STEP_K, P, d)
                    skpos[slot, LANES] = kp[0]
                    skpos[slot, LANES + 32] = kp[1]

                t, kp_cur = next_live(t_lo, load_kp(t_lo))
                if t < t_hi:
                    load_kv(t, 0, kp_cur)
                kp_nxt = load_kp(t + 1)
                dqa = np.zeros((WARPS, d // 8, 32, 4), np.float32)
                n_ = 0
                while t < t_hi:
                    slot = n_ & 1
                    t_next, kp_nxt = next_live(t + 1, kp_nxt)
                    if t_next < t_hi:
                        load_kv(t_next, slot ^ 1, kp_nxt)
                    kp_nxt = load_kp(t_next + 1)
                    ko = RING + slot * STAGE
                    assert (skpos[slot] != POISON).all()
                    for w in range(WARPS):
                        r0 = w * 16
                        s = _mma_abt(smem, Q_OFF + r0 * P, ko, P, d, 8)
                        dp = _mma_abt(smem, DO_OFF + r0 * P,
                                      ko + STEP_K * P, P, d, 8)
                        for j in range(8):
                            for e in range(4):
                                r = r0 + G + 8 * (e >> 1)
                                key = skpos[slot, j * 8 + 2 * TG + (e & 1)]
                                ok_ = _mask(key, sqpos[r], causal)
                                p = np.where(ok_, np.exp2(np.where(
                                    ok_, s[j, :, e] * scale_log2 - lse2[r],
                                    0)), np.float32(0))
                                dp[j, :, e] = p * (dp[j, :, e] - dd[r])
                        _mma_xb(smem, dp, ko, P, d, dqa[w])
                    t = t_next
                    n_ += 1
                for w in range(WARPS):
                    _store_rows(dq[bb, q0:, h], dqa[w], scale, w * 16,
                                sq - q0)
    return dq


@pytest.mark.parametrize("case", [
    # b, sq, skv, hq, hkv, d, causal, q_off, kind
    (1, 130, 130, 4, 1, 64, True, 0, "plain"),        # g 4, 3 tiles a side
    (2, 40, 70, 2, 2, 16, False, 0, "holes"),         # sq < skv, b 2
    (1, 70, 150, 2, 1, 128, True, 40, "holes"),       # offset, a dead tile
    (1, 96, 180, 2, 1, 64, True, 30, "first64"),      # rows with no key
    (1, 100, 100, 2, 2, 32, True, 0, "reversed"),
], ids=str)
def test_transliteration_matches_the_plain_backward(case):
    b, sq, skv, hq, hkv, d, causal, q_off, kind = case
    q, k, v, do, qpos, kpos = _case(sq * 7 + skv + d, b, sq, skv, hq, hkv,
                                    d, causal, q_off, kind)
    args = (torch.from_numpy(qpos), torch.from_numpy(kpos))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = FA.flash_attention_lse(tq, tk, tv, *args, causal=causal,
                                    block_q=64, block_kv=64)
    want = FA.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, *args,
                                      causal=causal, block_q=64,
                                      block_kv=64)
    dsum = np.einsum("bshd,bshd->bhs", do, o.numpy())
    lse = lse.numpy()
    dk, dv = dkdv_transliteration(q, k, v, do, lse, dsum, qpos, kpos, causal)
    dq = dq_transliteration(q, k, v, do, lse, dsum, qpos, kpos, causal)
    for name, got, w in (("dq", dq, want[0]), ("dk", dk, want[1]),
                         ("dv", dv, want[2])):
        np.testing.assert_allclose(got, w.numpy(), **F32_TOL, err_msg=name)

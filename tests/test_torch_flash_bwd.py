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
  namespace ``tc``: ``dkdv_wgmma_kernel`` and ``dq_wgmma_kernel``)
  transliterated into numpy tile by tile against the plain backward: the
  blocks in grid order; TMA's tiles with zeros past sq, skv and d (the
  head dim padded to 64 or 128); the query tiles a key tile visits (from
  the positions) over the g query heads, in order, and the key tiles a
  query tile visits, a tile with no valid key skipped by the producer's
  vote and the ring ended by the index -1; the ring of three stages with
  its full and empty barriers' phases, each stage's positions, lse (log2
  domain) and D, a slot poisoned until written; each consumer
  warpgroup's 64 rows; the mask and the ex2 of P; P and dS rounded to
  bf16 before their products (``bf16=True``); the epilogues' row and
  column guards. The order of the sums inside one wgmma is the
  hardware's, so f32 inputs are held at 1e-5 with no rounding, and bf16
  inputs, rounded as the kernel rounds, within 2e-2 of each row's norm
  (``chip_smoke.BWD_ROW``), as the card's check holds the kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.kernels.flash_attention import flash_attention as FA

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
# the bf16 route's kernels, transliterated tile by tile
# ---------------------------------------------------------------------------

BLOCK = 128                # resident rows a block: keys (dK/dV), queries (dQ)
WG = 64                    # rows a consumer warpgroup owns
STEP = 64                  # streamed rows a stage: queries (dK/dV), keys (dQ)
STAGES = 3                 # ring depth
BWD_ROW = 0.02             # chip_smoke's bound on a bf16 row, of its norm


def _padded(d):
    return 64 if d <= 64 else 128


def _tma_tile(x, r0, rows, dp):
    """TMA's tile: rows [r0, r0 + rows) of x [n, d] as [rows, dp], zeros
    past n and past d."""
    out = np.zeros((rows, dp), np.float32)
    n, d = x.shape
    hi = min(n, r0 + rows)
    if hi > r0:
        out[:hi - r0, :d] = x[r0:hi]
    return out


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16) \
        .float().numpy()


class Ring:
    """The producer warp's ring: ``STAGES`` slots with full and empty
    barriers, counted in completed phases. A wait on parity p passes only
    when the barrier is exactly one phase past the waiter's round (two
    would alias the parity), and a slot reads as poison until written."""

    def __init__(self):
        self.slots = [None] * STAGES
        self.full = [0] * STAGES
        self.empty = [0] * STAGES
        self.produced = 0

    def produce(self, make):
        n = self.produced
        s = n % STAGES
        assert self.empty[s] == n // STAGES      # producer's flipped parity
        self.slots[s] = (n, make(n))
        self.full[s] += 1
        self.produced += 1

    def consume(self, n):
        s = n % STAGES
        assert self.full[s] == n // STAGES + 1
        tag, data = self.slots[s]
        assert tag == n
        return data

    def release(self, n):
        s = n % STAGES
        self.slots[s] = (None, None)            # poison
        self.empty[s] += 1


def dkdv_tiles(q, k, v, do, lse, dsum, qpos, kpos, causal, bf16=False):
    """(dk, dv, visits) as dkdv_wgmma_kernel computes them; visits maps
    (batch row, KV head, key tile) to its items (query head, first query)
    in the order the block takes them."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g, dp = hq // hkv, _padded(d)
    scale = np.float32(1.0 / math.sqrt(d))
    scale_log2 = np.float32(scale * LOG2E)
    rnd = _bf16 if bf16 else (lambda x: x)
    dk = np.full(k.shape, np.nan, np.float32)
    dv = np.full(k.shape, np.nan, np.float32)
    visits = {}
    for bb in range(b):
        for kt in range(-(-skv // BLOCK)):
            for kh in range(hkv):              # heads fastest
                k0 = kt * BLOCK
                K = _tma_tile(k[bb, :, kh], k0, BLOCK, dp)
                V = _tma_tile(v[bb, :, kh], k0, BLOCK, dp)
                skpos = np.array([kpos[k0 + i] if k0 + i < skv else -1
                                  for i in range(BLOCK)])
                live = skpos[skpos >= 0]
                n = sq if live.size else 0
                ok = (qpos[:n] >= live.min()) if (causal and n) \
                    else np.ones(n, bool)
                idx = np.nonzero(ok)[0]
                t_lo = idx[0] // STEP if idx.size else 0
                nt = idx[-1] // STEP + 1 - t_lo if idx.size else 0
                items = [(kh * g + i // nt, (t_lo + i % nt) * STEP)
                         for i in range(g * nt)]
                visits[bb, kh, kt] = items

                def load(i):
                    h, q0 = items[i]
                    rows = q0 + np.arange(STEP)
                    inn = rows < sq
                    at = np.minimum(rows, sq - 1)
                    return (_tma_tile(q[bb, :, h], q0, STEP, dp),
                            _tma_tile(do[bb, :, h], q0, STEP, dp),
                            np.where(inn, qpos[at], INT_MIN),
                            np.where(inn, lse[bb, h, at] * np.float32(LOG2E),
                                     0).astype(np.float32),
                            np.where(inn, dsum[bb, h, at], 0)
                            .astype(np.float32))

                ring = Ring()
                dka = np.zeros((2, WG, dp), np.float32)
                dva = np.zeros((2, WG, dp), np.float32)
                for i in range(len(items)):
                    while ring.produced < min(i + STAGES, len(items)):
                        ring.produce(load)
                    Q, DO, qp, l2, dd = ring.consume(i)
                    for w in range(2):
                        rows = slice(w * WG, (w + 1) * WG)
                        st = K[rows] @ Q.T                 # S^T: keys x queries
                        dpt = V[rows] @ DO.T
                        ok = _mask(skpos[rows, None], qp[None, :], causal)
                        p = np.where(ok, np.exp2(np.where(
                            ok, st * scale_log2 - l2[None, :], 0)), 0)
                        ds = p * (dpt - dd[None, :])
                        dva[w] += rnd(p) @ DO
                        dka[w] += rnd(ds) @ Q
                    ring.release(i)
                for w in range(2):
                    r0 = k0 + w * WG
                    n_rows = max(0, min(WG, skv - r0))
                    dk[bb, r0:r0 + n_rows, kh] = dka[w, :n_rows, :d] * scale
                    dv[bb, r0:r0 + n_rows, kh] = dva[w, :n_rows, :d]
    return dk, dv, visits


def dq_tiles(q, k, v, do, lse, dsum, qpos, kpos, causal, bf16=False):
    """(dq, visits) as dq_wgmma_kernel computes it; visits maps (batch row,
    query head, first query) to the key tiles the block takes, in order."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g, dp = hq // hkv, _padded(d)
    scale = np.float32(1.0 / math.sqrt(d))
    scale_log2 = np.float32(scale * LOG2E)
    rnd = _bf16 if bf16 else (lambda x: x)
    dq = np.full(q.shape, np.nan, np.float32)
    nqt = -(-sq // BLOCK)
    visits = {}
    for bb in range(b):
        for by in range(nqt):
            for h in range(hq):                # heads fastest
                q0 = (nqt - 1 - by) * BLOCK     # the heaviest tiles first
                Q = _tma_tile(q[bb, :, h], q0, BLOCK, dp)
                DO = _tma_tile(do[bb, :, h], q0, BLOCK, dp)
                rows = q0 + np.arange(BLOCK)
                inn = rows < sq
                at = np.minimum(rows, sq - 1)
                sqp = np.where(inn, qpos[at], INT_MIN)
                l2 = np.where(inn, lse[bb, h, at] * np.float32(LOG2E), 0) \
                    .astype(np.float32)
                dd = np.where(inn, dsum[bb, h, at], 0).astype(np.float32)
                qmax = sqp.max()
                ok = (kpos >= 0) & ((kpos <= qmax) if causal else True)
                idx = np.nonzero(ok)[0]
                t_lo = idx[0] // STEP if idx.size else 0
                t_hi = idx[-1] // STEP + 1 if idx.size else 0

                def tiles():
                    """The producer's walk: each live tile, then -1."""
                    t = t_lo
                    while True:
                        while t < t_hi:
                            keys = t * STEP + np.arange(STEP)
                            kp = np.where(keys < skv,
                                          kpos[np.minimum(keys, skv - 1)], -1)
                            if ((kp >= 0) & ((kp <= qmax) if causal
                                             else True)).any():
                                break
                            t += 1
                        if t >= t_hi:
                            yield -1, None
                            return
                        yield t, kp
                        t += 1

                walk = tiles()

                def load(_):
                    t, kp = next(walk)
                    if t < 0:
                        return t, None, None, None
                    return (t, _tma_tile(k[bb, :, h // g], t * STEP, STEP, dp),
                            _tma_tile(v[bb, :, h // g], t * STEP, STEP, dp),
                            kp)

                ring = Ring()
                dqa = np.zeros((2, WG, dp), np.float32)
                order = []
                n = 0
                while True:
                    if ring.produced <= n:
                        ring.produce(load)
                    t, K, V, kp = ring.consume(n)
                    if t < 0:
                        break
                    order.append(t)
                    for w in range(2):
                        r = slice(w * WG, (w + 1) * WG)
                        s = Q[r] @ K.T                     # S: queries x keys
                        dpm = DO[r] @ V.T
                        ok = _mask(kp[None, :], sqp[r, None], causal)
                        p = np.where(ok, np.exp2(np.where(
                            ok, s * scale_log2 - l2[r, None], 0)), 0)
                        dqa[w] += rnd(p * (dpm - dd[r, None])) @ K
                    ring.release(n)
                    n += 1
                visits[bb, h, q0] = order
                for w in range(2):
                    r0 = q0 + w * WG
                    n_rows = max(0, min(WG, sq - r0))
                    dq[bb, r0:r0 + n_rows, h] = dqa[w, :n_rows, :d] * scale
    return dq, visits


def _mask(key, qp, causal):
    return (key >= 0) & (qp != INT_MIN) & ((key <= qp) if causal else True)


def _transliterate(case, bf16, rounding=None):
    """(the tiles' dq, dk, dv, the plain backward's, visits): bf16 rounds
    the inputs, ``rounding`` (default: bf16) P and dS."""
    rounding = bf16 if rounding is None else rounding
    b, sq, skv, hq, hkv, d, causal, q_off, kind = case
    q, k, v, do, qpos, kpos = _case(sq * 7 + skv + d, b, sq, skv, hq, hkv,
                                    d, causal, q_off, kind)
    if bf16:
        q, k, v, do = (_bf16(x) for x in (q, k, v, do))
    dtype = torch.bfloat16 if bf16 else torch.float32
    args = (torch.from_numpy(qpos), torch.from_numpy(kpos))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    o, lse = FA.flash_attention_lse(tq, tk, tv, *args, causal=causal,
                                    block_q=64, block_kv=64)
    want = FA.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, *args,
                                      causal=causal, block_q=64,
                                      block_kv=64)
    dsum = np.einsum("bshd,bshd->bhs", do, o.float().numpy())
    lse = lse.numpy()
    dk, dv, kv_visits = dkdv_tiles(q, k, v, do, lse, dsum, qpos, kpos,
                                   causal, rounding)
    dq, q_visits = dq_tiles(q, k, v, do, lse, dsum, qpos, kpos, causal,
                            rounding)
    return (dq, dk, dv), [w.float().numpy() for w in want], kv_visits, \
        q_visits


@pytest.mark.parametrize("case", [
    # b, sq, skv, hq, hkv, d, causal, q_off, kind
    (1, 130, 130, 4, 1, 64, True, 0, "plain"),        # g 4, 3 tiles a side
    (2, 40, 70, 2, 2, 16, False, 0, "holes"),         # sq < skv, b 2
    (1, 70, 150, 2, 1, 128, True, 40, "holes"),       # offset, a dead tile
    (1, 96, 180, 2, 1, 64, True, 30, "first64"),      # rows with no key
    (1, 100, 100, 2, 2, 32, True, 0, "reversed"),
    (1, 200, 260, 4, 2, 128, True, 0, "plain"),       # sq 200: ragged at 64
    (1, 90, 90, 2, 1, 80, False, 0, "plain"),         # d 80 padded to 128
], ids=str)
def test_transliteration_matches_the_plain_backward(case):
    got, want, _, _ = _transliterate(case, bf16=False)
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g_, w, **F32_TOL, err_msg=name)


@pytest.mark.parametrize("case", [
    (1, 200, 260, 4, 2, 128, True, 0, "plain"),
    (1, 96, 180, 2, 1, 64, True, 30, "first64"),
], ids=str)
def test_transliteration_rounds_p_and_ds_to_bf16(case):
    """bf16 inputs, P and dS rounded before their products, against the
    plain backward in bf16, row by row; rounding must move the result."""
    got, want, _, _ = _transliterate(case, bf16=True)
    exact, _, _, _ = _transliterate(case, bf16=True, rounding=False)
    for name, g_, w, e in zip(("dq", "dk", "dv"), got, want, exact):
        norm = np.linalg.norm(w, axis=-1)
        floor = 1e-3 * max(float(np.sqrt(np.mean(norm ** 2))),
                           w.shape[-1] ** 0.5)
        err = np.linalg.norm(g_ - w, axis=-1) / np.maximum(norm, floor)
        assert err.max() <= BWD_ROW, name
        assert not np.array_equal(g_, e), name


def test_schedule_of_the_blocks():
    """The items a key tile visits and the key tiles a query tile visits,
    in order, at a causal GQA case with a dead key tile."""
    case = (1, 300, 300, 4, 2, 64, True, 0, "holes")
    _, _, kv_visits, q_visits = _transliterate(case, bf16=False)
    # keys 128-255 see queries from 128 on: query tiles 2-4 for each of
    # the KV head's two query heads, head by head
    assert kv_visits[0, 1, 1] == [(2, 128), (2, 192), (2, 256),
                                  (3, 128), (3, 192), (3, 256)]
    # keys 256-299 (the last 5 invalid): query tile 4 only
    assert kv_visits[0, 0, 2] == [(0, 256), (1, 256)]
    # queries 256-299 see every key tile (keys 100-169 are -1, but each of
    # tiles 1 and 2 keeps valid keys); queries 0-127 see keys 0-99
    assert q_visits[0, 3, 256] == [0, 1, 2, 3, 4]
    assert q_visits[0, 0, 0] == [0, 1]
    holed = (1, 300, 300, 2, 1, 64, True, 0, "plain")
    q, k, v, do, qpos, kpos = _case(1, *holed)
    kpos[64:128] = -1                          # key tile 1 dead
    lse = np.zeros((1, 2, 300), np.float32)
    _, visits = dq_tiles(q, k, v, do, lse, lse, qpos, kpos, True)
    assert visits[0, 0, 256] == [0, 2, 3, 4]
    assert visits[0, 1, 0] == [0]

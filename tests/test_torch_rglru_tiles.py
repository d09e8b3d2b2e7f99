"""The RG-LRU scan kernel (``csrc/rglru_scan.cu``), transliterated into
numpy tile by tile and lane by lane and held to the plain version, to the
reference's ``_scan_lru`` and, from a zero state, to the Pallas kernel in
interpret mode and ``ref.py``.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to its
plain version there). This transliteration follows its index arithmetic:
the atomic ticket (chunk-major) that gives a block its (chunk, batch row,
channel tile); a lane's four channels as one float4 or, on the scalar edge
path, four masked scalars, with the identity (a 1, b 0) past W and past T;
each scan warp's scan from zero over its kSteps steps; the warps'
aggregates in shared memory (which starts as NaN, so a read of an
unwritten element shows in the output), composed in warp order; the chunk
aggregate published to the workspace (NaN until written) before its bit
in the column's done words; the carry warp's fold from h0 over chunks
0 .. c-1 in chunk order, each run of chunks as soon as their bits are set,
their aggregates staged in shared memory kStage at a time; and the
``fma`` output.
The tile constants are read from the source.

``run`` executes the tiles in ticket order or, given a generator, in any
interleaving the kernel allows: a block takes the next ticket; its scan
warps publish after their local scan while its carry warp folds each run
of chunks as soon as their bits are set; it stores when both are done.
The design's invariant is that the bits do not depend on that order, nor
on B or a row's batch position; the kernel's own bits are checked on the
card.

Tolerance against the references 1e-5 absolute and relative, as the plain
version's (``tests/test_torch_kernels.py``): the same f32 recurrence in
another grouping (chunk products of up to 64 factors against the log-depth
scan's), a few ulp of f32 apart at these inputs.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref
from repro.kernels.rglru_scan.rglru_scan import rglru_scan as pallas_rglru
from repro.models.rglru import _scan_lru
from repro_torch.kernels.build import SOURCES, _HERE
from repro_torch.kernels.rglru_scan import rglru_scan as RS

TOL = dict(atol=1e-5, rtol=1e-5)
F32 = np.float32
LANES = np.arange(32)

_SRC = (_HERE / SOURCES["rglru_scan"]).read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


KWARPS, KSTEPS, KTILE = _const("kWarps"), _const("kSteps"), _const("kTile")
KSTAGE = _const("kStage")
KCHUNK = KWARPS * KSTEPS
assert f"constexpr int kChunk = kWarps * kSteps;" in _SRC


def _fma(x, y, z):
    """fmaf, the product held exactly in f64 before the sum."""
    d = np.float64
    return (np.asarray(x, d) * np.asarray(y, d) + np.asarray(z, d)).astype(F32)


class Launch:
    """One call of ``rglru_scan_launch``: the memory its blocks share (the
    done bits zeroed by the launcher's memset, the rest NaN until
    written)."""

    def __init__(self, a, b, h0, vec=None, hf=None):
        """``hf`` (the forward's h) makes it the backward's reverse scan
        (``rglru_scan_bwd_launch``): b is then dh, h receives db, and da
        and dh0 are written too."""
        self.a, self.b, self.h0 = a, b, h0
        self.rev, self.hf = hf is not None, hf
        self.B, self.T, self.W = a.shape
        self.vec = self.W % 4 == 0 if vec is None else vec
        assert not self.vec or self.W % 4 == 0
        self.nc, self.ntw = -(-self.T // KCHUNK), -(-self.W // KTILE)
        n = self.B * self.nc * self.ntw
        self.n = n
        self.agg_p = np.full((n, 32, 4), np.nan, F32)
        self.agg_h = np.full((n, 32, 4), np.nan, F32)
        self.nm = -(-self.nc // 64)
        self.done = np.zeros((self.B * self.ntw, self.nm), np.uint64)
        self.ticket = 0
        self.h = np.full(a.shape, np.nan, F32)
        self.da = np.full(a.shape, np.nan, F32)
        self.dh0 = np.full(h0.shape, np.nan, F32)

    def step(self, u):
        """Real step of virtual step u (the reverse scan runs from the
        last step)."""
        return self.T - 1 - u if self.rev else u

    def load(self, row, w, fill):
        """load4: each lane's channels w .. w+3 of ``row``, ``fill`` past
        W (the float4 path needs W % 4 == 0: a lane has all four or
        none)."""
        out = np.full((32, 4), fill, F32)
        if self.vec:
            m = w < self.W
            out[m] = row[w[m, None] + np.arange(4)]
        else:
            for k in range(4):
                m = w + k < self.W
                out[m, k] = row[w[m] + k]
        return out

    def store(self, row, w, v):
        if self.vec:
            m = w < self.W
            row[w[m, None] + np.arange(4)] = v[m]
        else:
            for k in range(4):
                m = w + k < self.W
                row[w[m] + k] = v[m, k]


class Tile:
    """One block of ``rglru_scan_kernel``, from its ticket: the scan warps'
    part (``publish``), the carry warp's (``fold``, as many times as it
    finds newly published chunks), which run at the same time, and the
    stores after the block's barrier (``store``)."""

    def __init__(self, L: Launch):
        self.L = L
        tk = L.ticket                                 # atomicAdd(ticket, 1)
        L.ticket += 1
        per_chunk = L.B * L.ntw
        self.c, self.bb, self.wt = (tk // per_chunk,
                                    tk % per_chunk // L.ntw, tk % L.ntw)
        self.w = self.wt * KTILE + 4 * LANES
        self.first = self.bb * L.nc * L.ntw + self.wt   # chunk 0's tile
        self.col = self.bb * L.ntw + self.wt
        self.carry = (np.zeros((32, 4), F32) if L.rev
                      else L.load(L.h0[self.bb], self.w, 0.0))
        self.j = 0                                      # chunks folded

    def publish(self):
        """(1)-(2): loads, each warp's scan from zero, the warp-order
        composition; the chunk aggregate, then its done bit."""
        L, c, bb = self.L, self.c, self.bb
        s_p = np.full((KWARPS, 32, 4), np.nan, F32)
        s_h = np.full((KWARPS, 32, 4), np.nan, F32)
        P = np.empty((KWARPS, KSTEPS, 32, 4), F32)
        H = np.empty((KWARPS, KSTEPS, 32, 4), F32)
        for warp in range(KWARPS):
            t0 = c * KCHUNK + warp * KSTEPS
            for s in range(KSTEPS):
                if t0 + s < L.T:
                    t = L.step(t0 + s)
                    if not L.rev:
                        P[warp, s] = L.load(L.a[bb, t], self.w, 1.0)
                    elif t + 1 < L.T:                 # a_{t+1}
                        P[warp, s] = L.load(L.a[bb, t + 1], self.w, 1.0)
                    else:
                        P[warp, s] = 1.0
                    H[warp, s] = L.load(L.b[bb, t], self.w, 0.0)
                else:
                    P[warp, s], H[warp, s] = 1.0, 0.0
            for s in range(1, KSTEPS):
                H[warp, s] = _fma(P[warp, s], H[warp, s - 1], H[warp, s])
                P[warp, s] = P[warp, s] * P[warp, s - 1]
            s_p[warp], s_h[warp] = P[warp, -1], H[warp, -1]
        # __syncthreads()
        for warp in range(1, KWARPS):
            pw, hw = s_p[0].copy(), s_h[0].copy()
            for j in range(1, warp):
                hw = _fma(s_p[j], hw, s_h[j])
                pw = s_p[j] * pw
            for s in range(KSTEPS):
                H[warp, s] = _fma(P[warp, s], hw, H[warp, s])
                P[warp, s] = P[warp, s] * pw
        mine = (bb * L.nc + c) * L.ntw + self.wt
        if c + 1 < L.nc:
            L.agg_p[mine], L.agg_h[mine] = P[-1, -1], H[-1, -1]
            L.done[self.col, c // 64] |= np.uint64(1 << (c % 64))
        self.P, self.H = P, H

    def ready(self) -> int:
        """The carry warp's poll: how many chunks from the next one to fold
        are published, the set bits from bit j % 64 of word j / 64 of the
        column's done words (at most c - j)."""
        L, j = self.L, self.j
        word = int(L.done[self.col, j // 64]) >> (j % 64)
        n = 0
        while word >> n & 1 and n < 64 - j % 64:
            n += 1
        return min(n, self.c - j)

    def fold(self):
        """(3): the carry warp folds the published chunks it has not folded
        yet into the carry (h0 before chunk 0), in chunk order."""
        L = self.L
        ready = self.ready()
        assert ready > 0, "the kernel would still be waiting"
        end = self.j + ready
        while self.j < end:                 # staged kStage at a time
            n = min(KSTAGE, end - self.j)
            s_agg = np.full((KSTAGE, 2, 32, 4), np.nan, F32)
            for k in range(n):
                at = self.first + (self.j + k) * L.ntw
                s_agg[k] = L.agg_p[at], L.agg_h[at]
            for k in range(n):
                self.carry = _fma(s_agg[k, 0], self.carry, s_agg[k, 1])
            self.j += n

    def store(self):
        """(4), after the block's barrier: every output once."""
        L, bb = self.L, self.bb
        assert self.j == self.c
        s_carry = np.full((32, 4), np.nan, F32)
        s_carry[:] = self.carry
        for warp in range(KWARPS):
            t0 = self.c * KCHUNK + warp * KSTEPS
            for s in range(KSTEPS):
                if t0 + s >= L.T:
                    continue
                t = L.step(t0 + s)
                g = _fma(self.P[warp, s], s_carry, self.H[warp, s])
                L.store(L.h[bb, t], self.w, g)
                if not L.rev:
                    continue
                # (5): db = g, da = g h_{t-1} (h0 at t = 0), dh0 = a_0 g_0
                prev = L.load(L.hf[bb, t - 1] if t > 0 else L.h0[bb],
                              self.w, 0.0)
                L.store(L.da[bb, t], self.w, (g * prev).astype(F32))
                if t == 0:
                    L.store(L.dh0[bb], self.w,
                            (L.load(L.a[bb, 0], self.w, 0.0) * g).astype(
                                F32))


def run(a, b, h0, vec=None, rng=None, hf=None):
    """h as the kernel computes it (with ``hf``, the forward's h, and b the
    gradient dh: (da, db, dh0) as the reverse scan computes them). With
    ``rng`` the blocks run in a random interleaving the kernel allows;
    without, one after another in ticket order."""
    a, b, h0 = (np.ascontiguousarray(x, F32) for x in (a, b, h0))
    L = Launch(a, b, h0, vec, hf=None if hf is None else
               np.ascontiguousarray(hf, F32))
    _run(L, rng)
    return (L.da, L.h, L.dh0) if L.rev else L.h


def run_bwd(a, h, h0, dh, vec=None, rng=None):
    """(da, db, dh0) of ``rglru_scan_bwd_launch``."""
    return run(a, dh, h0, vec=vec, rng=rng, hf=h)


def _run(L, rng):
    if rng is None:
        for _ in range(L.n):
            t = Tile(L)
            t.publish()
            while t.j < t.c:
                t.fold()
            t.store()
        return
    running, stored = [], 0
    while stored < L.n:
        moves = [("start", None)] if L.ticket < L.n else []
        for t in running:
            if not t.published:
                moves.append(("publish", t))
            if t.j < t.c and t.ready():
                moves.append(("fold", t))
            if t.published and t.j == t.c:
                moves.append(("store", t))
        what, t = moves[rng.integers(len(moves))]
        if what == "start":
            t = Tile(L)
            t.published = False
            running.append(t)
            continue
        getattr(t, what)()
        if what == "publish":
            t.published = True
        elif what == "store":
            running.remove(t)
            stored += 1


def _case(seed, B, T, W, h0=True):
    """a in (0.5, 1) (the model's decays lie in (0, 1)), b normal, h0
    normal or zero, as ``tests/test_torch_kernels.py`` draws them."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, T, W)).astype(F32)
    b = rng.standard_normal((B, T, W)).astype(F32)
    h0v = (rng.standard_normal((B, W)) if h0 else np.zeros((B, W))).astype(
        F32)
    return a, b, h0v


def _plain(a, b, h0):
    return RS.rglru_scan_ref(*(torch.from_numpy(x) for x in (a, b,
                                                            h0))).numpy()


class TestTransliteration:
    @pytest.mark.parametrize("B,T,W", [
        (1, 1, 64),        # one step
        (2, 37, 3),        # below one chunk, off float4
        (1, 300, 100),     # off the chunk and the warp split
        (3, 1000, 130),    # B 3, two channel tiles, the second ragged
        (1, 130, 1),       # one channel: the scalar path's single lane
        (1, 64 * KCHUNK + 70, 5),   # past 64 chunks: two done words
    ])
    def test_matches_plain_and_scan_lru_with_a_carried_state(self, B, T, W):
        a, b, h0 = _case(B * 1000 + T + W, B, T, W)
        got = run(a, b, h0)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, _plain(a, b, h0), **TOL)
        want = np.asarray(_scan_lru(*(jnp.asarray(x) for x in (a, b, h0))))
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("B,T,W", [(2, 40, 64), (1, 96, 130)])
    def test_matches_pallas_and_ref_from_zero(self, B, T, W):
        """From h0 = 0, the function of the Pallas kernel (interpret mode;
        its pad-and-slice path, T and W off its blocks) and of ref.py."""
        a, b, h0 = _case(T + W, B, T, W, h0=False)
        got = run(a, b, h0)
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        np.testing.assert_allclose(
            got, np.asarray(pallas_rglru(ja, jb, block_t=16, block_w=128,
                                         interpret=True)), **TOL)
        np.testing.assert_allclose(got, np.asarray(jax_rglru_ref(ja, jb)),
                                   **TOL)

    @pytest.mark.parametrize("T,W", [(300, 64), (70, 128), (1, 4)])
    def test_the_scalar_edge_path_gives_the_float4_paths_bits(self, T, W):
        a, b, h0 = _case(T * W, 2, T, W)
        np.testing.assert_array_equal(run(a, b, h0, vec=False),
                                      run(a, b, h0, vec=True))

    @pytest.mark.parametrize("length", [1, KSTEPS, KSTEPS + 3, KCHUNK,
                                        KCHUNK + 1, 700])
    def test_identity_steps_keep_the_state_bit_for_bit(self, length):
        """Padded steps arrive as a = 1, b = 0: h[:, -1] is h[:, length-1]
        exactly, whether the last true step ends a warp's steps, a chunk or
        neither."""
        a, b, h0 = _case(length, 2, 1000, 100)
        a[:, length:], b[:, length:] = 1.0, 0.0
        h = run(a, b, h0)
        np.testing.assert_array_equal(h[:, -1], h[:, length - 1])
        np.testing.assert_array_equal(h[:, length:],
                                      np.broadcast_to(h[:, length - 1:length],
                                                      h[:, length:].shape))


class TestInvariants:
    @settings(max_examples=6, deadline=None, database=None)
    @given(T=st.integers(1, 4 * KCHUNK + 5), W=st.integers(1, 2 * KTILE + 3),
           B=st.integers(1, 2), seed=st.integers(0, 10_000))
    def test_any_order_the_tickets_allow_gives_the_same_bits(self, T, W, B,
                                                            seed):
        a, b, h0 = _case(seed, B, T, W)
        want = run(a, b, h0)
        for k in range(3):
            got = run(a, b, h0, rng=np.random.default_rng(seed + k))
            np.testing.assert_array_equal(got, want)

    def test_past_64_chunks_any_order_gives_the_same_bits(self):
        a, b, h0 = _case(7, 1, 64 * KCHUNK + 70, 5)
        np.testing.assert_array_equal(
            run(a, b, h0, rng=np.random.default_rng(7)), run(a, b, h0))

    @settings(max_examples=4, deadline=None, database=None)
    @given(T=st.integers(1, 3 * KCHUNK + 7), W=st.integers(1, KTILE + 9),
           seed=st.integers(0, 10_000))
    def test_a_rows_bits_do_not_depend_on_B_or_its_position(self, T, W,
                                                           seed):
        a, b, h0 = _case(seed, 3, T, W)
        together = run(a, b, h0, rng=np.random.default_rng(seed))
        for r in range(3):
            alone = run(a[r:r + 1], b[r:r + 1], h0[r:r + 1])
            np.testing.assert_array_equal(together[r:r + 1], alone)


# ---------------------------------------------------------------------------
# the backward: the same kernel in reverse (kRev)
# ---------------------------------------------------------------------------

def _bwd_case(seed, B, T, W):
    a, b, h0 = _case(seed, B, T, W)
    h = _plain(a, b, h0)
    dh = np.random.default_rng(seed + 1).standard_normal((B, T, W)).astype(
        F32)
    return a, h, h0, dh


def _plain_bwd(a, h, h0, dh):
    return [t.numpy() for t in RS.rglru_scan_bwd_ref(
        *(torch.from_numpy(x) for x in (a, h, h0, dh)))]


class TestReverseScan:
    @pytest.mark.parametrize("B,T,W", [
        (1, 1, 64),        # one step: g = dh, dh0 = a_0 dh_0
        (2, 37, 3),        # below one chunk, off float4
        (1, 300, 100),     # off the chunk and the warp split
        (3, 1000, 130),    # B 3, two channel tiles, the second ragged
        (1, 64 * KCHUNK + 70, 5),   # past 64 chunks: two done words
    ])
    def test_matches_the_plain_backward(self, B, T, W):
        a, h, h0, dh = _bwd_case(B + T + W, B, T, W)
        got = run_bwd(a, h, h0, dh)
        for g_, w_ in zip(got, _plain_bwd(a, h, h0, dh)):
            assert np.isfinite(g_).all()
            np.testing.assert_allclose(g_, w_, **TOL)

    @pytest.mark.parametrize("T,W", [(300, 64), (70, 128)])
    def test_the_scalar_edge_path_gives_the_float4_paths_bits(self, T, W):
        a, h, h0, dh = _bwd_case(T * W, 2, T, W)
        for x, y in zip(run_bwd(a, h, h0, dh, vec=False),
                        run_bwd(a, h, h0, dh, vec=True)):
            np.testing.assert_array_equal(x, y)

    @settings(max_examples=5, deadline=None, database=None)
    @given(T=st.integers(1, 4 * KCHUNK + 5), W=st.integers(1, 2 * KTILE + 3),
           B=st.integers(1, 2), seed=st.integers(0, 10_000))
    def test_any_order_the_tickets_allow_gives_the_same_bits(self, T, W, B,
                                                            seed):
        a, h, h0, dh = _bwd_case(seed, B, T, W)
        want = run_bwd(a, h, h0, dh)
        for k in range(2):
            got = run_bwd(a, h, h0, dh, rng=np.random.default_rng(seed + k))
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)

    @settings(max_examples=3, deadline=None, database=None)
    @given(T=st.integers(1, 3 * KCHUNK + 7), W=st.integers(1, KTILE + 9),
           seed=st.integers(0, 10_000))
    def test_a_rows_bits_do_not_depend_on_B_or_its_position(self, T, W,
                                                           seed):
        a, h, h0, dh = _bwd_case(seed, 3, T, W)
        together = run_bwd(a, h, h0, dh, rng=np.random.default_rng(seed))
        for r in range(3):
            alone = run_bwd(*(x[r:r + 1] for x in (a, h, h0, dh)))
            for x, y in zip(together, alone):
                np.testing.assert_array_equal(x[r:r + 1], y)

    def test_tickets_start_from_the_last_chunk(self):
        """The first ticket's tile holds the last real steps: its carry is
        0 and it waits on no other tile."""
        a, h, h0, dh = _bwd_case(3, 1, 3 * KCHUNK + 5, 8)
        L = Launch(a, dh, h0, hf=h)
        t = Tile(L)
        assert t.c == 0 and L.step(0) == L.T - 1
        assert not t.carry.any()

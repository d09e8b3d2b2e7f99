"""The split-KV decode-attention kernels (``csrc/decode_attention.cu``),
transliterated into numpy lane by lane and held to the reference's Pallas
kernels in interpret mode and its oracle on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to
their plain versions there). This transliteration follows their steps,
with the kernel's constants read from the source: splits of ``kChunk``
logical rows, one block each, that return at once past the row's length;
each warp's tiles of ``kRows`` rows (``warp``, ``warp + kWarps``, ...)
through its own two-stage ring, filled by 16-byte copies zero-filled past
the length (paged rows through the block table), that land only at the
wait that covers their group, the first two before q is read; each
route's tile: the f32 route on the CUDA cores (two score lanes a row over
alternate chunks, one shuffle, butterflies for the tile's max and sum, p
shuffled to the PV lanes, which own one 16-byte chunk of D each and sum
their row groups at the end) and the bf16 route on mma.sync m16n8k16
(S^T = K Q^T with the rows as M and the heads as N, the ldmatrix lane
addresses, plain for K and ``.trans`` for V, the fragment layouts, the
softmax on the C fragments with three shuffles across the group, two
movmatrix.trans for P^T, O^T += V^T P^T); the merge of the warps in warp
order; and the combine of the splits below the length in split order from
a workspace whose slots are padded to 16 bytes. Shared memory and the
workspace start as NaN, so anything read before it is written shows.
Values stay f32 on both routes (p is not rounded to bf16): this checks
indexing, not bf16 rounding. Tolerance 1e-5 (f32 sums in another order
than the references').
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.decode_attention.decode_attention import (
    decode_attention as pallas_decode, paged_decode_attention as pallas_paged)
from repro.kernels.decode_attention.ref import decode_attention_ref

TOL = dict(atol=1e-5, rtol=1e-5)
F32 = np.float32
NEG_INF = F32(-1e30)
LANES = np.arange(32)
SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
       "kernels" / "decode_attention" / "csrc" / "decode_attention.cu")


def _const(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SRC.read_text())
    return int(m.group(1))


K_WARPS, K_ROWS, K_CHUNK, K_MAXG = (_const(n) for n in (
    "kWarps", "kRows", "kChunk", "kMaxG"))
SLOT_FLOATS = "g * D + ((2 * g + 3) & ~3)"


def slot_floats(g, D):
    """Workspace floats of one split's partial: acc [g, D], then m [g] and
    l [g], padded to 16 bytes. The kernel's formula, pinned to its source
    by test_slot_floats_is_the_kernels."""
    return g * D + ((2 * g + 3) & ~3)


class Dense:
    """Rows of one (batch row, KV head) of a dense cache [S, D]."""

    def __init__(self, k, v):
        self.k, self.v = k, v

    def rows(self, r):
        return self.k[r], self.v[r]


class Paged:
    """Rows through one batch row's block table, for one KV head of the
    pool [P, page, D]."""

    def __init__(self, pk, pv, table, page):
        self.pk, self.pv, self.table, self.page = pk, pv, table, page

    def rows(self, r):
        pid = self.table[r // self.page]
        return self.pk[pid, r % self.page], self.pv[pid, r % self.page]


def _butterfly(x, op, masks):
    for o in masks:
        x = op(x, x[LANES ^ o])
    return x


class FmaWarp:
    """The f32 route (``FmaCore``): two score lanes a row over alternate
    16-byte chunks against q in shared memory, one shuffle, butterflies for
    the tile's max and sum over 16 rows; PV lanes own one chunk of D for
    every head, p shuffled from score lane r, row groups summed at the
    end."""

    VEC = 4

    def __init__(self, q, D):
        self.g = q.shape[0]
        self.D = D
        self.sq = np.full((K_MAXG, D), np.nan, F32)
        self.sq[:self.g] = q
        self.cpr = D // self.VEC
        self.rp = 32 // self.cpr
        self.acc = np.zeros((32, self.g, self.VEC), F32)
        self.m = np.full(self.g, NEG_INF, F32)
        self.l = np.zeros(self.g, F32)

    def tile(self, ks, vs, nvalid, scale):
        g, vec, cpr, rp = self.g, self.VEC, self.cpr, self.rp
        sr, sh = LANES & 15, LANES >> 4
        pc, pr = LANES % cpr, LANES // cpr
        s = np.zeros((32, g), F32)
        for u in range(cpr // 2):
            c = 2 * u + sh
            for e in range(vec):
                col = c * vec + e
                s = s + self.sq[:g, col].T * ks[sr, col][:, None]
        x = s + s[LANES ^ 16]
        x = np.where((sr < nvalid)[:, None], x * scale, NEG_INF)
        mt = _butterfly(x, np.maximum, (8, 4, 2, 1))
        m_new = np.maximum(self.m, mt[0])
        pe = np.exp(x - m_new)
        st = _butterfly(pe, np.add, (8, 4, 2, 1))
        alpha = np.exp(self.m - m_new)
        self.l = self.l * alpha + st[0]
        self.m = m_new
        self.acc = self.acc * alpha[None, :, None]
        for u in range(K_ROWS // rp):
            r = pr + rp * u
            vf = vs[r[:, None], pc[:, None] * vec + np.arange(vec)]
            w = pe[r]                            # shuffled from lane r
            self.acc = self.acc + w[:, :, None] * vf[:, None, :]

    def park(self):
        acc = _butterfly(self.acc, np.add,
                         [o for o in (1, 2, 4, 8, 16) if o >= self.cpr])
        acc_w = np.full((self.g, self.D), np.nan, F32)
        for lane in range(self.cpr):             # row group 0's lanes
            acc_w[:, lane * self.VEC:(lane + 1) * self.VEC] = acc[lane]
        return acc_w, self.m, self.l


G, TG = LANES // 4, LANES % 4                    # mma groupID, thread in group
LR, LM = LANES % 8, LANES // 8                   # ldmatrix row, matrix


def _ldmatrix_x4(tile, rows, cols, trans):
    """ldmatrix.m8n8.x4 on a staged [rows, D] tile: lane l supplies row
    rows[l], columns cols[l] .. + 7 of matrix l // 8. Returns [32 lanes, 4
    regs, 2 halves]."""
    mats = tile[rows[:, None], cols[:, None] + np.arange(8)].reshape(4, 8, 8)
    if trans:
        mats = mats.transpose(0, 2, 1)
    # lane T gets row T // 4, columns 2 (T % 4) + {0, 1} of each matrix
    return mats[:, G, :].reshape(4, 32, 4, 2)[:, LANES, TG].transpose(1, 0, 2)


def _mma(acc, a, b0, b1):
    """acc [32, 4] += A . B, with A [16, 16] and B [16, 8] gathered from
    the lanes' fragments as PTX's m16n8k16 layout places them."""
    A = np.empty((16, 16), F32)
    B = np.empty((16, 8), F32)
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


def _movmatrix_t(x):
    """movmatrix.m8n8.trans: lane T holds row T // 4, columns 2 (T % 4) +
    {0, 1} of an 8 x 8 matrix; returns the transpose in that layout."""
    M = np.empty((8, 8), F32)
    M[G, 2 * TG], M[G, 2 * TG + 1] = x[:, 0], x[:, 1]
    return np.stack([M[2 * TG, G], M[2 * TG + 1, G]], axis=1)


class TcWarp:
    """The bf16 route (``TcCore``) on mma.sync m16n8k16: S^T = K Q^T with
    the 16 rows as M and the heads as N (zero columns past g), Q^T's B
    fragments in registers, K by ldmatrix; the softmax on the C fragments
    (three shuffles across gq); two movmatrix.trans turn p into P^T's B
    fragments; O^T += V^T P^T with V by ldmatrix.trans."""

    VEC = 8

    def __init__(self, q, D):
        self.g, self.D, self.ks = q.shape[0], D, D // 16
        qp = np.zeros((8, D), F32)
        qp[:self.g] = q
        self.qf = [[np.stack([qp[G, kk * 16 + hf * 8 + 2 * TG + j]
                              for j in range(2)], axis=1)
                    for hf in range(2)] for kk in range(self.ks)]
        self.o = np.zeros((self.ks, 32, 4), F32)
        self.m = np.full((32, 2), NEG_INF, F32)
        self.l = np.zeros((32, 2), F32)

    def tile(self, ks, vs, nvalid, scale):
        s = np.zeros((32, 4), F32)
        for kk in range(self.ks):
            a = _ldmatrix_x4(ks, (LM & 1) * 8 + LR, (LM >> 1) * 8 + kk * 16,
                             False)
            _mma(s, a, *self.qf[kk])
        rows = G[:, None] + 8 * (np.arange(4) >> 1)[None]
        s = np.where(rows < nvalid, s * scale, NEG_INF)
        alpha = np.empty((32, 2), F32)
        for hc in range(2):
            mt = _butterfly(np.maximum(s[:, hc], s[:, 2 + hc]), np.maximum,
                            (4, 8, 16))
            m_new = np.maximum(self.m[:, hc], mt)
            s[:, hc] = np.exp(s[:, hc] - m_new)
            s[:, 2 + hc] = np.exp(s[:, 2 + hc] - m_new)
            st = _butterfly(s[:, hc] + s[:, 2 + hc], np.add, (4, 8, 16))
            alpha[:, hc] = np.exp(self.m[:, hc] - m_new)
            self.l[:, hc] = self.l[:, hc] * alpha[:, hc] + st
            self.m[:, hc] = m_new
        b0, b1 = _movmatrix_t(s[:, 0:2]), _movmatrix_t(s[:, 2:4])
        for t in range(self.ks):
            a = _ldmatrix_x4(vs, (LM >> 1) * 8 + LR, (LM & 1) * 8 + 16 * t,
                             True)
            self.o[t] *= alpha[:, [0, 1, 0, 1]]
            _mma(self.o[t], a, b0, b1)

    def park(self):
        g, D = self.g, self.D
        acc_w = np.full((g, D), np.nan, F32)
        m_w, l_w = np.full(g, np.nan, F32), np.full(g, np.nan, F32)
        for t in range(self.ks):
            for e in range(4):
                hh = 2 * TG + (e & 1)
                ok = hh < g
                acc_w[hh[ok], (16 * t + G + 8 * (e >> 1))[ok]] = \
                    self.o[t][ok, e]
        for e in range(2):
            hh = 2 * TG + e
            ok = (G == 0) & (hh < g)
            m_w[hh[ok]], l_w[hh[ok]] = self.m[ok, e], self.l[ok, e]
        return acc_w, m_w, l_w


ROUTES = {"f32": FmaWarp, "bf16": TcWarp}


def split_block(q, src, length, j, chunk, route):
    """Split j of one (batch row, KV head) on ``route``: q [g, D] f32 ->
    its (acc [g, D], m [g], l [g]), or None when it starts at or past the
    length."""
    core = ROUTES[route]
    g, D = q.shape
    c0 = j * chunk
    if c0 >= length:
        return None
    c1 = min(c0 + chunk, length)
    vec = core.VEC                       # elements a 16-byte copy moves
    cpr = D // vec                       # copies a row
    cpl = K_ROWS * cpr // 32             # copies a lane issues, K and V each
    scale = F32(1.0 / math.sqrt(D))
    n_tiles = -(-(c1 - c0) // K_ROWS)
    ecols = np.arange(vec)
    states = []
    for warp in range(K_WARPS):
        n_mine = (n_tiles - warp + K_WARPS - 1) // K_WARPS \
            if n_tiles > warp else 0
        ring = np.full((2, 2, K_ROWS, D), np.nan, F32)  # slot, K/V, row, d
        pending, group = [], []

        def tile_row(i):
            return c0 + (warp + K_WARPS * i) * K_ROWS

        def load_tile(i):
            """Tile i into slot i & 1, one commit group (empty past the
            warp's last tile)."""
            if i < n_mine:
                r0 = tile_row(i)
                e = LANES[:, None] + 32 * np.arange(cpl)[None]
                r, c = (e // cpr).ravel(), (e % cpr).ravel()
                ok = r0 + r < c1
                kd = np.zeros((r.size, vec), F32)
                vd = np.zeros((r.size, vec), F32)
                if ok.any():
                    kr, vr = src.rows(r0 + r[ok])
                    cols = c[ok, None] * vec + ecols
                    kd[ok] = np.take_along_axis(kr, cols, 1)
                    vd[ok] = np.take_along_axis(vr, cols, 1)
                group.append((i & 1, r, c, kd, vd))
            pending.append(list(group))
            group.clear()

        def wait(n):
            while len(pending) > n:
                for slot, r, c, kd, vd in pending.pop(0):
                    cols = c[:, None] * vec + ecols
                    ring[slot, 0, r[:, None], cols] = kd
                    ring[slot, 1, r[:, None], cols] = vd

        load_tile(0)
        load_tile(1)
        warp_core = core(q, D)
        for i in range(n_mine):
            wait(1)
            warp_core.tile(ring[i & 1, 0], ring[i & 1, 1], c1 - tile_row(i),
                           scale)
            load_tile(i + 2)
        wait(0)
        states.append(warp_core.park())

    mx = np.full(g, NEG_INF, F32)
    for _, m_w, _ in states:
        mx = np.maximum(mx, m_w)
    o = np.zeros((g, D), F32)
    lsum = np.zeros(g, F32)
    for acc_w, m_w, l_w in states:       # warp order
        e = np.exp(m_w - mx)
        o = o + acc_w * e[:, None]
        lsum = lsum + l_w * e
    return o, mx, lsum


def transliteration(q, srcs, lengths, S, route, chunk=K_CHUNK):
    """q [B, Hq, D] f32; srcs[b][h] a Dense or Paged row source; S the rows
    a batch row can hold. Returns (out [B, Hq, D], the workspace)."""
    B, Hq, D = q.shape
    Hkv = len(srcs[0])
    g = Hq // Hkv
    nsplit = -(-S // chunk)
    ws = np.full((B, Hkv, nsplit, slot_floats(g, D)), np.nan, F32)
    for b in range(B):
        length = min(max(int(lengths[b]), 0), S)
        for h in range(Hkv):
            for j in range(nsplit):
                part = split_block(q[b, h * g:(h + 1) * g], srcs[b][h],
                                   length, j, chunk, route)
                if part is not None:
                    acc, m, l = part
                    ws[b, h, j, :g * (D + 2)] = np.concatenate(
                        [acc.ravel(), m, l])
    out = np.zeros((B, Hq, D), F32)
    for b in range(B):
        length = min(max(int(lengths[b]), 0), S)
        n = -(-length // chunk)
        if n == 0:
            continue
        for h in range(Hkv):
            slots = ws[b, h, :n]
            acc = slots[:, :g * D].reshape(n, g, D)
            m = slots[:, g * D:g * D + g]
            l = slots[:, g * D + g:g * D + 2 * g]
            mx = np.full(g, NEG_INF, F32)
            for jj in range(n):
                mx = np.maximum(mx, m[jj])
            o = np.zeros((g, D), F32)
            lsum = np.zeros(g, F32)
            for jj in range(n):          # split order
                e = np.exp(m[jj] - mx)
                o = o + acc[jj] * e[:, None]
                lsum = lsum + l[jj] * e
            out[b, h * g:(h + 1) * g] = (
                o / np.maximum(lsum, F32(1e-37))[:, None])
    return out, ws


def _dense_srcs(k, v):
    """k/v [B, Hkv, S, D] -> row sources."""
    return [[Dense(k[b, h], v[b, h]) for h in range(k.shape[1])]
            for b in range(k.shape[0])]


def _paged_srcs(pk, pv, tables, page):
    """pool [P, page, Hkv, D], tables [B, pps] -> row sources."""
    return [[Paged(pk[:, :, h], pv[:, :, h], tables[b], page)
             for h in range(pk.shape[2])] for b in range(tables.shape[0])]


S_DENSE = 2 * K_CHUNK + 37
LENGTHS = np.array([0, 1, K_CHUNK - 1, K_CHUNK, K_CHUNK + 1, S_DENSE],
                   np.int32)


def _case(seed, g, D, S=S_DENSE, Hkv=2, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = rng.standard_normal((B, Hkv * g, D)).astype(F32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(F32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(F32)
    return q, k, v, lengths


def _paged_from(k, v, lengths, page, seed, extra=3):
    """The dense rows below each length scattered over a shuffled pool;
    table entries past a row's length stay 0 (the scratch page); every page
    no row owns, page 0 included, holds finite garbage."""
    rng = np.random.default_rng(seed)
    B, Hkv, S, D = k.shape
    pps = -(-S // page) + 1              # pps * page != S
    P = 1 + B * pps + extra
    perm = 1 + rng.permutation(P - 1)
    pk = np.full((P, page, Hkv, D), 1e4, F32)
    pv = np.full((P, page, Hkv, D), -1e4, F32)
    tables = np.zeros((B, pps), np.int32)
    for b in range(B):
        for jp in range(-(-int(lengths[b]) // page)):
            pid = perm[b * pps + jp]
            tables[b, jp] = pid
            rows = slice(jp * page, min((jp + 1) * page, S))
            n = rows.stop - rows.start
            pk[pid, :n] = np.moveaxis(k[b, :, rows], 0, 1)
            pv[pid, :n] = np.moveaxis(v[b, :, rows], 0, 1)
    return pk, pv, tables, pps


_pallas_cache = {}


def _pallas_dense(seed, g, D):
    if (seed, g, D) not in _pallas_cache:
        q, k, v, lengths = _case(seed, g, D)
        args = [jnp.asarray(a) for a in (q, k, v, lengths)]
        _pallas_cache[seed, g, D] = (
            np.asarray(pallas_decode(*args, block_kv=128, interpret=True)),
            np.asarray(decode_attention_ref(*args)))
    return _pallas_cache[seed, g, D]


def test_slot_floats_is_the_kernels():
    """The workspace slot of the transliteration is the kernel's (the
    wrapper sizes the workspace through the library, which computes it
    there), and every slot starts on 16 bytes, as the combine's float4
    reads need."""
    m = re.search(r"int slot_floats\(int g, int D\) \{\s*return ([^;]+);",
                  SRC.read_text())
    assert m.group(1) == SLOT_FLOATS
    for g in range(1, K_MAXG + 1):
        for D in (32, 64, 128):
            n = slot_floats(g, D)
            assert n % 4 == 0 and n >= g * (D + 2)


@pytest.mark.parametrize("route", ["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_dense_matches_pallas_and_ref(g, D, route):
    """Lengths 0, 1, kChunk - 1, kChunk, kChunk + 1 and S: the Pallas
    kernel everywhere (zeros at length 0), the oracle where length > 0."""
    seed = 10 * g + D
    q, k, v, lengths = _case(seed, g, D)
    out, _ = transliteration(q, _dense_srcs(k, v), lengths, S_DENSE,
                             route)
    pal, ref = _pallas_dense(seed, g, D)
    np.testing.assert_allclose(out, pal, **TOL)
    live = lengths > 0
    np.testing.assert_allclose(out[live], ref[live], **TOL)
    assert not out[~live].any()


@pytest.mark.parametrize("g,D,page", [(4, 128, 48), (8, 64, 24),
                                      (1, 32, 100)])
def test_paged_is_dense_bit_for_bit(g, D, page):
    """A page size that does not divide kChunk, a shuffled table and a pool
    of pps * page != S rows: the same bits as the dense layout, and the
    Pallas paged kernel within tolerance."""
    q, k, v, lengths = _case(7 * page, g, D)
    pk, pv, tables, pps = _paged_from(k, v, lengths, page, seed=page)
    assert pps * page != S_DENSE and K_CHUNK % page
    for route in ROUTES:
        dense, _ = transliteration(q, _dense_srcs(k, v), lengths, S_DENSE,
                                   route)
        paged, _ = transliteration(q, _paged_srcs(pk, pv, tables, page),
                                   lengths, pps * page, route)
        assert np.array_equal(dense, paged)
    pal = np.asarray(pallas_paged(*(jnp.asarray(a) for a in (
        q, pk, pv, lengths, tables)), interpret=True))
    np.testing.assert_allclose(paged, pal, **TOL)


def test_same_rows_same_bits_under_two_buffer_sizes():
    """The engine's dense S (max_len) and a longer buffer whose extra rows
    hold garbage: the rows below each length give the same bits."""
    q, k, v, lengths = _case(3, 4, 64)
    S2 = 4 * K_CHUNK + 5
    rng = np.random.default_rng(4)
    k2 = rng.standard_normal(k.shape[:2] + (S2, 64)).astype(F32) * 1e3
    v2 = rng.standard_normal(k.shape[:2] + (S2, 64)).astype(F32) * 1e3
    k2[:, :, :S_DENSE], v2[:, :, :S_DENSE] = k, v
    for route in ROUTES:
        a, _ = transliteration(q, _dense_srcs(k, v), lengths, S_DENSE, route)
        b, ws = transliteration(q, _dense_srcs(k2, v2), lengths, S2, route)
        assert ws.shape[2] > -(-S_DENSE // K_CHUNK)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("route", ["f32", "bf16"])
def test_dead_splits_are_never_written(route):
    """Workspace slots start as NaN; splits at or past a row's length stay
    NaN and the output is finite, so the combine never reads them."""
    q, k, v, lengths = _case(5, 4, 32)
    out, ws = transliteration(q, _dense_srcs(k, v), lengths, S_DENSE,
                              route)
    for b, length in enumerate(lengths):
        n = -(-int(length) // K_CHUNK)
        assert np.isnan(ws[b, :, n:]).all()
        assert not np.isnan(ws[b, :, :n, :4 * (32 + 2)]).any()
    assert np.isfinite(out).all()


@pytest.mark.parametrize("route", ["f32", "bf16"])
def test_split_partials_cover_exactly_their_rows(route):
    """Split j's (m, l, acc) are those of rows [j kChunk, (j + 1) kChunk)
    below the length, computed directly: a chunk boundary one row off
    moves l_j by ~1/kChunk of itself."""
    g, D = 4, 64
    q, k, v, lengths = _case(6, g, D)
    _, ws = transliteration(q, _dense_srcs(k, v), lengths, S_DENSE,
                            route)
    scale = 1.0 / math.sqrt(D)
    for b, length in enumerate(lengths):
        for h in range(2):
            for j in range(-(-int(length) // K_CHUNK)):
                rows = slice(j * K_CHUNK, min((j + 1) * K_CHUNK, length))
                s = q[b, h * g:(h + 1) * g].astype(np.float64) \
                    @ k[b, h, rows].T.astype(np.float64) * scale
                m = s.max(1)
                p = np.exp(s - m[:, None])
                slot = ws[b, h, j]
                np.testing.assert_allclose(slot[g * D:g * D + g], m, **TOL)
                np.testing.assert_allclose(slot[g * D + g:g * D + 2 * g],
                                           p.sum(1), **TOL)
                np.testing.assert_allclose(
                    slot[:g * D].reshape(g, D), p @ v[b, h, rows], **TOL)


def test_combine_takes_splits_in_order():
    """Three splits whose sums cancel only in split order: V rows of 2^16
    in split 0 (sum 2^24), a single 1 in split 1 and -2^16 in split 2, with
    all scores 0. In f32, (2^24 + 1) - 2^24 = 0 while (-2^24 + 1) + 2^24 =
    1: the kernel's order gives exactly 0, as the Pallas kernel's sequential
    kv-blocks of kChunk rows do."""
    D, S = 64, 3 * K_CHUNK
    q = np.ones((1, 2, D), F32)
    k = np.zeros((1, 1, S, D), F32)
    v = np.zeros((1, 1, S, D), F32)
    v[0, 0, :K_CHUNK] = 2.0 ** 16
    v[0, 0, K_CHUNK] = 1.0
    v[0, 0, 2 * K_CHUNK:] = -2.0 ** 16
    lengths = np.array([S], np.int32)
    pal = np.asarray(pallas_decode(*(jnp.asarray(a) for a in (
        q, k, v, lengths)), block_kv=K_CHUNK, interpret=True))
    assert not pal.any()
    for route in ROUTES:
        out, ws = transliteration(q, _dense_srcs(k, v), lengths, S, route)
        assert ws[0, 0, :, 0].tolist() == [2.0 ** 24, 1.0, -2.0 ** 24]
        assert not out.any()

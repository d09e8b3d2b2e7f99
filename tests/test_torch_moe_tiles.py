"""The tensor-core and the narrow variants of the grouped expert GEMMs
(``csrc/moe_gemm.cu``, namespaces ``tc`` and ``narrow``), transliterated
into numpy lane by lane and held to the plain versions on the CPU, and the
wrapper's rules that pick the variants.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to its
plain version there). This transliteration follows its index arithmetic
step for step — the cp.async ring with zero-fill, the ldmatrix lane
addresses (``.trans`` for the weight tile as the A operand, plain for x as
B), the m16n8k16 fragment layouts, the round-robin n8 tiles, the C-chunks
and the transposed epilogue through shared memory — on a flat shared
memory that starts as NaN, so any element the kernel reads without having
written it and lets into a kept output shows. Values stay f32: this checks
indexing, not bf16 rounding. Tolerance 1e-5 (f32 sums in another order
than the einsum of the plain version).

The int8-weight variant (namespace ``i8``: ``wgmma`` on int8 tiles a
producer loads by TMA) has its own transliteration on a flat shared memory
indexed by byte, NaN until written: the TMA boxes with their zero fill and
swizzles, the ring in the order the barriers allow, the dequantisation
into ``wgmma``'s A fragment (or into the swizzled bf16 tile the other
placement reads by descriptor), the k16 steps in increasing k and the
epilogue through the ring. On the card ``wgmma`` rounds each k16 step as
``mma.sync`` does (the bit probe in ``chip_smoke.py``), so its output is
held to ``as_weight`` followed by the bf16 variant's transliteration bit
for bit.

The narrow variant (f32 ``moe_gemm`` with D or F rank-sized) is
transliterated in f32 with its fma chains, its butterfly over the lanes and
its split order, so the bits of a row can be compared across C and row
positions.

The backward's K1, K2 and K3 (namespace ``wgrad``: ``wgmma`` fed by TMA,
outputs stored by TMA) are transliterated on a flat shared memory indexed
by byte, NaN until written: the TMA boxes with zero fill past every edge
and the 128-byte swizzle, the descriptors' K-major and MN-major
addressing, the rings, dy's resident slots (K3) and dout's tiles (K1) in
the order the mbarriers allow (the producer as far ahead as they let it;
a wait that cannot be met is a deadlock), the blocks' walk over units,
the k16 steps and the staged, TMA-stored outputs, each element of which
must be written exactly once. Held to the plain versions in f32, and, on
inputs whose f32 sums are exact, in bf16 bit for bit; K1's y to the fused
forward's transliteration bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.moe_gemm import moe_gemm as MG
from repro_torch.models import quant as Q

TOL = dict(atol=1e-5, rtol=1e-5)

# the kernel's block shapes (WM, WN, MT, NT, BK, S) as tc::dispatch picks
# them: by C (up to 64 rows or more) and by kernel (fused or not)
SHAPES = {(True, True): (8, 1, 1, 8, 32, 4),
          (True, False): (8, 1, 1, 8, 64, 4),
          (False, True): (8, 2, 1, 10, 64, 3),
          (False, False): (8, 2, 2, 10, 64, 3)}
SMALL_MAX_C = 64

LANES = np.arange(32)
G, TG = LANES // 4, LANES % 4            # groupID, thread in group


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


def _round_bf16(a):
    """f32 values rounded to bf16 (round to nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def tc_transliteration(x, sxe, sxc, wg, wu, swe, swd, E, C, D, F,
                       shape=None):
    """y [E, C, F] as tc_kernel computes it. x, wg, wu are flat f32 arrays
    read through element strides (x unit along D, w along F); wu None is
    moe_gemm, else moe_ffn_fused. ``shape`` forces a block shape."""
    fused = wu is not None
    WM, WN, MT, NT, BK, STAGES = shape or SHAPES[(C <= SMALL_MAX_C, fused)]
    BF, BN, nw = WM * MT * 16, WN * NT * 8, 2 if fused else 1
    XPITCH, WPITCH = BK + 8, BF + 8
    XSTAGE, WSTAGE = BN * XPITCH, BK * WPITCH
    STAGE = XSTAGE + nw * WSTAGE
    SMEM = STAGES * STAGE
    YPITCH = BF + 8
    nF = -(-F // BF)
    chunks = -(-C // BN)
    Cc = -(-C // chunks)                  # rows per chunk, then whole n8
    Cc = -(-Cc // 8) * 8
    assert Cc <= BN and BN * YPITCH <= SMEM
    y = np.full(E * C * F, np.nan, np.float32)
    nk = -(-D // BK)
    lr, lm = LANES % 8, LANES // 8

    for e in range(E):
        for bx in range(nF * chunks):
            f0, c0 = (bx % nF) * BF, (bx // nF) * Cc
            rows = min(Cc, C - c0)
            rows8 = (rows + 7) & ~7
            xe = e * sxe + c0 * sxc
            we = e * swe
            smem = np.full(SMEM, np.nan, np.float32)

            def load_stage(kt):
                st, k0 = (kt % STAGES) * STAGE, kt * BK
                for i in range(rows8 * (BK // 8)):
                    r, k = i // (BK // 8), k0 + (i % (BK // 8)) * 8
                    dst = st + r * XPITCH + k - k0
                    ok = r < rows and k < D
                    src = xe + r * sxc + k
                    smem[dst:dst + 8] = x[src:src + 8] if ok else 0.0
                for i in range(BK * BF // 8):
                    r, c = i // (BF // 8), (i % (BF // 8)) * 8
                    ok = k0 + r < D and f0 + c < F
                    off = we + (k0 + r) * swd + f0 + c
                    dst = st + XSTAGE + r * WPITCH + c
                    for w, buf in enumerate((wg, wu)[:nw]):
                        d = dst + w * WSTAGE
                        smem[d:d + 8] = buf[off:off + 8] if ok else 0.0

            accs = {}
            for kt in range(min(STAGES - 1, nk)):
                load_stage(kt)
            for kt in range(nk):
                if kt + STAGES - 1 < nk:
                    load_stage(kt + STAGES - 1)
                st = (kt % STAGES) * STAGE
                wt = st + XSTAGE
                for warp in range(WM * WN):
                    wm, wn = warp % WM, warp // WM

                    def load_a(ks):
                        return {(w, mt): _ldmatrix_x4(
                            smem, wt + w * WSTAGE
                            + (ks * 16 + lr + (lm >> 1) * 8) * WPITCH
                            + (wm * MT + mt) * 16 + (lm & 1) * 8, True)
                            for w in range(nw) for mt in range(MT)}

                    def load_b(ks, p):
                        if (2 * p * WN + wn) * 8 >= rows:
                            return None
                        return _ldmatrix_x4(
                            smem, st + (((2 * p + (lm >> 1)) * WN + wn) * 8
                                        + lr) * XPITCH + ks * 16
                            + (lm & 1) * 8, False)

                    # the kernel's order: fragments one step ahead, in
                    # buffers indexed by the parity of ks (A) and step (B)
                    a, b = [load_a(0), None], [load_b(0, 0), None]
                    for ks in range(BK // 16):
                        for p in range(NT // 2):
                            step = ks * (NT // 2) + p
                            if p + 1 < NT // 2:
                                b[(step + 1) & 1] = load_b(ks, p + 1)
                            elif ks + 1 < BK // 16:
                                a[(ks + 1) & 1] = load_a(ks + 1)
                                b[(step + 1) & 1] = load_b(ks + 1, 0)
                            for h in range(2):
                                j = 2 * p + h
                                if (j * WN + wn) * 8 >= rows:
                                    continue
                                bb = b[step & 1]
                                for (w, mt), av in a[ks & 1].items():
                                    acc = accs.setdefault(
                                        (warp, w, mt, j),
                                        np.zeros((32, 4), np.float32))
                                    _mma(acc, av, bb[:, 2 * h],
                                         bb[:, 2 * h + 1])

            # epilogue: (f, c) -> ys[c][f], then whole 8-element rows out
            ys = smem                                    # the ring, reused
            for warp in range(WM * WN):
                wm, wn = warp % WM, warp // WM
                for j in range(NT):
                    t = j * WN + wn
                    if t * 8 >= rows:
                        continue
                    for mt in range(MT):
                        for q in range(4):
                            f = (wm * MT + mt) * 16 + G + (q >> 1) * 8
                            c = t * 8 + TG * 2 + (q & 1)
                            v = accs[(warp, 0, mt, j)][:, q]
                            if fused:
                                u = accs[(warp, 1, mt, j)][:, q]
                                v = v / (1.0 + np.exp(-v)) * u
                            ys[c * YPITCH + f] = v
            for i in range(rows * (BF // 8)):
                r, c = i // (BF // 8), (i % (BF // 8)) * 8
                if f0 + c < F:
                    dst = (e * C + c0 + r) * F + f0 + c
                    y[dst:dst + 8] = ys[r * YPITCH + c:r * YPITCH + c + 8]
    return y.reshape(E, C, F)


def swiglu_bwd_np(g, u, d):
    """K1's epilogue in f32, in the kernel's (and the reference's jaxpr's)
    order."""
    g, u, d = (np.asarray(t, np.float32) for t in (g, u, d))
    s = np.float32(1) / (np.float32(1) + np.exp(-g))
    w = d * u
    return w * s + (g * w) * (s * (np.float32(1) - s)), (g * s) * d


def _case(seed, E, C, D, F, row_pad=0, empty=()):
    """x as a strided view (row_pad extra rows before row 0, so sxc = D and
    the base moves) and contiguous weights; the experts in ``empty`` get
    zero rows."""
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((E, C + row_pad, D)).astype(np.float32)
    for e in empty:
        xb[e] = 0.0
    wg = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    return xb, wg, wu


def _run(xb, wg, wu, C, row_pad, fused, shape=None):
    E, _, D = xb.shape
    F = wg.shape[2]
    flat = np.concatenate([xb.reshape(-1), np.zeros(8, np.float32)])
    x_view = flat[row_pad * D:]          # the view's base
    return tc_transliteration(
        x_view, (C + row_pad) * D, D, wg.reshape(-1),
        wu.reshape(-1) if fused else None, D * F, F, E, C, D, F, shape)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("E,C,D,F,row_pad,shape", [
    (2, 8, 48, 136, 0, None),       # decode C 8, F past one 128 tile, D 48
    (2, 9, 16, 72, 3, None),        # C 9 (a second, partial n8 tile), D 16
    (1, 1, 32, 8, 0, None),         # C 1, F 8
    (1, 161, 24, 24, 0, None),      # C > 64: chunks of 88 and 73 rows
    (2, 70, 40, 40, 1, (2, 2, 1, 2, 32, 4)),  # past a 32-row cap: 3 chunks
])
def test_transliteration_matches_plain(fused, E, C, D, F, row_pad, shape):
    xb, wg, wu = _case(E * 100 + C, E, C, D, F, row_pad, empty=(E - 1,))
    x = torch.from_numpy(xb[:, row_pad:])
    want = (MG.moe_ffn_fused_ref(x, torch.from_numpy(wg),
                                 torch.from_numpy(wu)) if fused
            else MG.moe_gemm_ref(x, torch.from_numpy(wg))).numpy()
    got = _run(xb, wg, wu, C, row_pad, fused, shape)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[E - 1].any()             # the empty expert gives zeros


def test_transliteration_past_the_cap_of_the_large_shape():
    """C 300 > the 160 rows a prefill block holds: two chunks of 152 and
    148 rows, each reading the whole D of its F-tile."""
    xb, wg, wu = _case(7, 1, 300, 16, 16)
    got = _run(xb, wg, wu, 300, 0, True)
    want = MG.moe_ffn_fused_ref(*(torch.from_numpy(a) for a in (xb, wg, wu)))
    np.testing.assert_allclose(got, want.numpy(), **TOL)


def test_a_row_depends_on_d_alone():
    """Rows 0-7 at C 160 (the prefill shape, 16 warps) equal the C 8
    output (the decode shape, 8 warps) bit for bit: each output is the
    same chain of k16 products in increasing k, whatever the chunking or
    the block shape."""
    xb, wg, wu = _case(11, 1, 160, 64, 32)
    wide = _run(xb, wg, wu, 160, 0, True)
    narrow = _run(xb[:, :8], wg, wu, 8, 0, True)
    assert np.array_equal(wide[:, :8], narrow)


# ---------------------------------------------------------------------------
# the narrow variant
# ---------------------------------------------------------------------------

KSPLIT, KVALS, KROWS, NARROW, KBATCH = 128, 64, 64, 16, 32
F32 = np.float32


def _fma(a, b, c):
    """fmaf: one rounding of the exact a * b + c (f64 holds a * b exactly)."""
    d = np.float64
    return (np.asarray(a, d) * np.asarray(b, d) + np.asarray(c, d)).astype(F32)


def narrow_f_transliteration(x, w):
    """split_kernel + combine_kernel: y [E, C, F] for x [E, C, D] and w
    [E, D, F] (F <= 16 < D), f32."""
    E, C, D = x.shape
    F = w.shape[2]
    kF = 4 if F <= 4 else 8 if F <= 8 else 16
    kR = KVALS // kF
    nsplit = -(-D // KSPLIT)
    ws = np.full((nsplit, E, C, F), np.nan, F32)
    for e in range(E):
        for s in range(nsplit):
            d = s * KSPLIT + 4 * LANES
            dok = d < D
            wr = np.zeros((32, 4, kF), F32)           # [lane, row, column]
            for r in range(4):
                wr[dok, r, :F] = w[e, d[dok] + r]
            for c0 in range(0, C, kR):
                v = np.zeros((32, KVALS), F32)
                for i in range(kR):
                    xv = np.zeros((32, 4), F32)
                    if c0 + i < C:
                        xv[dok] = x[e, c0 + i, d[dok, None] + np.arange(4)]
                    for f in range(kF):
                        v[:, i * kF + f] = _fma(
                            xv[:, 3], wr[:, 3, f], _fma(
                                xv[:, 2], wr[:, 2, f], _fma(
                                    xv[:, 1], wr[:, 1, f],
                                    xv[:, 0] * wr[:, 0, f])))
                for o, n in ((16, 32), (8, 16), (4, 8), (2, 4), (1, 2)):
                    up = (LANES & o).astype(bool)[:, None]
                    send = np.where(up, v[:, :n], v[:, n:2 * n])
                    keep = np.where(up, v[:, n:2 * n], v[:, :n])
                    v[:, :n] = keep + send[LANES ^ o]
                for q in range(2):
                    idx = 2 * LANES + q
                    c, f = c0 + idx // kF, idx % kF
                    ok = (c < C) & (f < F)
                    ws[s, e, c[ok], f[ok]] = v[ok, q]
    y = np.zeros((E, C, F), F32)
    for s0 in range(0, nsplit, KBATCH):
        parts = [ws[s] if s < nsplit else np.zeros_like(y)
                 for s in range(s0, s0 + KBATCH)]
        for p in parts:
            y = y + p
    return y


def narrow_d_transliteration(x, w):
    """narrow_d_kernel: y [E, C, F] for x [E, C, D] (D <= 16) and w [E, D,
    F], f32; x's rows staged 64 at a time in a NaN-initialised panel."""
    E, C, D = x.shape
    F = w.shape[2]
    y = np.full((E, C, F), np.nan, F32)
    for e in range(E):
        wr = np.zeros((NARROW, F), F32)
        wr[:D] = w[e]
        for c0 in range(0, C, KROWS):
            ts = np.full((KROWS, NARROW + 1), np.nan, F32)
            ts[:, :NARROW] = 0.0
            rows = min(KROWS, C - c0)
            ts[:rows, :D] = x[e, c0:c0 + rows]
            acc = np.zeros((rows, F), F32)
            for k in range(D):
                acc = _fma(ts[:rows, k, None], wr[k][None, :], acc)
            y[e, c0:c0 + rows] = acc
    return y


def _narrow_case(seed, E, C, D, F):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, D)).astype(F32),
            (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(F32))


@pytest.mark.parametrize("E,C,D,F", [
    (9, 8, 4096, 8),       # minitron-8b's h@A: d 4096, rank 8
    (3, 4, 256, 4),        # edge-tiny's h@A at rank 4
    (2, 17, 300, 12),      # D off a split (300 = 2 x 128 + 44), F 12 -> 16
    (2, 5, 200, 16),
])
def test_narrow_f_matches_plain(E, C, D, F):
    x, w = _narrow_case(E * D + F, E, C, D, F)
    x[0] = 0.0                                   # an empty group
    want = MG.moe_gemm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    got = narrow_f_transliteration(x, w)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("E,C,D,F", [
    (9, 8, 8, 4096),       # minitron-8b's t@B
    (3, 4, 4, 256),        # edge-tiny's t@B at rank 4
    (2, 70, 16, 264),      # two panels of rows, F past a 256-column block
    (2, 3, 12, 8),
])
def test_narrow_d_matches_plain(E, C, D, F):
    x, w = _narrow_case(E * F + D, E, C, D, F)
    want = MG.moe_gemm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(narrow_d_transliteration(x, w), want, **TOL)


@pytest.mark.parametrize("narrow,D,F", [
    (narrow_f_transliteration, 4096, 8), (narrow_f_transliteration, 300, 4),
    (narrow_d_transliteration, 8, 4096), (narrow_d_transliteration, 4, 72)])
def test_a_row_of_the_narrow_variant_depends_on_d_alone(narrow, D, F):
    """One row's output bits at C 1, 8 and 72, at every position of its
    group and in another expert, among other rows: the same bits, so an
    adapter session's tokens do not depend on which slots share its
    group."""
    rng = np.random.default_rng(D + F)
    row = rng.standard_normal(D).astype(F32)
    w1 = (rng.standard_normal((D, F)) / np.sqrt(D)).astype(F32)
    w = np.stack([w1, w1])                   # the same adapter in both rows
    want = None
    for C, pos, e in ((1, 0, 0), (8, 0, 0), (8, 5, 1), (72, 71, 0),
                      (72, 37, 1)):
        x = rng.standard_normal((2, C, D)).astype(F32)
        x[e, pos] = row
        got = narrow(x, w)[e, pos]
        if want is None:
            want = got
            np.testing.assert_allclose(got, row @ w1, **TOL)
        assert np.array_equal(got, want), (C, pos, e)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


class TestTensorCoreRule:
    @pytest.mark.parametrize("C,D,F", [
        (8, 2048, 768), (160, 2048, 768),   # qwen3-moe gate/up
        (8, 768, 2048), (160, 768, 2048),   # qwen3-moe down
    ])
    def test_main_path_shapes_take_the_tensor_cores(self, C, D, F):
        # E 2 of the 128 experts: the rule does not read E
        x, w = _bf16(2, C, D), _bf16(2, D, F)
        assert MG.uses_tensor_cores(x, w)
        assert MG.uses_tensor_cores(x, w, _bf16(2, D, F))

    def test_f32_keeps_the_cuda_core_template(self):
        x, w = torch.zeros(9, 8, 4096), torch.zeros(9, 4096, 8)
        assert not MG.uses_tensor_cores(x, w)
        assert not MG.uses_tensor_cores(x.bfloat16(), w)

    @pytest.mark.parametrize("D,F", [(12, 16), (16, 12), (37, 19)])
    def test_d_and_f_must_be_multiples_of_8(self, D, F):
        assert not MG.uses_tensor_cores(_bf16(2, 4, D), _bf16(2, D, F))

    def test_a_row_slice_of_x_keeps_the_tensor_cores(self):
        # rows 3.. of [E, C + 3, 16]: base moves 96 bytes, row stride 16
        x = _bf16(2, 12, 16)[:, 3:]
        assert MG.uses_tensor_cores(x, _bf16(2, 16, 8))

    def test_strides_off_8_take_the_template(self):
        x = _bf16(2, 4, 17)[:, :, :16]          # row stride 17
        assert not MG.uses_tensor_cores(x, _bf16(2, 16, 8))
        w = _bf16(2, 16, 12)[:, :, :8]          # w row stride 12
        assert not MG.uses_tensor_cores(_bf16(2, 4, 16), w)

    def test_unaligned_bases_take_the_template(self):
        x = _bf16(2 * 4 * 16 + 1)[1:].view(2, 4, 16)   # base + 2 bytes
        assert x.data_ptr() % 16 == 2
        assert not MG.uses_tensor_cores(x, _bf16(2, 16, 8))
        wu = _bf16(2 * 16 * 8 + 4)[4:].view(2, 16, 8)  # base + 8 bytes
        assert not MG.uses_tensor_cores(_bf16(2, 4, 16), _bf16(2, 16, 8),
                                        wu)

    def test_non_unit_inner_strides_take_the_template(self):
        w = _bf16(2, 8, 16).transpose(1, 2)     # [2, 16, 8], stride 16 on F
        assert not MG.uses_tensor_cores(_bf16(2, 4, 16), w)


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


class TestNarrowRule:
    @pytest.mark.parametrize("C,D,F", [
        (8, 4096, 8), (8, 8, 4096),          # minitron-8b adapters, rank 8
        (4, 256, 4), (4, 4, 256),            # edge-tiny adapters, rank 4
        (64, 4096, 16), (1, 16, 4096)])      # rank 16, the largest
    def test_adapter_products_take_the_narrow_variant(self, C, D, F):
        x, w = _f32(9, C, D), _f32(9, D, F)
        assert MG.uses_narrow(x, w)
        assert not MG.uses_tensor_cores(x, w)

    def test_expert_shapes_keep_their_variants(self):
        # qwen3-moe (bf16) and its f32 smoke config (d 64, d_ff 64)
        assert not MG.uses_narrow(_bf16(2, 8, 2048), _bf16(2, 2048, 768))
        assert not MG.uses_narrow(_f32(4, 8, 64), _f32(4, 64, 64))

    def test_bf16_rank_sized_products_are_not_narrow(self):
        assert not MG.uses_narrow(_bf16(9, 8, 4096), _bf16(9, 4096, 8))

    @pytest.mark.parametrize("D,F", [(4096, 20), (32, 32), (4096, 6),
                                     (6, 4096), (4097, 8)])
    def test_wider_or_off_4_shapes_take_the_template(self, D, F):
        assert not MG.uses_narrow(_f32(2, 4, D), _f32(2, D, F))

    def test_strides_and_alignment_off_4_take_the_template(self):
        x = _f32(2, 4, 4098)[:, :, :4096]       # row stride 4098
        assert not MG.uses_narrow(x, _f32(2, 4096, 8))
        w = _f32(2, 8, 4097)[:, :, :4096]       # w row stride 4097
        assert not MG.uses_narrow(_f32(2, 4, 8), w)
        xo = _f32(2 * 4 * 4096 + 1)[1:].view(2, 4, 4096)   # base + 4 bytes
        assert not MG.uses_narrow(xo, _f32(2, 4096, 8))
        wt = _f32(2, 8, 4096).transpose(1, 2)   # unit stride along D, not F
        assert not MG.uses_narrow(_f32(2, 4, 4096), wt)

    def test_a_row_slice_of_x_keeps_the_narrow_variant(self):
        # the adapter route's rows 3.. of a buffer: base moves 48 bytes
        x = _f32(9, 11, 8)[:, 3:]
        assert MG.uses_narrow(x, _f32(9, 8, 4096))


# ---------------------------------------------------------------------------
# the int8-weight variant
# ---------------------------------------------------------------------------

#: i8::dispatch's block shapes (weight tiles a consumer, N, sets of N rows,
#: BK, ring stages) by C (up to 8, up to 64, more) and kernel (fused or not)
def i8_shape(C, fused):
    rows = 64 if fused else 128                 # kFused/DownDecodeRows
    if C <= 8:
        return (2 if fused else 1, 8, 1, rows, 6)
    if C <= 64:
        return (2 if fused else 1, 64, 1, rows, 4)
    return (1, 160, 2, 64, 4)                   # kPrefillSets 2


I8_COLS = 64
T128 = np.arange(128)                        # a consumer warpgroup's threads
WI, GQ, TQ = T128 >> 5, (T128 & 31) >> 2, T128 & 3


def _sw128(row, chunk):
    """Byte offset of 16-byte piece ``chunk`` of 128-byte row ``row`` in a
    128-byte swizzle (1024-byte aligned tile)."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _sw64(row, chunk):
    """The same in a 64-byte swizzle (64-byte rows, 512-byte aligned)."""
    return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4)


def _i8_col(m):
    """The F column (in its 64-column tile) of accumulator row m = 16 wi +
    g + 8 h: a thread's two rows are the adjacent columns 16 wi + 2 g + h,
    so it reads 2 bytes of each int8 row."""
    m = np.asarray(m)
    return 16 * (m // 16) + 2 * (m % 8) + (m % 16) // 8


def i8_transliteration(x, sxe, sxc, qs, ss, sse, swe, swd, E, C, D, F,
                       shape=None):
    """y [E, C, F] as i8::kernel computes it. ``x`` flat f32 read through
    element strides (unit along D); ``qs`` the flat int8 weights (as f32,
    gate and up, or w alone), ``ss`` their flat f32 scales [E, 1, F]
    (expert stride sse).

    Shared memory is one flat f32 array indexed by byte offset (a bf16 or
    int8 element sits at its first byte), NaN until written. The producer
    fills each stage's boxes as TMA does (zeros past C, D and F; the x
    tile in the 128-byte swizzle, the int8 tiles in the 64-byte one) as
    far ahead as the empty barriers let it; each consumer warpgroup builds
    A's fragment registers from its threads' 2-byte reads and B by
    descriptor, and adds one k16 step's products after another to its
    accumulators; the epilogue goes through the ring as the kernel's. Only
    the dequantised weights are rounded to bf16; sums stay f32, each k16
    step's 16 x 8 block computed as the bf16 variant's transliteration
    computes it (``_mma``: A's rows in F order), so its bits can be
    compared with that one's."""
    fused = len(qs) == 2
    wpw, N, NS, BK, S = shape or i8_shape(C, fused)
    tiles = 2 * wpw
    BF = I8_COLS * (wpw if fused else 2)
    R = N * NS
    split = fused and wpw == 1
    XB = (BK // 64) * R * 128
    QB = BK * I8_COLS
    STAGE = XB + tiles * QB
    BUF = S * STAGE
    SMEM = BUF
    YP, UP = BF + 8, I8_COLS + 4
    KY = R * UP * 4 if split else 0
    assert KY + R * YP * 2 <= BUF
    nF, chunks = -(-F // BF), -(-C // R)
    Cc = -(-(-(-C // chunks)) // 8) * 8
    nk = -(-D // BK)

    def matrix(b):
        return b & 1 if fused else 0

    def column(b):
        return I8_COLS * (b >> 1 if fused else b)

    y = np.full(E * C * F, np.nan, np.float32)
    for e in range(E):
        for bx in range(nF * chunks):
            f0, c0 = (bx % nF) * BF, (bx // nF) * Cc
            rows = min(Cc, C - c0)
            smem = np.full(SMEM, np.nan, np.float32)

            def load_stage(kt):
                st = (kt % S) * STAGE
                r = np.arange(N)[:, None]
                kk = np.arange(64)[None, :]
                for c in range(BK // 64):
                    for j in range(NS):
                        row, k = c0 + j * N + r, kt * BK + 64 * c + kk
                        ok = (row < C) & (k < D)
                        src = np.where(ok, e * sxe + row * sxc + k, 0)
                        rr = j * N + r
                        dst = (st + c * R * 128 + _sw128(rr, kk >> 3)
                               + (kk & 7) * 2)
                        smem[dst] = np.where(ok, x[src], 0.0)
                k = np.arange(BK)[:, None]
                f = np.arange(I8_COLS)[None, :]
                for b in range(tiles):
                    kg, fg = kt * BK + k, f0 + column(b) + f
                    ok = (kg < D) & (fg < F)
                    src = np.where(ok, e * swe + kg * swd + fg, 0)
                    dst = st + XB + b * QB + _sw64(k, f >> 4) + (f & 15)
                    smem[dst] = np.where(ok, qs[matrix(b)][src], 0.0)

            # the scales each thread holds: columns fa, fa + 1 of each of
            # its tiles
            sc0 = 16 * WI + 2 * GQ

            def scales(b):
                f = f0 + column(b) + sc0[:, None] + np.arange(2)
                src = np.where(f < F, e * sse + f, 0)
                return np.where(f < F, ss[matrix(b)][src], 0.0).astype(
                    np.float32)

            acc = {}
            loaded = 0
            for kt in range(nk):
                # as far ahead as the empty barriers allow: a consumer
                # arrives for a stage after its products
                while loaded < min(nk, kt + S):
                    load_stage(loaded)
                    loaded += 1
                st = (kt % S) * STAGE
                for cw in range(2):
                    qt = st + XB + cw * wpw * QB
                    A = {}
                    for w in range(wpw):
                        b = cw * wpw + w
                        sc = scales(b)
                        frag = np.full((BK // 16, 64, 16), np.nan,
                                       np.float32)
                        for ks in range(BK // 16):
                            # 2 bytes (columns fa, fa + 1) of rows
                            # k0 + {0, 1, 8, 9}, k0 = 16 ks + 2 tg
                            q = {}
                            for dk in (0, 1, 8, 9):
                                k = 16 * ks + 2 * TQ + dk
                                at = (qt + w * QB + k * 64
                                      + ((WI ^ TQ) << 4) + 2 * GQ)
                                assert np.array_equal(
                                    at, qt + w * QB + _sw64(k, WI)
                                    + 2 * GQ)
                                q[dk] = (smem[at], smem[at + 1])
                            s0, s1 = sc[:, 0], sc[:, 1]
                            regs = ((q[0][0] * s0, q[1][0] * s0),
                                    (q[0][1] * s1, q[1][1] * s1),
                                    (q[8][0] * s0, q[9][0] * s0),
                                    (q[8][1] * s1, q[9][1] * s1))
                            # wgmma's A fragment: register r holds
                            # (row g + 8 (r & 1), k 2 tg + 8 (r >> 1)
                            # + {0, 1}) of the warp's 16 rows
                            for r, pair in enumerate(regs):
                                for hh, v in enumerate(pair):
                                    frag[ks, 16 * WI + GQ + 8 * (r & 1),
                                         2 * TQ + 8 * (r >> 1) + hh] = \
                                        _round_bf16(v)
                        A[w] = frag
                    for ks in range(BK // 16):
                        for j in range(NS):
                            if j * N >= rows:
                                continue
                            n = np.arange(N)[None, :]
                            kk = np.arange(16)[:, None]
                            rr = j * N + n
                            at = (st + (ks >> 2) * R * 128
                                  + _sw128(rr, (ks & 3) * 2 + (kk >> 3))
                                  + (kk & 7) * 2)
                            B = smem[at]                         # [16, N]
                            for w in range(wpw):
                                a = acc.setdefault(
                                    (cw, w, j),
                                    np.zeros((64, N), np.float32))
                                for wi in range(4):
                                    # the 16 rows of warp wi, in F order
                                    mrow = 16 * wi + np.arange(16)
                                    order = mrow[np.argsort(
                                        _i8_col(mrow))]
                                    a16 = A[w][ks][order]
                                    for jn in range(N // 8):
                                        a[order, 8 * jn:8 * jn + 8] += \
                                            a16 @ B[:, 8 * jn:8 * jn + 8]

            # epilogue through the ring: (split) up in f32 at us, then
            # ys[c][column] of the block, then whole 16-byte rows
            def rows_cols(cw):
                """(set, row c, column in its tile, m, n) of each live
                accumulator of consumer cw."""
                out = []
                for m in range(64):
                    col = int(_i8_col(m))
                    for j in range(NS):
                        for n in range(N):
                            if j * N + n < rows:
                                out.append((j, j * N + n, col, m, n))
                return out

            if split:
                for j, c, col, m, n in rows_cols(1):
                    smem[(c * UP + col) * 4] = acc[(1, 0, j)][m, n]
                for j, c, col, m, n in rows_cols(0):
                    v = acc[(0, 0, j)][m, n]
                    u = smem[(c * UP + col) * 4]
                    smem[KY + (c * YP + col) * 2] = v / (1.0 + np.exp(-v)) * u
            else:
                for cw in range(2):
                    for j, c, col, m, n in rows_cols(cw):
                        v = acc[(cw, 0, j)][m, n]
                        if fused:
                            v = v / (1.0 + np.exp(-v)) * acc[(cw, 1, j)][m, n]
                        smem[KY + (c * YP + I8_COLS * cw + col) * 2] = v
            for i in range(rows * (BF // 8)):
                r, c = i // (BF // 8), (i % (BF // 8)) * 8
                if f0 + c < F:
                    dst = (e * C + c0 + r) * F + f0 + c
                    y[dst:dst + 8] = smem[KY + (r * YP + c) * 2
                                          + 2 * np.arange(8)]
    return y.reshape(E, C, F)


def _int8_run(xb, qws, C, row_pad, shape=None):
    """The int8 variant's transliteration on x rows row_pad.. of xb and
    {q, s} weights (torch; one for moe_gemm, gate and up fused)."""
    E, _, D = xb.shape
    F = qws[0]["q"].shape[2]
    flat = np.concatenate([xb.reshape(-1), np.zeros(8, np.float32)])
    return i8_transliteration(
        flat[row_pad * D:], (C + row_pad) * D, D,
        [w["q"].numpy().reshape(-1).astype(np.float32) for w in qws],
        [w["s"].numpy().reshape(-1) for w in qws], F, D * F, F, E, C, D, F,
        shape)


def _int8_case(seed, E, C, D, F, row_pad=0):
    """bf16-valued x (an empty last expert) and int8 gate and up weights,
    a zero column (scale 1e-12) in the gate."""
    xb, wg, wu = _case(seed, E, C, D, F, row_pad, empty=(E - 1,))
    wg[:, :, 3] = 0.0
    return _round_bf16(xb), [Q.quantize_weight(torch.from_numpy(w).bfloat16())
                             for w in (wg, wu)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("E,C,D,F,row_pad", [
    (2, 8, 48, 144, 0),         # decode C 8, F past two 64-column tiles
    (2, 9, 16, 80, 3),          # C 9 (N 64 from 9 rows), F 80, strided x
    (1, 1, 32, 16, 0),          # C 1, F 16
    (2, 40, 40, 16, 1),         # C 40, D off a 16-row step
    (2, 161, 24, 32, 0),        # C > 64: 161 rows in two sets of 160
])
def test_int8_transliteration_is_the_bf16_one_on_as_weight(fused, E, C, D,
                                                           F, row_pad):
    """TMA boxes, the ring, the dequantisation into A's registers and the
    k16 steps: bit for bit ``as_weight``
    followed by the bf16 variant's transliteration (in its own block
    shape), with an empty expert and a zero weight column."""
    xb, (qg, qu) = _int8_case(E * 100 + C + 7, E, C, D, F, row_pad)
    qws = [qg, qu] if fused else [qg]
    got = _int8_run(xb, qws, C, row_pad)
    deq = [Q.as_weight(q).float().numpy() for q in (qg, qu)]
    want = _run(xb, deq[0], deq[1], C, row_pad, fused)
    assert np.array_equal(got, want)
    assert not got[E - 1].any()
    # and the plain version the CPU wrapper runs on a {q, s} weight
    x = torch.from_numpy(xb[:, row_pad:])
    plain = (MG.moe_ffn_fused(x, qg, qu) if fused else
             MG.moe_gemm(x, qg)).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


def test_int8_rows_depend_on_d_alone():
    """The int8 variant at C 330 (prefill shape: two chunks of 168 and 162
    rows), C 40 (N 64) and C 8 (decode shape, other tiles and ring): rows
    0-7 equal bit for bit, over three stages of D."""
    xb, qws = _int8_case(13, 1, 330, 136, 32)
    wide = _int8_run(xb, qws, 330, 0)
    mid = _int8_run(xb[:, :40], qws, 40, 0)
    narrow = _int8_run(xb[:, :8], qws, 8, 0)
    assert np.array_equal(wide[:, :8], narrow)
    assert np.array_equal(mid[:, :8], narrow)


def test_the_bit_probe_runs_only_on_the_card():
    """``i8_probe`` (wgmma against mma.sync, run by chip_smoke.py) takes
    bf16 [steps, 64, 16] operands on the card and refuses anything else
    before it loads the library."""
    a = torch.zeros((4, 64, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="on the card"):
        MG.i8_probe(a, a)


def _q8(E, D, F):
    return {"q": torch.zeros((E, D, F), dtype=torch.int8),
            "s": torch.ones((E, 1, F))}


class TestInt8Rule:
    @pytest.mark.parametrize("C,D,F", [
        (8, 4096, 14336), (640, 4096, 14336),   # mixtral gate/up
        (8, 14336, 4096), (640, 14336, 4096),   # mixtral down
    ])
    def test_main_path_shapes_take_the_int8_variant(self, C, D, F):
        # E 1 of the 8 experts, D and F cut to 1/64: the rule reads neither
        # E nor the sizes beyond their multiples of 16
        D, F = D // 64, F // 64
        x, w = _bf16(1, C, D), _q8(1, D, F)
        assert MG.uses_int8(x, w) and MG.uses_int8(x, w, _q8(1, D, F))
        assert not MG.uses_tensor_cores(x, w["q"])

    def test_a_layer_view_of_a_stacked_weight_takes_it(self):
        q = torch.zeros((3, 2, 16, 32), dtype=torch.int8)
        s = torch.ones((3, 2, 1, 32))
        assert MG.uses_int8(_bf16(2, 8, 16), {"q": q[1], "s": s[1]})

    @pytest.mark.parametrize("what", ["f32 x", "f32 q", "f16 s", "F off 8",
                                      "F off 16", "mixed", "s shape",
                                      "q stride", "q stride off 16"])
    def test_what_the_variant_does_not_take(self, what):
        x, wg, wu = _bf16(2, 8, 16), _q8(2, 16, 32), _q8(2, 16, 32)
        if what == "f32 x":
            x = x.float()
        elif what == "f32 q":
            wg["q"] = wg["q"].float()
        elif what == "f16 s":
            wg["s"] = wg["s"].half()
        elif what == "F off 8":
            wg, wu = _q8(2, 16, 20), _q8(2, 16, 20)
        elif what == "F off 16":
            wg, wu = _q8(2, 16, 24), _q8(2, 16, 24)
        elif what == "mixed":
            wu = _bf16(2, 16, 32)
        elif what == "s shape":
            wg["s"] = torch.ones((2, 16, 32))
        elif what == "q stride":
            wg["q"] = torch.zeros((2, 16, 36), dtype=torch.int8)[:, :, :32]
        else:                                   # row stride 40: 8, not 16
            wg["q"] = torch.zeros((2, 16, 40), dtype=torch.int8)[:, :, :32]
        assert not MG.uses_int8(x, wg, wu)


# ---------------------------------------------------------------------------
# the backward: K1 / K2 / K3 (moe_ffn_fused_bwd / moe_gemm_dx / moe_gemm_dw,
# namespace wgrad)
# ---------------------------------------------------------------------------

#: wgrad::dx_dispatch / dw_dispatch's instantiations: K2 (pairs, NR rows of
#: C a chunk, BK rows of F a stage, S stages), K3 (outputs, BN columns of
#: each a unit, BK rows of C a chunk, SA chunks of a, SB slots of dy)
GRAD_SHAPES = {"dx1": (1, 160, 64, 5), "dx2": (2, 160, 64, 5),
               "dw1": (1, 256, 32, 5, 5), "dw2": (2, 128, 32, 5, 5)}
#: smaller ones, so that small shapes cross chunks, slots and units
SMALL_GRAD = {"dx1": (1, 16, 64, 2), "dx2": (2, 16, 64, 3),
              "dw1": (1, 64, 16, 3, 2), "dw2": (2, 64, 16, 3, 2)}
GRAD_BM = 128          # M rows of an item: 64 a consumer warpgroup


def _swizzle(addr):
    """Physical byte address of logical ``addr`` in the 128-byte swizzle:
    bits 4-6 XOR bits 7-9 (every tile 1024-byte aligned)."""
    addr = np.asarray(addr)
    return addr ^ (((addr >> 7) & 7) << 4)


class _Ring:
    """Shared memory (flat f32 indexed by byte, NaN until written) and the
    mbarrier slots of one block. The producer is a generator of loads, each
    (kind, slot, write): it issues a load only once the slot's previous
    occupant was released by the consumers, and runs as far ahead as the
    slots let it (so a release that comes too early shows as a clobbered
    operand). A consumer that waits for a load the producer cannot issue
    is a deadlock."""

    def __init__(self, nbytes, loads):
        self.smem = np.full(nbytes, np.nan, np.float32)
        self.uses, self.released, self.issued = {}, {}, {}
        self.gen = self._run(loads)

    def _run(self, loads):
        for kind, slot, write in loads:
            key = (kind, slot)
            while self.released.get(key, 0) < self.uses.get(key, 0):
                yield False
            self.uses[key] = self.uses.get(key, 0) + 1
            write(self.smem)
            self.issued[kind] = self.issued.get(kind, 0) + 1
            yield True

    def advance(self):
        while next(self.gen, False):
            pass

    def wait(self, kind, index):
        self.advance()
        assert self.issued.get(kind, 0) > index, f"deadlock on {kind}"

    def release(self, kind, slot):
        self.released[(kind, slot)] = self.released.get((kind, slot), 0) + 1
        self.advance()


def _tma_load(src, s2, s1, e, c1, c0, dims, rows):
    """A TMA box load: ``rows`` rows from c1 by 64 columns from c0 of
    expert e of a [*, dims[1], dims[0]] tensor (flat ``src``, element
    strides s2, s1, unit along the columns), zeros past its edges, written
    at 1024-aligned ``dst`` with 128-byte rows in the 128-byte swizzle."""
    r = np.arange(rows)[:, None]
    c = np.arange(64)[None, :]
    ok = (c1 + r < dims[1]) & (c0 + c < dims[0])
    val = np.where(ok, src[np.where(ok, e * s2 + (c1 + r) * s1 + c0 + c,
                                    0)], 0.0)

    def write(smem, dst):
        smem[_swizzle(dst + r * 128 + c * 2)] = val
    return write


def _kmajor(smem, start, rows):
    """A K-major wgmma operand by descriptor (start, SBO 1024): [rows, 16]
    (row i, k j at start + (i / 8) 1024 + (i % 8) 128 + 2 j)."""
    i = np.arange(rows)[:, None]
    j = np.arange(16)[None, :]
    return smem[_swizzle(start + (i >> 3) * 1024 + (i & 7) * 128 + j * 2)]


def _mnmajor(smem, start, lbo, cols):
    """An MN-major wgmma operand by descriptor (start, LBO, SBO 1024):
    [16, cols] (k j, column i at start + (j / 8) 1024 + (j % 8) 128 +
    (i / 64) LBO + 2 (i % 64))."""
    j = np.arange(16)[:, None]
    i = np.arange(cols)[None, :]
    return smem[_swizzle(start + (j >> 3) * 1024 + (j & 7) * 128
                       + (i >> 6) * lbo + (i & 63) * 2)]


def _tma_store(smem, src, out, count, dims, e, c1, c0, rows):
    """A TMA box store: ``rows`` rows of 64 columns at 1024-aligned ``src``
    (128-byte swizzle) to (c1, c0) of expert e of out [E, dims[1],
    dims[0]]; nothing past its edges."""
    r = np.arange(rows)[:, None]
    c = np.arange(64)[None, :]
    ok = (c1 + r < dims[1]) & (c0 + c < dims[0])
    val = smem[_swizzle(src + r * 128 + c * 2)]
    rr, cc = np.broadcast_to(c1 + r, ok.shape)[ok], \
        np.broadcast_to(c0 + c, ok.shape)[ok]
    out[e, rr, cc] = val[ok]
    count[e, rr, cc] += 1


def dw_transliteration(a, dys, shape=None, bf16=False, order=None,
                       grid=None):
    """K3 as wgrad::dw_kernel computes it: [dw_j [E, D, F]] = a [E, C, D]^T
    . dy_j [E, C, F] (M = D, N = F, K = C), from f32 numpy arrays. Blocks
    walk units (BN columns of every output, expert), ``grid`` of them
    (default one a unit, as launched); a unit's dy chunks stay in their
    slots while they fit and stream with a's otherwise. ``bf16`` rounds
    each output once, as the kernel stores it; ``order`` (a dict) collects
    the k of each k16 step in the order it reaches each accumulator. Every
    output element is written exactly once."""
    E, C, D = a.shape
    F = dys[0].shape[2]
    NO, BN, BK, SA, SB = shape or GRAD_SHAPES[f"dw{len(dys)}"]
    assert NO == len(dys)
    NT = NO * BN
    KA, KB, KO = 2 * BK * 128, (NT // 64) * BK * 128, (NT // 64) * 8192
    OB = SA * KA                                  # B slots
    OO = OB + SB * KB                             # output tiles
    nk, nM, nN = -(-C // BK), -(-D // GRAD_BM), -(-F // BN)
    units = E * nN
    G = min(grid or units, units)
    resident = nk <= SB
    R = _round_bf16 if bf16 else (lambda v: v)
    af = a.reshape(-1)
    bfs = [dy.reshape(-1) for dy in dys]
    outs = [np.full((E, D, F), np.nan, np.float32) for _ in dys]
    counts = [np.zeros((E, D, F), np.int32) for _ in dys]
    for b in range(G):
        mine = range(b, units, G)

        def loads():
            ia = ib = 0
            for u in mine:
                n0, e = (u % nN) * BN, u // nN
                for i in range(nM):
                    for kt in range(nk):
                        at = (ia % SA) * KA
                        boxes = [(_tma_load(af, C * D, D, e, kt * BK,
                                            i * GRAD_BM + 64 * h, (D, C), BK),
                                  at + h * BK * 128) for h in range(2)]
                        yield ("A", ia % SA,
                               lambda s, bx=boxes: [w(s, d) for w, d in bx])
                        ia += 1
                        if resident and i > 0:
                            continue
                        bt = OB + (ib % SB) * KB
                        boxes = [(_tma_load(bfs[c // (BN // 64)], C * F, F,
                                            e, kt * BK,
                                            n0 + 64 * (c % (BN // 64)),
                                            (F, C), BK),
                                  bt + c * BK * 128)
                                 for c in range(NT // 64)]
                        yield ("B", ib % SB,
                               lambda s, bx=boxes: [w(s, d) for w, d in bx])
                        ib += 1

        ring = _Ring(OO + 2 * KO, loads())
        smem = ring.smem
        ia = ib = 0
        for u in mine:
            n0, e = (u % nN) * BN, u // nN
            for i in range(nM):
                acc = np.zeros((2, NO, 64, BN), np.float32)
                last = None
                for kt in range(nk):
                    jb = ib + (kt if resident else i * nk + kt)
                    ring.wait("A", ia)
                    ring.wait("B", jb)
                    bt = OB + (jb % SB) * KB
                    for cw in range(2):
                        at = (ia % SA) * KA + cw * BK * 128
                        for ks in range(BK // 16):
                            A = _mnmajor(smem, at + ks * 2048, BK * 128,
                                         64).T               # [64 m, 16 k]
                            for j in range(NO):
                                B = _mnmajor(smem, bt + j * (BN // 64) * BK
                                             * 128 + ks * 2048, BK * 128, BN)
                                acc[cw, j] += A @ B
                                if order is not None:
                                    order.setdefault(
                                        (b, u, i, cw, j), []).append(
                                        kt * BK + ks * 16)
                    if last is not None:
                        for kind, slot in last:
                            ring.release(kind, slot)
                    last = [("A", ia % SA)]
                    if not resident or i == nM - 1:
                        last.append(("B", jb % SB))
                    ia += 1
                for kind, slot in last:
                    ring.release(kind, slot)
                # epilogue: each consumer's 64 rows cast once into its tile
                # [NT / 64][64][64], then one TMA store a 64-column box
                for cw in range(2):
                    ot = OO + cw * KO
                    r = np.arange(64)[:, None]
                    c = np.arange(NT)[None, :]
                    smem[_swizzle(ot + (c >> 6) * 8192 + r * 128
                                + (c & 63) * 2)] = R(np.concatenate(
                                    list(acc[cw]), axis=1))
                    m0 = i * GRAD_BM + 64 * cw
                    for c in range(NT // 64):
                        j, n = c // (BN // 64), n0 + 64 * (c % (BN // 64))
                        if m0 < D and n < F:
                            _tma_store(smem, ot + c * 8192, outs[j],
                                       counts[j], (F, D), e, m0, n, 64)
            ib += nk if resident else nM * nk
    for cnt in counts:
        assert (cnt == 1).all(), "an output written other than once"
    return outs


def dx_transliteration(dys, ws, shape=None, bf16=False, order=None,
                       grid=None):
    """K2 as wgrad::dx_kernel computes it: dx [E, C, D] = sum_j dy_j [E, C,
    F] . w_j [E, D, F]^T (M = D, N = C, K = F), from f32 numpy arrays.
    Blocks walk units (128 rows of D, a chunk of C, expert), D-tiles
    fastest, ``grid`` of them (default one a unit, as launched); each
    unit streams pair 0's stages, then pair 1's. ``bf16`` rounds where the
    kernel does (each pair's sum, their f32 sum); ``order`` collects the k
    of each k16 step by accumulator. Every output element is written
    exactly once."""
    E, C, F = dys[0].shape
    D = ws[0].shape[1]
    NP, NR, BK, S = shape or GRAD_SHAPES[f"dx{len(dys)}"]
    assert NP == len(dys)
    KW, KY = (BK // 64) * GRAD_BM * 128, (BK // 64) * NR * 128
    KS, KO = KW + KY, NR * 128
    OO = S * KS
    nk, nM = -(-F // BK), -(-D // GRAD_BM)
    chunks = -(-C // NR)
    Cc = -(-(-(-C // chunks)) // 8) * 8
    units = E * chunks * nM
    G = min(grid or units, units)
    R = _round_bf16 if bf16 else (lambda v: v)
    wf = [w.reshape(-1) for w in ws]
    yf = [dy.reshape(-1) for dy in dys]
    out = np.full((E, C, D), np.nan, np.float32)
    count = np.zeros((E, C, D), np.int32)

    def unit(u):
        return (u % nM) * GRAD_BM, (u // nM % chunks) * Cc, u // nM // chunks

    for b in range(G):
        mine = range(b, units, G)

        def loads():
            it = 0
            for u in mine:
                m0, c0, e = unit(u)
                for j in range(NP):
                    for kt in range(nk):
                        st = (it % S) * KS
                        boxes = []
                        for bb in range(BK // 64):
                            k = kt * BK + 64 * bb
                            boxes += [
                                (_tma_load(wf[j], D * F, F, e, m0, k, (F, D),
                                           GRAD_BM), st + bb * GRAD_BM * 128),
                                (_tma_load(yf[j], C * F, F, e, c0, k, (F, C),
                                           NR), st + KW + bb * NR * 128)]
                        yield ("S", it % S,
                               lambda s, bx=boxes: [w(s, d) for w, d in bx])
                        it += 1

        ring = _Ring(OO + 2 * KO, loads())
        smem = ring.smem
        it = 0
        for u in mine:
            m0, c0, e = unit(u)
            acc = np.zeros((2, NP, 64, NR), np.float32)
            last = None
            for j in range(NP):
                for kt in range(nk):
                    ring.wait("S", it)
                    st = (it % S) * KS
                    for cw in range(2):
                        for ks in range(BK // 16):
                            A = _kmajor(smem, st + (ks >> 2) * GRAD_BM * 128
                                        + cw * 64 * 128 + (ks & 3) * 32, 64)
                            B = _kmajor(smem, st + KW + (ks >> 2) * NR * 128
                                        + (ks & 3) * 32, NR).T
                            acc[cw, j] += A @ B
                            if order is not None:
                                order.setdefault((b, u, cw, j), []).append(
                                    kt * BK + ks * 16)
                    if last is not None:
                        ring.release("S", last)
                    last = it % S
                    it += 1
            ring.release("S", last)
            # epilogue: the tile transposed ([n][m], the consumer's 64
            # columns of M), then one TMA store of Cc rows
            for cw in range(2):
                ot = OO + cw * KO
                v = R(R(acc[cw, 0]) + R(acc[cw, 1])) if NP == 2 \
                    else R(acc[cw, 0])
                n = np.arange(NR)[None, :]
                m = np.arange(64)[:, None]
                smem[_swizzle(ot + n * 128 + m * 2)] = v
                if m0 + 64 * cw < D:
                    _tma_store(smem, ot, out, count, (D, C), e, c0,
                               m0 + 64 * cw, Cc)
    assert (count == 1).all(), "an output written other than once"
    return out


#: wgrad::gu_dispatch's instantiation of K1: (NR rows of C a chunk, BK rows
#: of D a stage, S stages a pipeline's ring)
K1_SHAPE = (160, 64, 2)
#: a smaller one, so that small shapes cross chunks, ring slots and units
SMALL_K1 = (16, 64, 2)
K1_SMS = 132           # the card's SMs: K1's grid is at most one block each


def k1_transliteration(x, wg, wu, dout, shape=None, with_y=True, bf16=False,
                       order=None, grid=None):
    """K1 as wgrad::dgu_kernel computes it: (dg, du, y) [E, C, F] from x
    [E, C, D], w_gate and w_up [E, D, F] and dout [E, C, F] (M = F, N = C,
    K = D), from f32 numpy arrays; x may also be (flat, sxe, sxc), read
    through element strides. A unit is (64 columns of F, a chunk of C,
    expert), F-tiles fastest; ``grid`` blocks (default one an SM, at most
    one a pair of units) each run two pipelines, pipeline p walking units
    2 v + p for v = b, b + grid, ... Each pipeline streams its units'
    stages through its own ring, a slot going back as soon as its
    products are done, and loads
    a unit's dout tile once its first S stages are issued and the last
    unit's stores have read the tiles; pipeline 1's producer starts once
    pipeline 0's consumer is half through its first unit. The consumer
    holds gate and up of the unit's 64 columns, writes dg over the dout
    tile and du into the du tile and stores both, then y (``with_y``) over
    dg. ``bf16`` rounds each output once, as the kernel stores it;
    ``order`` collects the k of each k16 step by accumulator. Every output
    element is written exactly once; y is None without ``with_y``."""
    E, C, F = dout.shape
    D = wg.shape[1]
    if isinstance(x, tuple):
        xf, sxe, sxc = x
    else:
        xf, sxe, sxc = x.reshape(-1), C * D, D
    NR, BK, S = shape or K1_SHAPE
    KX, KW = NR * BK * 2, BK * 128
    KS, KO = KX + 2 * KW, NR * 128
    OT = S * KS                          # the dout tile, then du's
    nk, nF = -(-D // BK), -(-F // 64)
    chunks = -(-C // NR)
    Cc = -(-(-(-C // chunks)) // 8) * 8
    units = E * chunks * nF
    pairs = -(-units // 2)
    G = min(grid or K1_SMS, pairs)
    R = _round_bf16 if bf16 else (lambda v: v)
    wf = [wg.reshape(-1), wu.reshape(-1)]
    df = dout.reshape(-1)
    outs = [np.full((E, C, F), np.nan, np.float32) for _ in range(3)]
    counts = [np.zeros((E, C, F), np.int32) for _ in range(3)]

    def unit(u):
        return (u % nF) * 64, (u // nF % chunks) * Cc, u // nF // chunks

    for b in range(G):
        half = []                        # pipeline 0's consumer is half way
        for p in range(2):
            mine = [2 * v + p for v in range(b, pairs, G) if 2 * v + p < units]

            def loads():
                assert p == 0 or half, "pipeline 1 started before its gate"
                it = 0
                for u in mine:
                    f0, c0, e = unit(u)
                    for kt in range(nk):
                        st = (it % S) * KS
                        boxes = [(_tma_load(xf, sxe, sxc, e, c0,
                                            kt * BK + 64 * i, (D, C), NR),
                                  st + i * NR * 128) for i in range(BK // 64)]
                        boxes += [(_tma_load(wf[j], D * F, F, e, kt * BK, f0,
                                             (F, D), BK), st + KX + j * KW)
                                  for j in range(2)]
                        yield ("S", it % S,
                               lambda s, bx=boxes: [w(s, d) for w, d in bx])
                        it += 1
                        if kt == min(S, nk) - 1:
                            box = _tma_load(df, C * F, F, e, c0, f0, (F, C),
                                            Cc)
                            yield ("D", 0, lambda s, w=box: w(s, OT))

            ring = _Ring(OT + 2 * KO, loads())
            smem = ring.smem
            it = 0
            for nd, u in enumerate(mine):
                f0, c0, e = unit(u)
                acc = np.zeros((2, 64, NR), np.float32)      # gate | up
                for kt in range(nk):
                    ring.wait("S", it)
                    st = (it % S) * KS
                    for ks in range(BK // 16):
                        B = _kmajor(smem, st + (ks >> 2) * NR * 128
                                    + (ks & 3) * 32, NR).T   # [16 k, NR n]
                        for j in range(2):
                            A = _mnmajor(smem, st + KX + j * KW + ks * 2048,
                                         8192, 64).T        # [64 m, 16 k]
                            acc[j] += A @ B
                            if order is not None:
                                order.setdefault((b, u, j), []).append(
                                    kt * BK + ks * 16)
                    ring.release("S", it % S)   # its products are done
                    it += 1
                    if kt == 0 and nd > 0:      # the last unit's stores have
                        ring.release("D", 0)    # read the tiles
                    if p == 0 and nd == 0 and kt == nk // 2:
                        half.append(True)
                # epilogue: (column m, row n) with dout's element at (n, m)
                # of its tile; dg over it and du at (n, m) of the du tile,
                # both stored; then y over dg, stored (Cc rows)
                ring.wait("D", nd)
                rows = min(Cc, C - c0)
                at = (np.arange(rows)[None, :] * 128
                      + np.arange(64)[:, None] * 2)        # [64 m, rows n]
                g, v = acc[0][:, :rows], acc[1][:, :rows]
                dg, du = swiglu_bwd_np(g, v, smem[_swizzle(OT + at)])
                smem[_swizzle(OT + at)] = R(dg)
                smem[_swizzle(OT + KO + at)] = R(du)
                for i in range(2 + with_y):
                    if i == 2:                 # y over dg, once stored
                        smem[_swizzle(OT + at)] = R(g / (1.0 + np.exp(-g))
                                                    * v)
                    _tma_store(smem, OT + KO * (i == 1), outs[i], counts[i],
                               (F, C), e, c0, f0, Cc)
    for cnt in counts[:2 + with_y]:
        assert (cnt == 1).all(), "an output written other than once"
    return outs[0], outs[1], outs[2] if with_y else None


def _grad_case(seed, E, C, D, F, exact=False):
    """dy_j [E, C, F], w_j [E, D, F] and a [E, C, D] as f32 numpy. exact:
    multiples of 1/8 in [-4, 4], so every f32 sum of their products is
    exact in any order (16 bits or fewer) and most need rounding to bf16:
    only the bf16 roundings can differ."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        if exact:
            return (rng.integers(-32, 33, shape) / 8).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    return ([draw(E, C, F) for _ in range(2)],
            [(draw(E, D, F) / (1 if exact else np.sqrt(D))).astype(np.float32)
             for _ in range(2)],
            draw(E, C, D))


def _grad_run(kind, dys, ws, a, shape, **kw):
    """K2 or K3 (``kind`` dx / dw and its count of pairs or outputs) on the
    first of each operand list; a list of outputs."""
    n = int(kind[2])
    if kind.startswith("dx"):
        return [dx_transliteration(dys[:n], ws[:n], shape, **kw)]
    return dw_transliteration(a, dys[:n], shape, **kw)


def _grad_plain(kind, dys, ws, a, cast=lambda t: t):
    n = int(kind[2])
    t = [cast(torch.from_numpy(x)) for x in dys[:n]]
    if kind.startswith("dx"):
        return [MG.moe_gemm_dx_ref(
            t, [cast(torch.from_numpy(x)) for x in ws[:n]]).float().numpy()]
    return [w.float().numpy() for w in MG.moe_gemm_dw_ref(
        cast(torch.from_numpy(a)), t)]


@pytest.mark.parametrize("pairs", [1, 2])
@pytest.mark.parametrize("E,C,D,F,small", [
    (2, 9, 16, 24, False),      # C 9: a ragged chunk; the kernel's shape
    (1, 1, 8, 72, False),       # C 1, F off a 64-row stage
    (2, 37, 40, 48, True),      # C in 3 chunks of 16 rows of the small shape
    (1, 70, 24, 16, True),      # C in 5 chunks, D off the 128-row tile
])
def test_dx_transliteration_matches_plain(pairs, E, C, D, F, small):
    dys, ws, _ = _grad_case(E * 13 + C, E, C, D, F)
    dys, ws = dys[:pairs], ws[:pairs]
    shape = SMALL_GRAD[f"dx{pairs}"] if small else None
    got = dx_transliteration(dys, ws, shape)
    want = _grad_plain(f"dx{pairs}", dys, ws, None)[0]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("outs", [1, 2])
@pytest.mark.parametrize("E,C,D,F,small", [
    (2, 9, 16, 24, False),      # C 9: K3's reduction off a k16 step
    (1, 1, 136, 8, False),      # C 1, D past one 128-row tile
    (2, 37, 40, 48, True),      # C off 8 and past the small slots: dy streams
    (1, 3, 24, 72, True),       # F past one 64-column unit
])
def test_dw_transliteration_matches_plain(outs, E, C, D, F, small):
    dys, _, a = _grad_case(E * 17 + C, E, C, D, F)
    dys = dys[:outs]
    shape = SMALL_GRAD[f"dw{outs}"] if small else None
    got = dw_transliteration(a, dys, shape)
    assert len(got) == outs
    for g, w in zip(got, _grad_plain(f"dw{outs}", dys, None, a)):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kind", sorted(GRAD_SHAPES))
def test_grad_k_order_and_bf16_rounding(kind):
    """Every accumulator of K2 and K3 takes its k16 steps in increasing k,
    each exactly once, with no split (K2 over F, K3 over C, past a ragged
    end); and the kernels round where the plain versions do (K2: each
    pair's product, then their f32 sum; K3: each output): on inputs whose
    f32 sums are exact in any order, the transliteration with bf16
    rounding equals the plain version in bf16 bit for bit."""
    dys, ws, a = _grad_case(len(kind) + int(kind[2]), 2, 21, 24, 40,
                            exact=True)
    shape = SMALL_GRAD[kind]
    order = {}
    got = _grad_run(kind, dys, ws, a, shape, bf16=True, order=order)
    want = _grad_plain(kind, dys, ws, a, cast=lambda t: t.bfloat16())
    K, BK = (40, shape[2]) if kind.startswith("dx") else (21, shape[2])
    steps = list(range(0, -(-K // BK) * BK, 16))
    assert order and all(ks == steps for ks in order.values())
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("C", [21, 37])
@pytest.mark.parametrize("kind", sorted(GRAD_SHAPES))
def test_grad_blocks_walk_units_across_experts(kind, C):
    """A grid smaller than the units (2 blocks), so each block walks
    several units and crosses expert boundaries, with ragged C, D and F at
    the small shapes (K3 at C 21: dy stays in its slots for both D-tiles of
    a unit; at C 37: past the slots, dy streams; K2: C in two or three
    chunks): equal to the one-unit-a-block grid bit for bit and to the
    plain version."""
    dys, ws, a = _grad_case(C + int(kind[2]), 3, C, 136, 72)
    shape = SMALL_GRAD[kind]
    walked = _grad_run(kind, dys, ws, a, shape, grid=2)
    alone = _grad_run(kind, dys, ws, a, shape, grid=10 ** 6)
    for w, o, p in zip(walked, alone, _grad_plain(kind, dys, ws, a)):
        assert np.array_equal(w, o)
        np.testing.assert_allclose(w, p, **TOL)


@pytest.mark.parametrize("kind", sorted(GRAD_SHAPES))
def test_grad_edges_at_the_kernel_shapes(kind):
    """The kernels' own shapes at C off 8 and off a K3 chunk (C 37), D off
    the 128-row tile (136) and F off a 64-wide box and K2's 64-row stage
    (72), with an empty expert; then C 170, past K3's five resident dy
    chunks (dy streams) and K2's 160-row chunk (two chunks of 88)."""
    for C in (37, 170):
        dys, ws, a = _grad_case(C + int(kind[2]), 2, C, 136, 72)
        for t in dys + [a]:
            t[1] = 0.0
        got = _grad_run(kind, dys, ws, a, None)
        for g, p in zip(got, _grad_plain(kind, dys, ws, a)):
            np.testing.assert_allclose(g, p, **TOL)
            assert not g[1].any()


def _k1_case(seed, E, C, D, F, row_pad=0, exact=False):
    """x as a strided view (row_pad extra rows before row 0 of each
    expert), w_gate, w_up and dout as f32 numpy, expert E - 1 empty (zero
    rows of x) when E > 1. exact: multiples of 1/8 in [-4, 4] (weights
    1/512 in [-1/16, 1/16]), so every f32 sum of their products is exact in
    any order."""
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        if exact:
            return (rng.integers(-32, 33, shape) / (8 / scale)).astype(
                np.float32)
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    xb = draw(E, C + row_pad, D)
    if E > 1:
        xb[E - 1] = 0.0
    w = 1 / 64 if exact else D ** -0.5
    return xb, draw(E, D, F, scale=w), draw(E, D, F, scale=w), draw(E, C, F)


def _k1_run(xb, wg, wu, dout, row_pad, shape=None, **kw):
    E, _, D = xb.shape
    C = dout.shape[1]
    flat = np.concatenate([xb.reshape(-1), np.zeros(8, np.float32)])
    return k1_transliteration((flat[row_pad * D:], (C + row_pad) * D, D), wg,
                              wu, dout, shape, **kw)


def _k1_exact(xb, wg, wu, dout, row_pad):
    """g and u in f64 (exact on exact inputs), then swiglu_bwd_np and the
    forward's epilogue in f32."""
    x = xb[:, row_pad:].astype(np.float64)
    g = np.einsum("ecd,edf->ecf", x, wg).astype(np.float32)
    u = np.einsum("ecd,edf->ecf", x, wu).astype(np.float32)
    dg, du = swiglu_bwd_np(g, u, dout)
    return dg, du, g / (1.0 + np.exp(-g)) * u


@pytest.mark.parametrize("E,C,D,F,row_pad,small", [
    (2, 9, 16, 24, 3, False),     # C 9, a strided x, F off one 64-box
    (1, 1, 8, 8, 0, False),       # C 1, D 8 and F 8
    (2, 37, 72, 136, 0, True),    # 3 chunks of 16; D off a stage; 2 F-tiles
    (1, 321, 24, 40, 0, False),   # 3 chunks of 112 rows
    (2, 70, 136, 200, 1, True),   # 5 chunks, D past two stages, F 200
    (1, 5, 2056, 16, 0, False),   # D 2056: 33 stages, the last of 8 rows
])
def test_k1_transliteration_matches_plain(E, C, D, F, row_pad, small):
    """dg, du and y against the plain backward and forward (f32, 1e-5)
    at ragged shapes; the empty expert gives zeros."""
    xb, wg, wu, dout = _k1_case(E * 31 + C, E, C, D, F, row_pad)
    dg, du, y = _k1_run(xb, wg, wu, dout, row_pad,
                        SMALL_K1 if small else None)
    t = [torch.from_numpy(a) for a in (xb[:, row_pad:], wg, wu, dout)]
    pg, pu = MG.moe_ffn_fused_bwd_ref(*t)
    for got, want in ((dg, pg), (du, pu),
                      (y, MG.moe_ffn_fused_ref(*t[:3]))):
        np.testing.assert_allclose(got, want.numpy(), **TOL)
        if E > 1:
            assert not got[E - 1].any()


@pytest.mark.parametrize("E,C,D,F,row_pad", [
    (2, 9, 24, 40, 3),            # C 9, a strided x, an empty expert
    (2, 161, 24, 40, 0),          # two chunks of 88 and 73 rows
    (1, 1, 16, 8, 0),             # C 1, F 8
    (3, 37, 72, 136, 2),          # D off a stage, F past a 128-column tile
    (1, 170, 136, 72, 0),         # C past a 160-row chunk, D past two stages
])
def test_k1_recomputes_the_forward_and_matches_plain(E, C, D, F, row_pad):
    """K1 (wgrad::dgu_kernel) on inputs whose f32 sums are exact: its y
    equals the fused forward's transliteration (tc_kernel's tile loop) bit
    for bit, so its g and u are the forward's accumulators, and dg and du
    equal ``swiglu_bwd_np`` of them bit for bit; rounded to bf16 as the
    kernel stores them, they equal the rounding of the same values."""
    xb, wg, wu, dout = _k1_case(C + D, E, C, D, F, row_pad, exact=True)
    dg, du, y = _k1_run(xb, wg, wu, dout, row_pad)
    fwd = _run(xb, wg, wu, C, row_pad, True)
    assert np.array_equal(y, fwd)
    want = _k1_exact(xb, wg, wu, dout, row_pad)
    for got, w in zip((dg, du, y), want):
        assert np.array_equal(got, w)
    rounded = _k1_run(xb, wg, wu, dout, row_pad, bf16=True)
    for got, w in zip(rounded, want):
        assert np.array_equal(got, _round_bf16(w))


def test_k1_k_order_and_no_y():
    """Every accumulator of K1 takes its k16 steps in increasing k, each
    exactly once, past a ragged end of D; without y nothing else
    changes."""
    xb, wg, wu, dout = _k1_case(3, 2, 21, 72, 40, exact=True)
    order = {}
    dg, du, y = _k1_run(xb, wg, wu, dout, 0, SMALL_K1, order=order)
    BK = SMALL_K1[1]
    assert order and all(ks == list(range(0, -(-72 // BK) * BK, 16))
                         for ks in order.values())
    assert len(order) == 2 * 2 * 1 * 2     # experts x F-tiles x gate|up
    ng, nu, ny = _k1_run(xb, wg, wu, dout, 0, SMALL_K1, with_y=False)
    assert ny is None and np.array_equal(ng, dg) and np.array_equal(nu, du)


@pytest.mark.parametrize("C", [21, 37])
def test_k1_blocks_walk_units_across_experts(C):
    """A grid of 2 blocks walks the units across experts and chunks at
    the small shape (dout's tiles reloaded for each unit after the last
    unit's stores): equal to the one-unit-a-block grid bit for bit and to
    the plain backward."""
    xb, wg, wu, dout = _k1_case(C, 3, C, 136, 200)
    walked = _k1_run(xb, wg, wu, dout, 0, SMALL_K1, grid=2)
    alone = _k1_run(xb, wg, wu, dout, 0, SMALL_K1, grid=10 ** 6)
    t = [torch.from_numpy(a) for a in (xb, wg, wu, dout)]
    plain = list(MG.moe_ffn_fused_bwd_ref(*t)) + [MG.moe_ffn_fused_ref(
        *t[:3])]
    for w, o, p in zip(walked, alone, plain):
        assert np.array_equal(w, o)
        np.testing.assert_allclose(w, p.numpy(), **TOL)


def test_k1_at_the_train_shape():
    """qwen3-moe's train shape (C 160, D 2048, F 768: one chunk, 32
    stages, 6 F-tiles an expert) at E 2, one block a unit and a grid of 5
    blocks walking the 12 units across both experts, on exact inputs: dg,
    du and y bit for bit those of the exact g and u."""
    xb, wg, wu, dout = _k1_case(160, 2, 160, 2048, 768, exact=True)
    want = _k1_exact(xb, wg, wu, dout, 0)
    for grid in (None, 5):
        got = _k1_run(xb, wg, wu, dout, 0, grid=grid)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)

"""Mamba-2 SSD chunked scan: the CUDA kernels' wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``ssd_chunk`` of
``src/repro/kernels/ssd_chunk/ssd_chunk.py`` (``pl.pallas_call`` at :81).
The port keeps the TPU kernel's name, but the function and signature are
those of what the model calls, the reference's ``_ssd_chunked``
(``src/repro/models/ssd.py:81-135``): it starts from a state ``S0`` and
returns the final state, and B and C arrive grouped, not expanded to heads.
The kernels are in ``csrc/ssd_chunk.cu``; its header says what bounds them
on the card and how their design answers it. bf16 inputs take two
kernels in one call (the state carried across the chunks, tile by tile;
then every chunk's outputs in parallel; products on the tensor cores), f32
inputs one (a block walks the chunks in order; products on the CUDA
cores).

The backward, ``ssd_chunk_bwd``, is three kernels in ``csrc/ssd_chunk_bwd.cu``
(the state's gradient carried across the chunks from the last; every
chunk's dx, ddt and dB, dC shares in parallel; the shares summed in
order): bf16 inputs with heads of at most 64 on the tensor cores (a share
sums a slice of one group's heads, C·B^T made once a slice), f32 inputs
(and wider bf16 heads) on the CUDA cores (a share a head); its header says
what bounds it. ``SSDChunk`` wraps forward and backward in an autograd
Function, which ``ssd_chunk`` goes through while autograd records. The
plain forward masks the decay's exponent before ``exp`` (above the
diagonal ``exp(cum_i - cum_j)`` overflows once a chunk's decay passes
~88, and the masked product's gradient is then 0 x inf = NaN);
``ssd_chunk_bwd_ref`` writes the gradient out.

The wrappers take the plain versions only for tensors on the CPU. For a
CUDA tensor they launch the kernels or raise: there is no fallback.
``LAUNCHES`` counts wrapper calls that launched (one per successful call,
whatever the number of kernels, nowhere else).

DTensor inputs (the port's distribution layer) run the kernels on every
rank's shards through ``local_map``, in the layout
``kernels.sharded.scan_layout`` picks: batch and head splits stay (each
rank scans its rows and heads, no collective); B and C split with the
heads where the groups divide the axis, else replicated and each rank
handed the groups of its own heads, so their gradients are partial sums
over the axis (``Partial``, stated, not inferred); a split sequence or a
partial sum is redistributed whole explicitly first. On a ``FakeTensor``
(the dry run) the wrappers allocate their outputs and report the work:
the mathematical products of the reference's ``_ssd_chunked``
(``ssd_products``, B and C repeated to the heads as it repeats them) and,
for the backward, the two products autodiff makes of each; not the bf16
route's hi + lo split of the f32 operands, which is how the card computes
them, not what the function needs.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import sharded as SH
from repro_torch.kernels.build import call_on_stream, load

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"ssd_chunk": 0, "ssd_chunk_bwd": 0}

#: largest chunk length and state size one block's shared memory holds
MAX_CHUNK = MAX_STATE = 128
#: largest head width the backward's chunk kernel holds; the tensor-core
#: route's (bf16 inputs), at most TC_HEAD_BWD
MAX_HEAD_BWD = 128
TC_HEAD_BWD = 64

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_I, _P, _LL, _LL, _P, _P, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P,
             _P, _I, _I, _I, _I, _I, _I, _I, _P]
_BWD_ARGTYPES = ([_I, _P, _LL, _LL, _P, _P, _P, _LL, _LL, _P, _LL, _LL]
                 + [_P] * 14 + [_I] * 8 + [_P])
_lib = _bwd_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("ssd_chunk")
        lib.ssd_chunk_launch.argtypes = _ARGTYPES
        lib.ssd_chunk_launch.restype = ctypes.c_int
        lib.ssd_chunk_ws_floats.argtypes = [_I] * 7
        lib.ssd_chunk_ws_floats.restype = _LL
        lib.ssd_chunk_occupancy.argtypes = [_I]
        lib.ssd_chunk_occupancy.restype = _I
        _lib = lib
    return _lib


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        lib = load("ssd_chunk_bwd")
        lib.ssd_chunk_bwd_launch.argtypes = _BWD_ARGTYPES
        lib.ssd_chunk_bwd_launch.restype = ctypes.c_int
        lib.ssd_chunk_bwd_shares.argtypes = [_I] * 4
        lib.ssd_chunk_bwd_shares.restype = _I
        lib.ssd_chunk_bwd_occupancy.argtypes = [_I]
        lib.ssd_chunk_bwd_occupancy.restype = _I
        _bwd_lib = lib
    return _bwd_lib


def _wide(t):
    """t in f32, or in f64 where it is f64 (the gradient checks)."""
    return t if t.dtype == torch.float64 else t.float()


@functools.lru_cache(maxsize=None)
def _ws_floats(code: int, b: int, l: int, nh: int, hp: int, n: int,
               Q: int) -> int:
    """f32 scratch of a launch (the bf16 route's state entering each
    chunk), its size the library's."""
    return _library().ssd_chunk_ws_floats(code, b, l, nh, hp, n, Q)


def ssd_chunk_ref(x, dt, A, B, C, S0, chunk: int):
    """Port of ``_ssd_chunked``. x: [b, l, nh, hp]; dt: [b, l, nh] f32
    (post-softplus); A: [nh] f32 (negative); B, C: [b, l, g, n]; S0:
    [b, nh, hp, n] f32. Chunks of Q = min(chunk, l) steps (the last one
    zero-padded); the products run in f32 (f64 for f64 inputs). Returns
    (y [b, l, nh, hp] f32, S_final [b, nh, hp, n] f32)."""
    b, l, nh, hp = x.shape
    g = B.shape[2]
    Q = min(chunk, l)
    pad = (-l) % Q
    if pad:
        def zpad(t):
            return torch.cat([t, t.new_zeros((b, pad) + tuple(t.shape[2:]))],
                             dim=1)
        x, dt, B, C = zpad(x), zpad(dt), zpad(B), zpad(C)
    hpg = nh // g
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    S = _wide(S0)
    ys = []
    for c in range(x.shape[1] // Q):
        sl = slice(c * Q, (c + 1) * Q)
        dtq = _wide(dt[:, sl])                           # [b, Q, nh]
        cum = torch.cumsum(dtq * A, dim=1)
        Bh = _wide(B[:, sl]).repeat_interleave(hpg, dim=2)    # [b, Q, nh, n]
        Ch = _wide(C[:, sl]).repeat_interleave(hpg, dim=2)
        xdt = _wide(x[:, sl]) * dtq[..., None]           # [b, Q, nh, hp]
        seg = cum[:, :, None, :] - cum[:, None, :, :]    # [b, Q, Q, nh] (i, j)
        # masked before the exponent: above the diagonal seg > 0, and its
        # exp overflows once the chunk's decay passes ~88
        ldec = torch.exp(torch.where(causal, seg, -torch.inf))
        scores = torch.einsum("bihn,bjhn->bijh", Ch, Bh)
        y_diag = torch.einsum("bijh,bjhp->bihp", scores * ldec, xdt)
        y_off = torch.einsum("bihn,bhpn->bihp",
                             Ch * torch.exp(cum)[..., None], S)
        decay_out = torch.exp(cum[:, -1:, :] - cum)      # [b, Q, nh]
        S = (torch.exp(cum[:, -1, :])[..., None, None] * S
             + torch.einsum("bjhn,bjhp->bhpn", Bh * decay_out[..., None],
                            xdt))
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1)[:, :l], S


def _check(x, dt, A, B, C, S0, chunk: int):
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cpu or cuda tensors, got "
                         f"{x.device}")
    if any(t.device != x.device for t in (dt, A, B, C, S0)):
        raise ValueError("x, dt, A, B, C and S0 must be on one device")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise ValueError(f"x {x.dtype}, B {B.dtype}, C {C.dtype}: the kernel "
                         f"takes one of {list(_DTYPE_CODE)} for all three")
    if any(t.dtype != torch.float32 for t in (dt, A, S0)):
        raise ValueError(f"dt {dt.dtype}, A {A.dtype}, S0 {S0.dtype} must "
                         f"be float32")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} and B {tuple(B.shape)} must be "
                         f"4-d")
    b, l, nh, hp = x.shape
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, l, nh) or A.shape != (nh,) \
            or B.shape != (b, l, g, n) or C.shape != B.shape \
            or S0.shape != (b, nh, hp, n):
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}, S0 {tuple(S0.shape)}: "
            f"need [b, l, nh, hp], [b, l, nh], [nh], [b, l, g, n] twice and "
            f"[b, nh, hp, n]")
    if nh % g:
        raise ValueError(f"{nh} heads do not split into {g} groups")
    Q = min(chunk, l)
    if not (1 <= b <= 65535 and nh <= 65535 and 1 <= Q <= MAX_CHUNK
            and 1 <= n <= MAX_STATE):
        raise ValueError(f"b {b}, nh {nh}, chunk {Q}, n {n}: need b and nh "
                         f"<= 65535, chunk <= {MAX_CHUNK}, n <= {MAX_STATE}")
    if x.stride(3) != 1 or x.stride(2) != hp:
        raise ValueError(f"x strides {x.stride()}: heads must be contiguous "
                         f"[hp] rows")
    for name, t in (("B", B), ("C", C)):
        if t.stride(3) != 1 or t.stride(2) != n:
            raise ValueError(f"{name} strides {t.stride()}: groups must be "
                             f"contiguous [n] rows")
    if not all(t.is_contiguous() for t in (dt, A, S0)):
        raise ValueError("dt, A and S0 must be contiguous")
    return b, l, nh, hp, g, n, Q


def ssd_products(b: int, l: int, nh: int, hp: int, n: int,
                 chunk: int) -> int:
    """FLOPs (2 a multiply-add) of the reference's ``_ssd_chunked``
    forward: per chunk of Q steps (the last one padded) and head, C·B^T on
    B and C repeated to the heads (Q² n), the diagonal product (Q² hp), the
    carried state's product and the state update (Q n hp each)."""
    Q = min(chunk, l)
    nc = -(-l // Q)
    return 2 * b * nc * nh * (Q * Q * (n + hp) + 2 * Q * n * hp)


def _in_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _layout(x, B):
    return SH.scan_layout(x, x.shape[2], B.shape[2])


def _sharded(x, dt, A, B, C, S0, chunk: int):
    """``ssd_chunk`` on DTensors (tensors count as replicated): the
    kernels (their plain version on CPU shards) on every rank's shards
    through ``local_map``, in ``scan_layout``'s layout, B and C cut to the
    groups of the rank's heads; differentiable as the local call is
    (``SSDChunk``), the gradients of A, B and C partial sums where the
    layout says so."""
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    lay = _layout(x, B)
    x, dt = (SH.redistribute(t, mesh, lay.seq) for t in (x, dt))
    A = SH.redistribute(A, mesh, lay.heads)
    B, C = (SH.redistribute(t, mesh, lay.groups) for t in (B, C))
    S0 = SH.redistribute(S0, mesh, lay.state)

    def local(xl, dtl, Al, Bl, Cl, Sl):
        return ssd_chunk(xl, dtl.contiguous(), Al.contiguous(),
                         SH.select_groups(Bl, lay.group_sel, 2),
                         SH.select_groups(Cl, lay.group_sel, 2),
                         Sl.contiguous(), chunk)

    s, st, hd, hg, gr, gg = (list(p) for p in lay[:6])
    return local_map(local, out_placements=(s, st),
                     in_placements=(s, s, hd, gr, gr, st),
                     in_grad_placements=(s, s, hg, gg, gg, st),
                     device_mesh=mesh)(x, dt, A, B, C, S0)


def _sharded_bwd(x, dt, A, B, C, S0, dy, dS_final, chunk: int):
    """``ssd_chunk_bwd`` on DTensors, in ``ssd_chunk``'s layout: (dx, ddt,
    dA, dB, dC, dS0) laid out as their inputs' gradients are there (dA,
    dB and dC partial sums where the layout says so; a rank's dB and dC
    placed at its heads' groups, zeros elsewhere)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    lay = _layout(x, B)
    x, dt, dy = (SH.redistribute(t, mesh, lay.seq) for t in (x, dt, dy))
    A = SH.redistribute(A, mesh, lay.heads)
    B, C = (SH.redistribute(t, mesh, lay.groups) for t in (B, C))
    S0, dS_final = (SH.redistribute(t, mesh, lay.state)
                    for t in (S0, dS_final))

    def local(xl, dtl, Al, Bl, Cl, Sl, dyl, dSl):
        sel = lay.group_sel
        dx, ddt, dA, dB, dC, dS0 = ssd_chunk_bwd(
            xl, dtl.contiguous(), Al.contiguous(),
            SH.select_groups(Bl, sel, 2), SH.select_groups(Cl, sel, 2),
            Sl.contiguous(), dyl, dSl, chunk)
        n = Bl.shape[2]
        return (dx, ddt, dA, SH.scatter_groups(dB, sel, 2, n),
                SH.scatter_groups(dC, sel, 2, n), dS0)

    s, st, hd, hg, gr, gg = (list(p) for p in lay[:6])
    return local_map(local, out_placements=(s, s, hg, gg, gg, st),
                     in_placements=(s, s, hd, gr, gr, st, s, st),
                     device_mesh=mesh)(x, dt, A, B, C, S0, dy, dS_final)


def _forward(x, dt, A, B, C, S0, chunk: int):
    """(y, S_final, ws): the kernels' launch; ws is the bf16 route's
    workspace, the state entering each chunk (empty on the f32 route and
    None on the CPU and on fake tensors)."""
    if SH.is_fake(x):        # the dry run: the kernels' outputs and work
        b, l, nh, hp = x.shape
        y = x.new_empty((b, l, nh, hp), dtype=torch.float32)
        SH.report_work("ssd_chunk",
                       ssd_products(b, l, nh, hp, B.shape[3], chunk),
                       _in_bytes(x, dt, A, B, C, S0, S0, y))
        return y, torch.empty_like(S0), None
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, A, B, C, S0, chunk) + (None,)
    b, l, nh, hp, g, n, Q = _check(x, dt, A, B, C, S0, chunk)
    code = _DTYPE_CODE[x.dtype]
    y = torch.empty((b, l, nh, hp), dtype=torch.float32, device=x.device)
    S_final = torch.empty_like(S0)
    ws = torch.empty(_ws_floats(code, b, l, nh, hp, n, Q),
                     dtype=torch.float32, device=x.device)
    rc = call_on_stream(
        _library().ssd_chunk_launch, x, code, x.data_ptr(), x.stride(0),
        x.stride(1), dt.data_ptr(), A.data_ptr(), B.data_ptr(), B.stride(0),
        B.stride(1), C.data_ptr(), C.stride(0), C.stride(1), S0.data_ptr(),
        y.data_ptr(), S_final.data_ptr(), ws.data_ptr(), b, l, nh, hp, g, n,
        Q)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES["ssd_chunk"] += 1
    return y, S_final, ws


def ssd_chunk_bwd_ref(x, dt, A, B, C, S0, dy, dS_final, chunk: int):
    """The gradient of ``ssd_chunk``, written out chunk by chunk (not by
    autograd): from its inputs, dy [b, l, nh, hp] (y's gradient) and
    dS_final [b, nh, hp, n] -> (dx, ddt, dA, dB, dC, dS0), each in its
    input's dtype. With xdt_j = dt_j x_j, L_ij = exp(cum_i - cum_j) for
    j <= i (the exponent masked first), S_in the state entering a chunk and
    dS_out the gradient of the one leaving it:

    * ``dS_in = exp(cum_Q) dS_out + sum_i exp(cum_i) dy_i^T C_i``, carried
      from dS_final across the chunks in reverse; chunk 0's is dS0;
    * ``dxdt_j = sum_{i>=j} (C_i·B_j) L_ij dy_i + exp(cum_Q - cum_j)
      dS_out B_j``: dx = dt dxdt and ddt's first term x·dxdt;
    * dC and dB from the same products (``W = L ∘ dy xdt^T``), summed over
      the heads of a group;
    * dcum from every exp term (the diagonal's row and column sums, the
      carried state's, the state update's), reverse-summed within the
      chunk: ``ddt += A rcumsum(dcum)``, ``dA = sum dt rcumsum(dcum)``."""
    b, l, nh, hp = x.shape
    g, n = B.shape[2], B.shape[3]
    Q = min(chunk, l)
    pad = (-l) % Q
    nc, hpg = (l + pad) // Q, nh // g

    def chunks(t):                  # [b, l, ...] -> [b, nc, Q, ...], padded
        t = _wide(t)
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + tuple(t.shape[2:]))],
                          dim=1)
        return t.reshape((b, nc, Q) + tuple(t.shape[2:]))

    xc, dtc, Bc, Cc, dyc = (chunks(t) for t in (x, dt, B, C, dy))
    Af = _wide(A)
    Bh = Bc.repeat_interleave(hpg, dim=3)                # [b, nc, Q, nh, n]
    Ch = Cc.repeat_interleave(hpg, dim=3)
    cum = torch.cumsum(dtc * Af, dim=2)                  # [b, nc, Q, nh]
    last = cum[:, :, -1]                                 # [b, nc, nh]
    ecum, edec = torch.exp(cum), torch.exp(last[:, :, None] - cum)
    xdt = xc * dtc[..., None]                            # [b, nc, Q, nh, hp]
    # the state entering each chunk, then the gradient leaving each
    upd = torch.einsum("bcjhn,bcjhp->bchpn", Bh * edec[..., None], xdt)
    S, S_in = _wide(S0), []
    for c in range(nc):
        S_in.append(S)
        S = torch.exp(last[:, c])[..., None, None] * S + upd[:, c]
    S_in = torch.stack(S_in, 1)                          # [b, nc, nh, hp, n]
    back = torch.einsum("bcihp,bcihn->bchpn", dyc * ecum[..., None], Ch)
    dS, dS_out = _wide(dS_final), [None] * nc
    for c in reversed(range(nc)):
        dS_out[c] = dS
        dS = torch.exp(last[:, c])[..., None, None] * dS + back[:, c]
    dS_out = torch.stack(dS_out, 1)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[:, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b, nc, i, j, nh]
    Lm = torch.exp(torch.where(causal, seg, -torch.inf))
    M = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * Lm  # (C_i·B_j) L_ij
    R = torch.einsum("bcihp,bcjhp->bcijh", dyc, xdt)     # dy_i·xdt_j
    Wm = R * Lm
    dxdt_state = edec[..., None] * torch.einsum("bcjhn,bchpn->bcjhp", Bh,
                                                dS_out)
    dxdt = torch.einsum("bcijh,bcihp->bcjhp", M, dyc) + dxdt_state
    dCh = (torch.einsum("bcijh,bcjhn->bcihn", Wm, Bh) + ecum[..., None]
           * torch.einsum("bcihp,bchpn->bcihn", dyc, S_in))
    dBh = (torch.einsum("bcijh,bcihn->bcjhn", Wm, Ch) + edec[..., None]
           * torch.einsum("bcjhp,bchpn->bcjhn", xdt, dS_out))
    # dcum: the diagonal's T_ij = M_ij R_ij (+ at i, - at j), the carried
    # state's U_i, the state update's V_j (- at j, + at the chunk's end)
    # and exp(cum_Q) <dS_out, S_in> (at the end)
    T = M * R
    U = ecum * torch.einsum("bcihp,bchpn,bcihn->bcih", dyc, S_in, Ch)
    V = (xdt * dxdt_state).sum(-1)
    dcum = T.sum(3) - T.sum(2) + U - V
    dcum[:, :, -1] += (torch.exp(last) * (dS_out * S_in).sum((-2, -1))
                       + V.sum(2))
    rc = dcum.flip(2).cumsum(2).flip(2)
    ddt = (xc * dxdt).sum(-1) + Af * rc
    dA = (dtc * rc).sum((0, 1, 2))

    def unchunk(t, like):
        return t.reshape((b, nc * Q) + tuple(t.shape[3:]))[:, :l].to(
            like.dtype)

    dB = dBh.reshape(b, nc, Q, g, hpg, n).sum(4)
    dC = dCh.reshape(b, nc, Q, g, hpg, n).sum(4)
    return (unchunk(dxdt * dtc[..., None], x), unchunk(ddt, dt),
            dA.to(A.dtype), unchunk(dB, B), unchunk(dC, C),
            dS.to(S0.dtype))


@functools.lru_cache(maxsize=None)
def _bwd_shares(code: int, nh: int, hp: int, g: int) -> int:
    """Shares of the backward's dB, dC workspaces, the library's count."""
    return _bwd_library().ssd_chunk_bwd_shares(code, nh, hp, g)


def ssd_chunk_bwd(x, dt, A, B, C, S0, dy, dS_final, chunk: int, ws=None):
    """(dx, ddt, dA, dB, dC, dS0) of ``ssd_chunk_bwd_ref``: the plain
    version on the CPU, else the three backward kernels (one call). ``ws``
    is the forward's workspace on the bf16 route (the state entering each
    chunk); without it the forward's kernels recompute those states first
    on the tensor-core route (bf16, hp <= TC_HEAD_BWD), and the first
    kernel does on the CUDA-core route. DTensors run on every rank's
    shards (``_sharded_bwd``)."""
    if SH.is_dtensor(x):
        return _sharded_bwd(x, dt, A, B, C, S0, dy, dS_final, chunk)
    if SH.is_fake(x):        # the dry run: the gradients and the work
        b, l, nh, hp = x.shape
        SH.report_work("ssd_chunk_bwd",
                       2 * ssd_products(b, l, nh, hp, B.shape[3], chunk),
                       2 * _in_bytes(x, dt, A, B, C, S0)
                       + _in_bytes(dy, dS_final))
        return (torch.empty_like(x), torch.empty_like(dt),
                torch.empty_like(A), torch.empty_like(B),
                torch.empty_like(C), torch.empty_like(S0))
    if x.device.type == "cpu":
        return ssd_chunk_bwd_ref(x, dt, A, B, C, S0, dy, dS_final, chunk)
    b, l, nh, hp, g, n, Q = _check(x, dt, A, B, C, S0, chunk)
    if hp > MAX_HEAD_BWD:
        raise ValueError(f"hp {hp}: the backward takes heads of at most "
                         f"{MAX_HEAD_BWD}")
    dy, dS_final = dy.float().contiguous(), dS_final.float().contiguous()
    if dy.shape != (b, l, nh, hp) or dS_final.shape != S0.shape \
            or dy.device != x.device or dS_final.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)}, dS_final "
                         f"{tuple(dS_final.shape)}: need {(b, l, nh, hp)} "
                         f"and {tuple(S0.shape)} on {x.device}")
    code = _DTYPE_CODE[x.dtype]
    nc = -(-l // Q)
    states = (b, nc, nh, hp, n)
    recompute = ws is None or ws.numel() == 0
    if recompute and code == 0 and hp <= TC_HEAD_BWD:
        ws, recompute = _forward(x, dt, A, B, C, S0, chunk)[2], False
    elif recompute:
        ws = torch.empty(states, dtype=torch.float32, device=x.device)
    elif ws.numel() != math.prod(states) or not ws.is_contiguous():
        raise ValueError(f"ws of {ws.numel()} floats: need the forward's "
                         f"{math.prod(states)}")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    dS_out, dS0 = f32(*states), torch.empty_like(S0)
    dx = torch.empty((b, l, nh, hp), dtype=x.dtype, device=x.device)
    ddt, dA = f32(b, l, nh), f32(nh)
    shares = _bwd_shares(code, nh, hp, g)
    pdB, pdC, pdA = (f32(b, l, shares, n), f32(b, l, shares, n),
                     f32(b, nc, nh))
    dB = torch.empty((b, l, g, n), dtype=B.dtype, device=x.device)
    dC = torch.empty((b, l, g, n), dtype=C.dtype, device=x.device)
    rc = call_on_stream(
        _bwd_library().ssd_chunk_bwd_launch, x, code, x.data_ptr(),
        x.stride(0), x.stride(1), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        B.stride(0), B.stride(1), C.data_ptr(), C.stride(0), C.stride(1),
        S0.data_ptr(), dy.data_ptr(), dS_final.data_ptr(), ws.data_ptr(),
        dS_out.data_ptr(), dS0.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        pdB.data_ptr(), pdC.data_ptr(), pdA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dA.data_ptr(), b, l, nh, hp, g, n, Q, int(recompute))
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_bwd kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["ssd_chunk_bwd"] += 1
    return dx, ddt, dA, dB, dC, dS0


class SSDChunk(torch.autograd.Function):
    """``ssd_chunk`` with a gradient: the forward is the scan (the plain
    version on the CPU) and saves its inputs and, on the bf16 route, the
    forward's workspace of chunk states (kept: 4 B an element of [b, nc,
    nh, hp, n], 67 MB at mamba2-1.3b's training microbatch, against a
    recompute as long as the forward's first kernel); the backward is the
    three backward kernels, whose gradients come back where they are
    needed. On DTensors ``apply`` runs the Function on every rank's
    shards (``_sharded``)."""

    @classmethod
    def apply(cls, x, dt, A, B, C, S0, chunk):
        if SH.is_dtensor(x):
            return _sharded(x, dt, A, B, C, S0, chunk)
        return super().apply(x, dt, A, B, C, S0, chunk)

    @staticmethod
    def forward(ctx, x, dt, A, B, C, S0, chunk):
        y, S_final, ws = _forward(x, dt, A, B, C, S0, chunk)
        ctx.save_for_backward(x, dt, A, B, C, S0,
                              ws if ws is not None and ws.numel() else None)
        ctx.chunk = chunk
        return y, S_final

    @staticmethod
    def backward(ctx, dy, dS_final):
        x, dt, A, B, C, S0, ws = ctx.saved_tensors
        grads = ssd_chunk_bwd(x, dt, A, B, C, S0, dy, dS_final, ctx.chunk,
                              ws=ws)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def ssd_chunk(x, dt, A, B, C, S0, chunk: int):
    """The chunked SSD scan of ``_ssd_chunked``: (y [b, l, nh, hp] f32,
    S_final [b, nh, hp, n] f32). See ``ssd_chunk_ref`` for the layouts.
    Differentiable in every tensor input (``SSDChunk``) while autograd
    records. DTensors run it on every rank's shards (``_sharded``)."""
    if SH.is_dtensor(x):
        return _sharded(x, dt, A, B, C, S0, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C, S0)):
        return SSDChunk.apply(x, dt, A, B, C, S0, chunk)
    return _forward(x, dt, A, B, C, S0, chunk)[:2]

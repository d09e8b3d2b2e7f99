"""Flash attention over a whole sequence (prefill, encoder, cross
attention): the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention/flash_attention.py`` (``pl.pallas_call``
at :98) and computes the function the model calls, the reference's jnp
``blocked_attention`` (``src/repro/models/attention.py:150-184``) with no
window and no softcap: q [b, sq, hq, d] and k/v [b, skv, kh, d] in the
model's layout, query and key positions [sq] / [skv] shared across the
batch (a key at position -1 is invalid), ``causal`` masking keys after the
query's position, scale 1/sqrt(d), f32 scores and statistics, probabilities
rounded to v's dtype before the PV product. With positions ``arange`` and
sq == skv this is the Pallas kernel's function.

The kernel (``csrc/flash_attention.cu``) is bound by operations: 34.4 GFLOP
at minitron-8b's 2048-token causal prefill, 0.035 ms at the card's bf16
rate. Its bf16 route keeps S, P and O in registers on ``mma.sync``
(m16n8k16, f32 accumulate), with Q held as A fragments, P reused from the S
accumulators as the A operand of PV, the online softmax on the registers
with quad shuffles, and K/V tiles of 64 keys double-buffered by
``cp.async``; ``wgmma`` and TMA are left to later work. Its f32 route (for
checks) runs on the CUDA cores without TF32.

The plain version is ``blocked_attention``, the port's loop over query and
key blocks (it also takes the window and softcap the model's other paths
need). The wrapper takes it only for tensors on the CPU. For a CUDA tensor
it launches the kernel or raises: there is no fallback. ``LAUNCHES`` counts
kernel launches (one per successful launch, nowhere else).

Training: ``FlashAttention`` (a ``torch.autograd.Function``) is what
``flash_attention`` calls while autograd records. Its forward also writes
each row's log-sum-exp (``lse`` [b, hq, sq] f32, the kernel's optional
output; serving launches pass none and keep their bits); its backward is
``flash_attention_bwd``: the backward kernels of
``csrc/flash_attention_bwd.cu`` (the FlashAttention-2 recomputation from q,
k, v, o, lse and dO, no atomics) on the card, counted in
``LAUNCHES["flash_attention_bwd"]`` once a call, and their plain version
``flash_attention_bwd_ref`` on the CPU. The reference differentiates its
``blocked_attention`` by autodiff; its Pallas kernel has no backward.

A query row with no valid key is garbage in the plain version (uniform
weights over masked keys) and zeros from the kernel; the model never reads
such a row, and comparisons skip it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import call_on_stream, load

NEG_INF = -1e30

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = tuple(range(16, 129, 16))

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
_ARGTYPES = [_I, _I, _P, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL, _P, _P, _P,
             _P, _I, _I, _I, _I, _I, _I, _F, _P]
_BWD_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _I, _I, _F, _P]
_lib = None
_bwd_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("flash_attention")
        lib.flash_attention_launch.argtypes = _ARGTYPES
        lib.flash_attention_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        lib = load("flash_attention_bwd")
        lib.flash_attention_bwd_launch.argtypes = _BWD_ARGTYPES
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


# ---------------------------------------------------------------------------
# plain PyTorch version: the port of the reference's blocked_attention
# ---------------------------------------------------------------------------

def pad_to(x, dim, multiple, value=0):
    """``x`` padded with ``value`` along ``dim`` to a multiple of
    ``multiple``."""
    n = x.shape[dim]
    pad = (-n) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=dim)


def _acc_dtype(x) -> torch.dtype:
    """The plain versions' arithmetic: f32 for bf16 and f32 inputs, f64
    for f64 ones (``gradcheck``)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def blocked_attention(q, k, v, q_positions, k_positions, *, causal: bool,
                      window: int, block_q: int, block_kv: int,
                      softcap: float = 0.0, return_lse: bool = False):
    """Flash-style attention. q: [b, sq, hq, d]; k/v: [b, skv, kh, d];
    ``q_positions``/``k_positions``: [sq] / [skv] absolute positions (padding
    rows carry -1 keys). Scores and the running (m, l, o) statistics are
    f32; probabilities are rounded to v's dtype before the PV product, as in
    the reference. With ``return_lse`` also the f32 log-sum-exp of each
    row's scaled scores, ``m + log(l)`` [b, hq, sq]."""
    b, sq, hq, d = q.shape
    kh = k.shape[2]
    g = hq // kh
    scale = 1.0 / math.sqrt(d)
    acc = _acc_dtype(q)

    qp = pad_to(q, 1, block_q)
    qpos = pad_to(q_positions, 0, block_q)
    kp = pad_to(k, 1, block_kv)
    vp = pad_to(v, 1, block_kv)
    kpos = pad_to(k_positions, 0, block_kv, value=-1)
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_kv

    outs, lses = [], []
    for iq in range(nq):
        qs = slice(iq * block_q, (iq + 1) * block_q)
        qblk = qp[:, qs].reshape(b, block_q, kh, g, d).to(acc)
        qpb = qpos[qs]
        m = qblk.new_full((b, kh, g, block_q), NEG_INF)
        l = qblk.new_zeros((b, kh, g, block_q))
        o = qblk.new_zeros((b, kh, g, block_q, d))
        for ik in range(nk):
            ks = slice(ik * block_kv, (ik + 1) * block_kv)
            vblk = vp[:, ks]
            kpb = kpos[ks]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk,
                             kp[:, ks].to(acc)) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            valid = (kpb[None, :] >= 0)
            if causal:
                valid = valid & (kpb[None, :] <= qpb[:, None])
            if window:
                valid = valid & (kpb[None, :] > qpb[:, None] - window)
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd",
                              p.to(vblk.dtype).to(acc), vblk.to(acc))
            o = o * alpha[..., None] + pv
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-37)
        # [b, kh, g, bq, d] -> [b, bq, kh*g, d]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, block_q, hq, d)
                    .to(q.dtype))
        if return_lse:
            lses.append((m + torch.log(l)).reshape(b, hq, block_q))
    out = torch.cat(outs, dim=1)[:, :sq]
    if return_lse:
        return out, torch.cat(lses, dim=2)[:, :, :sq]
    return out


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _check(q, k, v, q_positions, k_positions) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v), ("q_positions", q_positions),
                    ("k_positions", k_positions)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                         f"kernel takes one of {list(_DTYPE_CODE)} for all")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need [b, sq, hq, d] and "
                         f"[b, skv, kh, d]")
    b, sq, hq, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel is built for {_HEAD_DIMS}")
    if not (1 <= b <= 65535 and sq >= 1 and skv >= 1 and kh >= 1
            and hq % kh == 0 and hq <= 65535):
        raise ValueError(f"b {b}, sq {sq}, skv {skv}, hq {hq}, kh {kh}: need "
                         f"1 <= b, hq <= 65535, sq, skv >= 1, kh | hq")
    if k.stride() != v.stride():
        raise ValueError("k and v must share strides")
    vec = 16 // q.element_size()
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError("q and k/v need unit stride along head_dim")
    if any(s % vec for s in q.stride()[:-1] + k.stride()[:-1]) \
            or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q and k/v rows must be 16-byte aligned")
    for name, t, n in (("q_positions", q_positions, sq),
                       ("k_positions", k_positions, skv)):
        if t.dtype != torch.int32 or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def _forward(q, k, v, q_positions, k_positions, causal: bool, block_q: int,
             block_kv: int, with_lse: bool):
    """(out, lse or None): the plain version on the CPU, else the kernel,
    which writes lse [b, hq, sq] f32 only when asked (a null pointer
    otherwise, so a launch without it is the serving launch, bit for
    bit)."""
    if q.device.type == "cpu":
        out = blocked_attention(q, k, v, q_positions, k_positions,
                                causal=causal, window=0, block_q=block_q,
                                block_kv=block_kv, return_lse=with_lse)
        return out if with_lse else (out, None)
    _check(q, k, v, q_positions, k_positions)
    b, sq, hq, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    rc = call_on_stream(
        _library().flash_attention_launch, q, _DTYPE_CODE[q.dtype], d,
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2), k.data_ptr(),
        v.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        q_positions.data_ptr(), k_positions.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, sq, skv, hq, kh,
        int(causal), 1.0 / math.sqrt(d))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_lse(q, k, v, q_positions, k_positions, *, causal: bool,
                        block_q: int = 256, block_kv: int = 1024):
    """``flash_attention``'s output and the f32 log-sum-exp of each row's
    scaled scores [b, hq, sq], the statistic the backward reads. Not
    differentiable (``FlashAttention`` is)."""
    return _forward(q, k, v, q_positions, k_positions, causal, block_q,
                    block_kv, True)


def flash_attention(q, k, v, q_positions, k_positions, *, causal: bool,
                    block_q: int = 256, block_kv: int = 1024):
    """q: [b, sq, hq, d]; k/v: [b, skv, kh, d]; q_positions [sq] and
    k_positions [skv] int32 -> [b, sq, hq, d] in q's dtype. ``block_q`` and
    ``block_kv`` are the plain version's blocks (its summation order, which
    the model's config fixes); the kernel tiles by 64. When autograd
    records (grad mode on and q, k or v requiring grad) the call goes
    through ``FlashAttention``, whose backward is the backward kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, q_positions, k_positions,
                                    causal, block_q, block_kv)
    return _forward(q, k, v, q_positions, k_positions, causal, block_q,
                    block_kv, False)[0]


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_ref(q, k, v, o, lse, do, q_positions, k_positions,
                            *, causal: bool, block_q: int, block_kv: int):
    """The plain backward: (dq, dk, dv) in q's dtype, by the recomputation
    the kernel does, blocked like ``blocked_attention``. ``D = rowsum(dO *
    O)`` and everything after it in f32; ``P = exp(S * scale - lse)`` under
    the forward's position mask, an explicit zero where a key is invalid
    (so a row with no valid key gets zero gradients); ``dV = P^T dO`` with
    P rounded to v's dtype, as the forward rounds it before PV; ``dP = dO
    V^T``; ``dS = P * (dP - D)``; ``dK = dS^T Q * scale``; ``dQ = dS K *
    scale``. GQA sums dK and dV over the g query heads of a KV head."""
    b, sq, hq, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = hq // kh
    scale = 1.0 / math.sqrt(d)
    acc = _acc_dtype(q)
    # [b, hq, sq] -> [b, kh, g, sq]
    D = (do.to(acc) * o.to(acc)).sum(-1).permute(0, 2, 1) \
        .reshape(b, kh, g, sq)
    lse = lse.to(acc).reshape(b, kh, g, sq)

    qp = pad_to(q, 1, block_q).to(acc)
    dop = pad_to(do, 1, block_q).to(acc)
    qpos = pad_to(q_positions, 0, block_q)
    Dp = pad_to(D, 3, block_q)
    lsep = pad_to(lse, 3, block_q)
    kp = pad_to(k, 1, block_kv).to(acc)
    vp = pad_to(v, 1, block_kv)
    kpos = pad_to(k_positions, 0, block_kv, value=-1)
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_kv
    dk = kp.new_zeros(kp.shape)
    dv = kp.new_zeros(kp.shape)
    dqs = []
    for iq in range(nq):
        qs = slice(iq * block_q, (iq + 1) * block_q)
        qblk = qp[:, qs].reshape(b, block_q, kh, g, d)
        doblk = dop[:, qs].reshape(b, block_q, kh, g, d)
        qpb = qpos[qs]
        dq = qblk.new_zeros(qblk.shape)
        for ik in range(nk):
            ks = slice(ik * block_kv, (ik + 1) * block_kv)
            kpb = kpos[ks]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kp[:, ks]) * scale
            valid = kpb[None, :] >= 0
            if causal:
                valid = valid & (kpb[None, :] <= qpb[:, None])
            p = torch.where(valid, torch.exp(s - lsep[..., qs, None]),
                            torch.zeros_like(s))
            dv[:, ks] += torch.einsum("bhgqk,bqhgd->bkhd",
                                      p.to(v.dtype).to(acc), doblk)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doblk, vp[:, ks].to(acc))
            ds = p * (dp - Dp[..., qs, None])
            dk[:, ks] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qblk) * scale
            dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kp[:, ks]) * scale
        dqs.append(dq.reshape(b, block_q, hq, d))
    dq = torch.cat(dqs, dim=1)[:, :sq]
    return (dq.to(q.dtype), dk[:, :skv].to(q.dtype),
            dv[:, :skv].to(q.dtype))


def _check_bwd(q, k, v, o, lse, do, q_positions, k_positions) -> None:
    _check(q, k, v, q_positions, k_positions)
    b, sq, hq, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}: need q's {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse {lse.dtype} {tuple(lse.shape)}: need float32 "
                         f"[{b}, {hq}, {sq}]")


def flash_attention_bwd(q, k, v, o, lse, do, q_positions, k_positions, *,
                        causal: bool, block_q: int = 256,
                        block_kv: int = 1024):
    """(dq, dk, dv) of ``flash_attention`` given its output ``o``, the
    log-sum-exp ``lse`` [b, hq, sq] f32 its forward wrote and ``do``, the
    gradient of the output: the plain version on the CPU, else the backward
    kernels (``csrc/flash_attention_bwd.cu``) or raise. One count of
    ``LAUNCHES["flash_attention_bwd"]`` a call (its three kernels:
    ``D = rowsum(dO * O)``, dK/dV, dQ)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, q_positions,
                                       k_positions, causal=causal,
                                       block_q=block_q, block_kv=block_kv)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    _check_bwd(q, k, v, o, lse, do, q_positions, k_positions)
    b, sq, hq, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ws = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    rc = call_on_stream(
        _bwd_library().flash_attention_bwd_launch, q, _DTYPE_CODE[q.dtype],
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.contiguous().data_ptr(), do.data_ptr(), q_positions.data_ptr(),
        k_positions.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ws.data_ptr(), b, sq, skv, hq, kh, int(causal), 1.0 / math.sqrt(d))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward saves q, k, v, its
    output and its lse; the backward is ``flash_attention_bwd`` (the kernel
    on the card, the plain version on the CPU). Positions, ``causal`` and
    the blocks get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, k_positions, causal, block_q,
                block_kv):
        o, lse = _forward(q, k, v, q_positions, k_positions, causal,
                          block_q, block_kv, True)
        ctx.save_for_backward(q, k, v, o, lse, q_positions, k_positions)
        ctx.args = (causal, block_q, block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_positions, k_positions = ctx.saved_tensors
        causal, block_q, block_kv = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, q_positions,
                                         k_positions, causal=causal,
                                         block_q=block_q, block_kv=block_kv)
        return dq, dk, dv, None, None, None, None, None

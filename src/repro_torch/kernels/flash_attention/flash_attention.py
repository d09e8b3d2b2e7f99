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
LAUNCHES = {"flash_attention": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = tuple(range(16, 129, 16))

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
_ARGTYPES = [_I, _I, _P, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _F, _P]
_lib = None


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


def blocked_attention(q, k, v, q_positions, k_positions, *, causal: bool,
                      window: int, block_q: int, block_kv: int,
                      softcap: float = 0.0):
    """Flash-style attention. q: [b, sq, hq, d]; k/v: [b, skv, kh, d];
    ``q_positions``/``k_positions``: [sq] / [skv] absolute positions (padding
    rows carry -1 keys). Scores and the running (m, l, o) statistics are
    f32; probabilities are rounded to v's dtype before the PV product, as in
    the reference."""
    b, sq, hq, d = q.shape
    kh = k.shape[2]
    g = hq // kh
    scale = 1.0 / math.sqrt(d)

    qp = pad_to(q, 1, block_q)
    qpos = pad_to(q_positions, 0, block_q)
    kp = pad_to(k, 1, block_kv)
    vp = pad_to(v, 1, block_kv)
    kpos = pad_to(k_positions, 0, block_kv, value=-1)
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_kv

    outs = []
    for iq in range(nq):
        qs = slice(iq * block_q, (iq + 1) * block_q)
        qblk = qp[:, qs].reshape(b, block_q, kh, g, d).float()
        qpb = qpos[qs]
        m = qblk.new_full((b, kh, g, block_q), NEG_INF)
        l = qblk.new_zeros((b, kh, g, block_q))
        o = qblk.new_zeros((b, kh, g, block_q, d))
        for ik in range(nk):
            ks = slice(ik * block_kv, (ik + 1) * block_kv)
            vblk = vp[:, ks]
            kpb = kpos[ks]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk,
                             kp[:, ks].float()) * scale
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
                              p.to(vblk.dtype).float(), vblk.float())
            o = o * alpha[..., None] + pv
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-37)
        # [b, kh, g, bq, d] -> [b, bq, kh*g, d]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, block_q, hq, d)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


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


def flash_attention(q, k, v, q_positions, k_positions, *, causal: bool,
                    block_q: int = 256, block_kv: int = 1024):
    """q: [b, sq, hq, d]; k/v: [b, skv, kh, d]; q_positions [sq] and
    k_positions [skv] int32 -> [b, sq, hq, d] in q's dtype. ``block_q`` and
    ``block_kv`` are the plain version's blocks (its summation order, which
    the model's config fixes); the kernel tiles by 64."""
    if q.device.type == "cpu":
        return blocked_attention(q, k, v, q_positions, k_positions,
                                 causal=causal, window=0, block_q=block_q,
                                 block_kv=block_kv)
    _check(q, k, v, q_positions, k_positions)
    b, sq, hq, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    rc = call_on_stream(
        _library().flash_attention_launch, q, _DTYPE_CODE[q.dtype], d,
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2), k.data_ptr(),
        v.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        q_positions.data_ptr(), k_positions.data_ptr(), out.data_ptr(), b, sq,
        skv, hq, kh, int(causal), 1.0 / math.sqrt(d))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["flash_attention"] += 1
    return out

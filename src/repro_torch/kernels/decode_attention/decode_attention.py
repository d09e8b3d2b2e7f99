"""Flash-decode GQA attention: CUDA kernels for Hopper, their wrappers and
their plain PyTorch versions.

Replaces the Pallas TPU kernels ``decode_attention`` and
``paged_decode_attention`` of ``src/repro/kernels/decode_attention/
decode_attention.py`` (``pl.pallas_call`` at :88 and :205). The kernels are
in ``csrc/decode_attention.cu``; its header says what bounds them on the
card and how their design answers it.

Public layouts are the reference package's, so tests compare like with like:

* ``decode_attention(q [B, Hq, D], k/v [B, Hkv, S, D], lengths [B])``.
  ``k``/``v`` may be any strided view with unit stride along D: the engine
  passes ``cache.transpose(1, 2)`` of its ``[B, S, Hkv, D]`` cache, and the
  kernel reads that layout in place (no per-step transpose or copy).
* ``paged_decode_attention(q, k/v_pages [P, page, Hkv, D], lengths [B],
  block_tables [B, PPS] int32)``.

Each wrapper takes its plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: there is no fallback. ``LAUNCHES``
counts kernel launches (one per successful launch, nowhere else), so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"decode_attention": 0, "paged_decode_attention": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_GROUP = 8       # query heads per KV head the kernel holds in registers

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
_ARGTYPES = {
    "decode_attention_launch": [_I, _I, _P, _LL, _LL, _P, _P, _LL, _LL, _LL,
                                _P, _P, _I, _I, _I, _I, _F, _P],
    "paged_decode_attention_launch": [_I, _I, _P, _LL, _LL, _P, _P, _LL, _LL,
                                      _LL, _P, _P, _I, _I, _P, _I, _I, _I,
                                      _F, _P],
}
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load
        lib = load("decode_attention")
        for fn, args in _ARGTYPES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (ports of the reference's ref.py oracles)
# ---------------------------------------------------------------------------

def decode_attention_ref(q, k, v, lengths):
    """q: [B, Hq, D]; k/v: [B, Hkv, S, D]; lengths: [B] -> [B, Hq, D].
    Masked softmax over every row, in f32."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.float().reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) / (D ** 0.5)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", w, v.float())
    return o.reshape(B, Hq, D).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, lengths, block_tables):
    """Gather each row's pages into the linear [B, Hkv, S, D] view, then the
    dense plain version above. k/v_pages: [P, page, Hkv, D];
    block_tables: [B, PPS]."""
    B = q.shape[0]
    page, Hkv, D = k_pages.shape[1], k_pages.shape[2], k_pages.shape[3]
    PPS = block_tables.shape[1]
    tbl = block_tables.long()
    k = k_pages[tbl].reshape(B, PPS * page, Hkv, D).transpose(1, 2)
    v = v_pages[tbl].reshape(B, PPS * page, Hkv, D).transpose(1, 2)
    return decode_attention_ref(q, k, v, lengths)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_common(q, k, v, lengths, B, Hkv):
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cpu or cuda tensors, "
                         f"got {q.device}")
    for name, t in (("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                         f"kernel takes one of {list(_DTYPE_CODE)} for all")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    D = q.shape[2]
    if D not in _HEAD_DIMS or k.shape[3] != D:
        raise ValueError(f"head_dim {D} (k: {k.shape[3]}): the kernel is "
                         f"built for {_HEAD_DIMS}")
    Hq = q.shape[1]
    if q.shape[0] != B or Hq % Hkv or not 1 <= Hq // Hkv <= _MAX_GROUP:
        raise ValueError(f"q {tuple(q.shape)} vs {B} rows, {Hkv} KV heads "
                         f"(group size must be 1..{_MAX_GROUP})")
    if k.stride() != v.stride():
        raise ValueError("k and v must share strides")
    vec = 16 // q.element_size()
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError("q and k/v need unit stride along head_dim")
    if any(s % vec for s in k.stride()[:-1]) \
            or any(t.data_ptr() % 16 for t in (k, v)):
        raise ValueError("k/v rows must be 16-byte aligned")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise ValueError(f"lengths must be contiguous int32 [{B}]")
    return Hq // Hkv, D


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def decode_attention(q, k, v, lengths):
    """q: [B, Hq, D]; k/v: [B, Hkv, S, D] (strided); lengths: [B] int32
    -> [B, Hq, D]. Rows at or past ``lengths[b]`` are not attended."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    B, Hkv, S = k.shape[0], k.shape[1], k.shape[2]
    g, D = _check_common(q, k, v, lengths, B, Hkv)
    out = torch.empty((B, q.shape[1], D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _library().decode_attention_launch(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), q.stride(0), q.stride(1),
            k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(2),
            k.stride(1), lengths.data_ptr(), out.data_ptr(), B, Hkv, g, S,
            1.0 / math.sqrt(D), _stream(q))
    _raise_on(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, lengths, block_tables):
    """q: [B, Hq, D]; k/v_pages: [P, page, Hkv, D]; lengths: [B] int32;
    block_tables: [B, PPS] int32 page ids -> [B, Hq, D]. Only pages whose
    start is below the row's length are read; table entries must be valid
    page ids (the engine keeps unused ones at 0, the scratch page)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, lengths,
                                          block_tables)
    B = q.shape[0]
    page, Hkv = k_pages.shape[1], k_pages.shape[2]
    g, D = _check_common(q, k_pages, v_pages, lengths, B, Hkv)
    if block_tables.device != q.device or block_tables.dtype != torch.int32 \
            or block_tables.dim() != 2 or block_tables.shape[0] != B \
            or not block_tables.is_contiguous():
        raise ValueError(f"block_tables must be contiguous int32 [{B}, PPS] "
                         f"on {q.device}")
    pps = block_tables.shape[1]
    out = torch.empty((B, q.shape[1], D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _library().paged_decode_attention_launch(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), q.stride(0), q.stride(1),
            k_pages.data_ptr(), v_pages.data_ptr(), k_pages.stride(0),
            k_pages.stride(1), k_pages.stride(2), lengths.data_ptr(),
            block_tables.data_ptr(), pps, page, out.data_ptr(), B, Hkv, g,
            1.0 / math.sqrt(D), _stream(q))
    _raise_on(rc, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out

"""Flash-decode GQA attention: CUDA kernels for Hopper, their wrappers and
their plain PyTorch versions.

Replaces the Pallas TPU kernels ``decode_attention`` and
``paged_decode_attention`` of ``src/repro/kernels/decode_attention/
decode_attention.py`` (``pl.pallas_call`` at :88 and :205). The kernels are
in ``csrc/decode_attention.cu``; its header says what bounds them on the
card and how their design answers it: split-KV flash-decode. Each block
takes one split of ``kChunk`` logical rows of one (batch row, KV head)
and writes its partial softmax state (m, l, acc) in f32 to a workspace
the wrapper allocates (sized by the library's
``decode_attention_ws_floats``); a second kernel, launched by the same C call,
reduces the splits below the row's length in split order. bf16 runs its
products on the tensor cores, f32 on the CUDA cores. Both layouts run the
same core, so the paged kernel's output is bit-identical to the dense
kernel's on the same logical cache.

Public layouts are the reference package's, so tests compare like with like:

* ``decode_attention(q [B, Hq, D], k/v [B, Hkv, S, D], lengths [B])``.
  ``k``/``v`` may be any strided view with unit stride along D: the engine
  passes ``cache.transpose(1, 2)`` of its ``[B, S, Hkv, D]`` cache, and the
  kernel reads that layout in place (no per-step transpose or copy).
* ``paged_decode_attention(q, k/v_pages [P, page, Hkv, D], lengths [B],
  block_tables [B, PPS] int32)``.

A row whose length is 0 comes out as zeros from the kernels, as from the
Pallas kernels; the plain versions (ports of the reference's ref.py
oracles) give the mean of V there. The engines never ask for length 0.

Each wrapper takes its plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernels or raises: there is no fallback. ``LAUNCHES``
counts wrapper calls that launched (one per successful call, nowhere else),
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.build import (call_on_stream, load,
                                      refuse_autograd)

NEG_INF = -1e30
#: why decode attention has no backward (refuse_autograd)
DECODE_NO_BACKWARD = ("decode steps are served, never trained (training's "
                      "forward runs flash_attention)")

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"decode_attention": 0, "paged_decode_attention": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_GROUP = 8       # query heads per KV head the kernel holds in registers

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
_SIGNATURES = {        # C function -> (return type, argument types)
    "decode_attention_launch": (_I, [_I, _I, _P, _LL, _LL, _P, _P, _LL, _LL,
                                     _LL, _P, _P, _I, _I, _I, _I, _F, _P,
                                     _LL, _P]),
    "paged_decode_attention_launch": (_I, [_I, _I, _P, _LL, _LL, _P, _P, _LL,
                                           _LL, _LL, _P, _P, _I, _I, _P, _I,
                                           _I, _I, _F, _P, _LL, _P]),
    "decode_attention_ws_floats": (_LL, [_I, _I, _I, _I, _I]),
}
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("decode_attention")
        for fn, (res, args) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
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
    """What the kernels assume of their inputs; raises ValueError if not.
    Returns (g, D). It runs on every decode step of every layer, so each
    property is read once."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode attention runs on cpu or cuda tensors, "
                         f"got {dev}")
    if k.device != dev or v.device != dev or lengths.device != dev:
        raise ValueError(f"k, v, lengths on {k.device}, {v.device}, "
                         f"{lengths.device}; q on {dev}")
    dt = q.dtype
    if dt not in _DTYPE_CODE or k.dtype != dt or v.dtype != dt:
        raise ValueError(f"q/k/v dtypes {dt}/{k.dtype}/{v.dtype}: the "
                         f"kernel takes one of {list(_DTYPE_CODE)} for all")
    qs, ks = q.shape, k.shape
    if len(qs) != 3 or len(ks) != 4 or ks != v.shape:
        raise ValueError(f"shapes q {tuple(qs)}, k {tuple(ks)}, "
                         f"v {tuple(v.shape)}")
    Hq, D = qs[1], qs[2]
    if D not in _HEAD_DIMS or ks[3] != D:
        raise ValueError(f"head_dim {D} (k: {ks[3]}): the kernel is "
                         f"built for {_HEAD_DIMS}")
    if qs[0] != B or Hq % Hkv or not 1 <= Hq // Hkv <= _MAX_GROUP:
        raise ValueError(f"q {tuple(qs)} vs {B} rows, {Hkv} KV heads "
                         f"(group size must be 1..{_MAX_GROUP})")
    kst = k.stride()
    if kst != v.stride():
        raise ValueError("k and v must share strides")
    if q.stride(2) != 1 or kst[3] != 1:
        raise ValueError("q and k/v need unit stride along head_dim")
    vec = 16 // q.element_size()
    if kst[0] % vec or kst[1] % vec or kst[2] % vec \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k/v rows must be 16-byte aligned")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise ValueError(f"lengths must be contiguous int32 [{B}]")
    return Hq // Hkv, D


@functools.lru_cache(maxsize=None)
def _ws_floats(B: int, Hkv: int, g: int, D: int, S: int) -> int:
    return _library().decode_attention_ws_floats(B, Hkv, g, D, S)


def _workspace(q, B, Hkv, g, D, S):
    """f32 scratch for the splits' partials, written by the kernel before
    it is read; its size is the library's."""
    return torch.empty(_ws_floats(B, Hkv, g, D, S), dtype=torch.float32,
                       device=q.device)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def decode_attention(q, k, v, lengths):
    """q: [B, Hq, D]; k/v: [B, Hkv, S, D] (strided); lengths: [B] int32
    -> [B, Hq, D]. Rows at or past ``lengths[b]`` are not attended."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    refuse_autograd("decode_attention", q, k, v, why=DECODE_NO_BACKWARD)
    B, Hkv, S = k.shape[0], k.shape[1], k.shape[2]
    g, D = _check_common(q, k, v, lengths, B, Hkv)
    out = torch.empty((B, q.shape[1], D), dtype=q.dtype, device=q.device)
    ws = _workspace(q, B, Hkv, g, D, S)
    rc = call_on_stream(
        _library().decode_attention_launch, q, _DTYPE_CODE[q.dtype], D,
        q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), v.data_ptr(),
        k.stride(0), k.stride(2), k.stride(1), lengths.data_ptr(),
        out.data_ptr(), B, Hkv, g, S, 1.0 / math.sqrt(D), ws.data_ptr(),
        ws.numel())
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
    refuse_autograd("paged_decode_attention", q, k_pages, v_pages,
                    why=DECODE_NO_BACKWARD)
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
    ws = _workspace(q, B, Hkv, g, D, pps * page)
    rc = call_on_stream(
        _library().paged_decode_attention_launch, q, _DTYPE_CODE[q.dtype], D,
        q.data_ptr(), q.stride(0), q.stride(1), k_pages.data_ptr(),
        v_pages.data_ptr(), k_pages.stride(0), k_pages.stride(1),
        k_pages.stride(2), lengths.data_ptr(), block_tables.data_ptr(), pps,
        page, out.data_ptr(), B, Hkv, g, 1.0 / math.sqrt(D), ws.data_ptr(),
        ws.numel())
    _raise_on(rc, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out

"""Grouped expert GEMM (+ fused SwiGLU): CUDA kernels for Hopper, their
wrappers and their plain PyTorch versions.

Replaces the Pallas TPU kernels ``moe_gemm`` and ``moe_ffn_fused`` of
``src/repro/kernels/moe_gemm/moe_gemm.py`` (``pl.pallas_call`` at :65 and
:90). The kernels are in ``csrc/moe_gemm.cu``; its header says what bounds
them on the card and how their design answers it.

Layouts are the reference's: ``x [E, C, D]``, ``w / w_gate / w_up
[E, D, F]`` -> ``[E, C, F]`` in x's dtype, products accumulated in f32.
Two callers: the MoE expert FFN (``repro_torch.models.moe``, bf16 capacity
buffers) and the adapter runtime's grouped route
(``repro_torch.adapters.runtime``, f32 LoRA tables).

Each wrapper takes its plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: there is no fallback. ``LAUNCHES``
counts kernel launches (one per successful launch, nowhere else).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"moe_gemm": 0, "moe_ffn_fused": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_VEC = 8             # weight elements per 16-byte load segment

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "moe_gemm_launch": [_I, _P, _LL, _LL, _P, _LL, _LL, _P, _I, _I, _I, _I,
                        _I, _P],
    "moe_ffn_fused_launch": [_I, _P, _LL, _LL, _P, _P, _LL, _LL, _P, _I, _I,
                             _I, _I, _I, _P],
}
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load
        lib = load("moe_gemm")
        for fn, args in _ARGTYPES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (ports of the reference's ref.py oracles)
# ---------------------------------------------------------------------------

def moe_gemm_ref(x, w):
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] in x's dtype, f32 products."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def moe_ffn_fused_ref(x, w_gate, w_up):
    """silu(x @ w_gate) * (x @ w_up) in f32, cast once to x's dtype."""
    gate = torch.einsum("ecd,edf->ecf", x.float(), w_gate.float())
    up = torch.einsum("ecd,edf->ecf", x.float(), w_up.float())
    return (F.silu(gate) * up).to(x.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(x, ws):
    if x.device.type != "cuda":
        raise ValueError(f"grouped GEMM runs on cpu or cuda tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE or any(w.dtype != x.dtype for w in ws):
        raise ValueError(f"dtypes x {x.dtype}, w {[w.dtype for w in ws]}: "
                         f"the kernel takes one of {list(_DTYPE_CODE)} for "
                         f"all")
    if any(w.device != x.device for w in ws):
        raise ValueError(f"weights on {[str(w.device) for w in ws]}, x on "
                         f"{x.device}")
    if x.dim() != 3 or any(w.dim() != 3 for w in ws):
        raise ValueError(f"x {tuple(x.shape)} and w "
                         f"{[tuple(w.shape) for w in ws]} must be 3-d")
    E, C, D = x.shape
    if any(w.shape[:2] != (E, D) for w in ws) \
            or any(w.shape != ws[0].shape for w in ws):
        raise ValueError(f"x {tuple(x.shape)} vs w "
                         f"{[tuple(w.shape) for w in ws]}: need [E, D, F]")
    if any(w.stride() != ws[0].stride() for w in ws):
        raise ValueError("w_gate and w_up must share strides")
    if x.stride(2) != 1 or ws[0].stride(2) != 1:
        raise ValueError("x needs unit stride along D and w along F")
    if not 1 <= E <= 65535 or min(C, D, ws[0].shape[2]) < 1:
        raise ValueError(f"E {E}, C {C}, D {D}, F {ws[0].shape[2]}: need "
                         f"1 <= E <= 65535 and C, D, F >= 1")
    vec_ok = all(w.data_ptr() % 16 == 0 for w in ws) \
        and ws[0].stride(0) % _VEC == 0 and ws[0].stride(1) % _VEC == 0
    return E, C, D, ws[0].shape[2], int(vec_ok)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def moe_gemm(x, w):
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] in x's dtype."""
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    E, C, D, Fo, vec_ok = _check(x, (w,))
    y = torch.empty((E, C, Fo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().moe_gemm_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0), x.stride(1),
            w.data_ptr(), w.stride(0), w.stride(1), y.data_ptr(), E, C, D, Fo,
            vec_ok, _stream(x))
    _raise_on(rc, "moe_gemm")
    LAUNCHES["moe_gemm"] += 1
    return y


def moe_ffn_fused(x, w_gate, w_up):
    """silu(x @ w_gate) * (x @ w_up): x [E, C, D]; w_* [E, D, F] ->
    [E, C, F] in x's dtype."""
    if x.device.type == "cpu":
        return moe_ffn_fused_ref(x, w_gate, w_up)
    E, C, D, Fo, vec_ok = _check(x, (w_gate, w_up))
    y = torch.empty((E, C, Fo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().moe_ffn_fused_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0), x.stride(1),
            w_gate.data_ptr(), w_up.data_ptr(), w_gate.stride(0),
            w_gate.stride(1), y.data_ptr(), E, C, D, Fo, vec_ok, _stream(x))
    _raise_on(rc, "moe_ffn_fused")
    LAUNCHES["moe_ffn_fused"] += 1
    return y

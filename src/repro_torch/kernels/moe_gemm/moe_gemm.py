"""Grouped expert GEMM (+ fused SwiGLU): CUDA kernels for Hopper, their
wrappers and their plain PyTorch versions.

Replaces the Pallas TPU kernels ``moe_gemm`` and ``moe_ffn_fused`` of
``src/repro/kernels/moe_gemm/moe_gemm.py`` (``pl.pallas_call`` at :65 and
:90). The kernels are in ``csrc/moe_gemm.cu``, in two variants: a
tensor-core one (``mma.sync`` on bf16 tiles fed by a ``cp.async`` ring) for
the shapes ``uses_tensor_cores`` admits, and a CUDA-core template for f32
and every other bf16 shape. Its header says what bounds them on the card
and how each design answers it.

Layouts are the reference's: ``x [E, C, D]``, ``w / w_gate / w_up
[E, D, F]`` -> ``[E, C, F]`` in x's dtype, products accumulated in f32.
Two callers: the MoE expert FFN (``repro_torch.models.moe``, bf16 capacity
buffers) and the adapter runtime's grouped route
(``repro_torch.adapters.runtime``, f32 LoRA tables).

Each wrapper takes its plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: there is no fallback. ``LAUNCHES``
counts kernel launches (one per successful launch of either variant,
nowhere else); ``TENSOR_CORE_LAUNCHES`` counts those of them that took the
tensor-core variant.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"moe_gemm": 0, "moe_ffn_fused": 0}
#: kernel name -> launches of the tensor-core variant among LAUNCHES
TENSOR_CORE_LAUNCHES = {"moe_gemm": 0, "moe_ffn_fused": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_VEC = 8             # weight elements per 16-byte load segment

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "moe_gemm_launch": [_I, _P, _LL, _LL, _P, _LL, _LL, _P, _I, _I, _I, _I,
                        _I, _P],
    "moe_ffn_fused_launch": [_I, _P, _LL, _LL, _P, _P, _LL, _LL, _P, _I, _I,
                             _I, _I, _I, _P],
    "moe_gemm_tc_launch": [_P, _LL, _LL, _P, _LL, _LL, _P, _I, _I, _I, _I,
                           _P],
    "moe_ffn_fused_tc_launch": [_P, _LL, _LL, _P, _P, _LL, _LL, _P, _I, _I,
                                _I, _I, _P],
}
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = TENSOR_CORE_LAUNCHES[k] = 0


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


def uses_tensor_cores(x, *ws) -> bool:
    """Whether a launch on ``x [E, C, D]`` and ``ws [E, D, F]`` takes the
    tensor-core variant: bf16 throughout; D and F multiples of 8; unit
    inner strides; the outer strides of x and w multiples of 8 elements and
    every base 16-byte aligned, so each row of a tile is whole 16-byte
    copies. Every other shape runs the CUDA-core template."""
    if x.dtype != torch.bfloat16 or any(w.dtype != x.dtype for w in ws):
        return False
    D, Fo = x.shape[2], ws[0].shape[2]
    strides = (x.stride(0), x.stride(1)) + tuple(
        s for w in ws for s in (w.stride(0), w.stride(1)))
    return (D % _VEC == 0 and Fo % _VEC == 0
            and x.stride(2) == 1 and all(w.stride(2) == 1 for w in ws)
            and all(s % _VEC == 0 for s in strides)
            and all(t.data_ptr() % 16 == 0 for t in (x, *ws)))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def _launch(name, x, ws):
    """Check, allocate y, launch the variant the rule picks, count it."""
    E, C, D, Fo, vec_ok = _check(x, ws)
    y = torch.empty((E, C, Fo), dtype=x.dtype, device=x.device)
    tc = uses_tensor_cores(x, *ws)
    w = ws[0]
    ptrs = [t.data_ptr() for t in ws]
    lib = _library()
    with torch.cuda.device(x.device):
        if tc:
            rc = getattr(lib, f"{name}_tc_launch")(
                x.data_ptr(), x.stride(0), x.stride(1), *ptrs, w.stride(0),
                w.stride(1), y.data_ptr(), E, C, D, Fo, _stream(x))
        else:
            rc = getattr(lib, f"{name}_launch")(
                _DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0), x.stride(1),
                *ptrs, w.stride(0), w.stride(1), y.data_ptr(), E, C, D, Fo,
                vec_ok, _stream(x))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    TENSOR_CORE_LAUNCHES[name] += tc
    return y


def moe_gemm(x, w):
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] in x's dtype."""
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    return _launch("moe_gemm", x, (w,))


def moe_ffn_fused(x, w_gate, w_up):
    """silu(x @ w_gate) * (x @ w_up): x [E, C, D]; w_* [E, D, F] ->
    [E, C, F] in x's dtype."""
    if x.device.type == "cpu":
        return moe_ffn_fused_ref(x, w_gate, w_up)
    return _launch("moe_ffn_fused", x, (w_gate, w_up))

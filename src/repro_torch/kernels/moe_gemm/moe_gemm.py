"""Grouped expert GEMM (+ fused SwiGLU): CUDA kernels for Hopper, their
wrappers and their plain PyTorch versions.

Replaces the Pallas TPU kernels ``moe_gemm`` and ``moe_ffn_fused`` of
``src/repro/kernels/moe_gemm/moe_gemm.py`` (``pl.pallas_call`` at :65 and
:90). The kernels are in ``csrc/moe_gemm.cu``, in three variants: a
tensor-core one (``mma.sync`` on bf16 tiles fed by a ``cp.async`` ring) for
the shapes ``uses_tensor_cores`` admits, a narrow one for the f32
``moe_gemm`` products whose D or F is rank-sized (``uses_narrow``: split-D
warps and a combine, or one pass over a rank-deep panel), and a CUDA-core
template for every other shape; and beside the tensor-core variant an
int8-weight one (``uses_int8``): ``wgmma`` on int8 tiles that a producer
warp loads by TMA, dequantised by the consumers with their f32 scales.
Its header says what bounds them on the card and how each design answers
it.

Layouts are the reference's: ``x [E, C, D]``, ``w / w_gate / w_up
[E, D, F]`` -> ``[E, C, F]`` in x's dtype, products accumulated in f32. A
weight may also be int8 ``{"q": [E, D, F], "s": [E, 1, F] f32}`` (as
``models.quant`` makes it): the function is then the one on
``as_weight(w)``.
Two callers: the MoE expert FFN (``repro_torch.models.moe``, bf16 capacity
buffers) and the adapter runtime's grouped route
(``repro_torch.adapters.runtime``, f32 LoRA tables).

Each wrapper takes its plain version only for tensors on the CPU (for an
int8 weight: ``as_weight``, then the plain version). On fake tensors (the
dry run's ``FakeTensorMode``: shapes, no data) it allocates its outputs and
reports the kernel's work (``kernels.sharded.report_work``), as the
attention wrappers do. For a CUDA tensor it
launches the kernel or raises: there is no fallback, and an int8 weight
that the int8 variant does not take raises rather than being dequantised
for another route. ``LAUNCHES`` counts kernel launches (one per
successful wrapper call, whatever the variant, nowhere else);
``TENSOR_CORE_LAUNCHES``, ``NARROW_LAUNCHES`` and ``INT8_LAUNCHES`` count
those of them that took the tensor-core, the narrow or the int8 variant.

The backward: while autograd records, ``moe_gemm`` and ``moe_ffn_fused``
on tensor weights go through the ``torch.autograd.Function``s
``MoEGemm`` and ``MoEFFNFused``, whose backward runs three kernels of the
same source (on the CPU their plain versions): ``moe_ffn_fused_bwd`` (K1:
gate and up recomputed in the forward's k order, their SwiGLU backward
against dout gives dg and du), ``moe_gemm_dx`` (K2: ``sum_j dy_j @
w_j^T``) and ``moe_gemm_dw`` (K3: ``a^T @ dy_j``, reduced over C), each
with a bf16 route on the tensor cores (``wgmma`` fed by TMA, outputs
stored by TMA) and a CUDA-core one for f32 and every other shape. Under
``no_grad`` (serving) nothing changes. Int8 weights (served, never
trained) and the narrow variant (adapters are not trained) still refuse
autograd on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import sharded as SH
from repro_torch.kernels.build import (call_on_stream, load,
                                      refuse_autograd)

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"moe_gemm": 0, "moe_ffn_fused": 0, "moe_ffn_fused_bwd": 0,
            "moe_gemm_dx": 0, "moe_gemm_dw": 0}
#: the backward kernels' launches of the tensor-core route among LAUNCHES
BWD_TENSOR_CORE_LAUNCHES = {"moe_ffn_fused_bwd": 0, "moe_gemm_dx": 0,
                            "moe_gemm_dw": 0}
#: kernel name -> launches of the tensor-core variant among LAUNCHES
TENSOR_CORE_LAUNCHES = {"moe_gemm": 0, "moe_ffn_fused": 0}
#: kernel name -> launches of the narrow variant among LAUNCHES (only
#: moe_gemm has one)
NARROW_LAUNCHES = {"moe_gemm": 0, "moe_ffn_fused": 0}
#: kernel name -> launches of the int8-weight variant among LAUNCHES
INT8_LAUNCHES = {"moe_gemm": 0, "moe_ffn_fused": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_VEC = 8             # weight elements per 16-byte load segment
_Q_UNIT = 16         # int8 elements per 16-byte TMA stride unit
NARROW = 16          # the largest rank-sized D or F of the narrow variant

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
    "moe_gemm_narrow_launch": [_P, _LL, _LL, _P, _LL, _LL, _P, _P, _I, _I,
                               _I, _I, _P],
    "moe_gemm_i8_launch": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _P, _I, _I,
                           _I, _I, _P],
    "moe_ffn_fused_i8_launch": [_P, _LL, _LL, _P, _P, _LL, _LL, _P, _P, _LL,
                                _P, _I, _I, _I, _I, _P],
    "moe_gemm_i8_probe": [_P, _P, _P, _I, _P],
    "moe_ffn_fused_bwd_launch": [_I, _I, _P, _LL, _LL, _P, _P, _LL, _LL, _P,
                                 _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "moe_gemm_dx_launch": [_I, _I, _I, _P, _P, _LL, _LL, _P, _P, _LL, _LL,
                           _P, _I, _I, _I, _I, _P],
    "moe_gemm_dw_launch": [_I, _I, _I, _P, _LL, _LL, _P, _P, _LL, _LL, _P, _P,
                           _I, _I, _I, _I, _P],
}
_lib = None


def reset_launches() -> None:
    for counts in (LAUNCHES, TENSOR_CORE_LAUNCHES, NARROW_LAUNCHES,
                   INT8_LAUNCHES, BWD_TENSOR_CORE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("moe_gemm")
        for fn, args in _ARGTYPES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.moe_gemm_narrow_ws_floats.argtypes = [_I, _I, _I, _I]
        lib.moe_gemm_narrow_ws_floats.restype = _LL
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (ports of the reference's ref.py oracles)
# ---------------------------------------------------------------------------

def _is_int8(w) -> bool:
    return isinstance(w, dict) and set(w) == {"q", "s"}


def _plain_shape(w):
    """The shape of a weight, a tensor or int8 ``{q, s}``."""
    return tuple((w["q"] if _is_int8(w) else w).shape)


def _plain(w):
    """A weight as the plain versions take it: an int8 ``{q, s}`` through
    ``models.quant.as_weight`` (imported here: the models package imports
    this module)."""
    if _is_int8(w):
        from repro_torch.models.quant import as_weight
        return as_weight(w)
    return w


def _acc(t):
    """t in its accumulation dtype: f32 for bf16 and f32, f64 for f64 (the
    gradchecks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def moe_gemm_ref(x, w):
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] in x's dtype, f32 products."""
    return torch.einsum("ecd,edf->ecf", _acc(x), _acc(w)).to(x.dtype)


def moe_ffn_fused_ref(x, w_gate, w_up):
    """silu(x @ w_gate) * (x @ w_up) in f32, cast once to x's dtype."""
    gate = torch.einsum("ecd,edf->ecf", _acc(x), _acc(w_gate))
    up = torch.einsum("ecd,edf->ecf", _acc(x), _acc(w_up))
    return (F.silu(gate) * up).to(x.dtype)


# The backward's plain versions. They round where the reference's
# ``jax.vjp`` of ``_expert_ffn`` rounds (its jaxpr in bf16): a product's
# cotangent enters each transposed einsum in f32 against the bf16 operand,
# the einsum accumulates in f32 and casts once to the operand's dtype
# (dx, dw); the two dx terms of gate and up are each cast, then added
# (``add_any`` of two bf16 values: in f32, cast again). One cast more than
# the reference: dg and du, f32 there, are cast to x's dtype, because the
# kernels' tensor cores take bf16 operands (a no-op in f32).

def swiglu_bwd(g, u, dout):
    """(dg, du) in f32 from g = x @ w_gate, u = x @ w_up (f32) and the
    output's gradient, in the order of the reference's jaxpr:
    ``s = sigmoid(g)``, ``w = dout * u``; ``dg = w * s + (g * w) * (s * (1
    - s))``; ``du = (g * s) * dout``."""
    d = _acc(dout)
    s = torch.sigmoid(g)
    w = d * u
    return w * s + (g * w) * (s * (1 - s)), (g * s) * d


def moe_ffn_fused_bwd_ref(x, w_gate, w_up, dout):
    """(dg, du) [E, C, F] in x's dtype: gate and up recomputed in f32 from
    x, then ``swiglu_bwd``."""
    g = torch.einsum("ecd,edf->ecf", _acc(x), _acc(w_gate))
    u = torch.einsum("ecd,edf->ecf", _acc(x), _acc(w_up))
    dg, du = swiglu_bwd(g, u, dout)
    return dg.to(x.dtype), du.to(x.dtype)


def moe_gemm_dx_ref(dys, ws):
    """sum_j dy_j [E, C, F] @ w_j [E, D, F]^T -> [E, C, D] in dy's dtype:
    each term in f32 cast once, the terms added in f32 and cast again."""
    out = None
    for dy, w in zip(dys, ws):
        term = torch.einsum("ecf,edf->ecd", _acc(dy), _acc(w)).to(dy.dtype)
        out = term if out is None else (_acc(out) + _acc(term)).to(dy.dtype)
    return out


def moe_gemm_dw_ref(a, dys):
    """[a [E, C, D]^T @ dy_j [E, C, F] -> [E, D, F] in a's dtype, f32
    products, for each dy_j]."""
    return [torch.einsum("ecd,ecf->edf", _acc(a), _acc(dy)).to(a.dtype)
            for dy in dys]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(x, ws, wdtype=None):
    """Shapes, strides, devices and dtypes (weights in x's dtype, or
    ``wdtype``) of a launch; returns (E, C, D, F, vec_ok)."""
    dev, dt = x.device, x.dtype
    wdt = dt if wdtype is None else wdtype
    if dev.type != "cuda":
        raise ValueError(f"grouped GEMM runs on cpu or cuda tensors, got "
                         f"{dev}")
    w0 = ws[0]
    shape, stride = w0.shape, w0.stride()
    if dt not in _DTYPE_CODE or any(w.dtype != wdt for w in ws):
        raise ValueError(f"dtypes x {dt}, w {[w.dtype for w in ws]}: "
                         f"the kernel takes one of {list(_DTYPE_CODE)} for "
                         f"all, or int8 weights for bf16 x")
    if any(w.device != dev for w in ws):
        raise ValueError(f"weights on {[str(w.device) for w in ws]}, x on "
                         f"{dev}")
    if x.dim() != 3 or len(shape) != 3:
        raise ValueError(f"x {tuple(x.shape)} and w "
                         f"{[tuple(w.shape) for w in ws]} must be 3-d")
    E, C, D = x.shape
    if shape[0] != E or shape[1] != D \
            or any(w.shape != shape for w in ws[1:]):
        raise ValueError(f"x {tuple(x.shape)} vs w "
                         f"{[tuple(w.shape) for w in ws]}: need [E, D, F]")
    if any(w.stride() != stride for w in ws[1:]):
        raise ValueError("w_gate and w_up must share strides")
    if x.stride(2) != 1 or stride[2] != 1:
        raise ValueError("x needs unit stride along D and w along F")
    Fo = shape[2]
    if not 1 <= E <= 65535 or min(C, D, Fo) < 1:
        raise ValueError(f"E {E}, C {C}, D {D}, F {Fo}: need "
                         f"1 <= E <= 65535 and C, D, F >= 1")
    vec_ok = stride[0] % _VEC == 0 and stride[1] % _VEC == 0 \
        and all(w.data_ptr() % 16 == 0 for w in ws)
    return E, C, D, Fo, int(vec_ok)


def uses_tensor_cores(x, *ws) -> bool:
    """Whether a launch on ``x [E, C, D]`` and ``ws [E, D, F]`` takes the
    tensor-core variant: bf16 throughout; D and F multiples of 8; unit
    inner strides; the outer strides of x and w multiples of 8 elements and
    every base 16-byte aligned, so each row of a tile is whole 16-byte
    copies. Every other shape runs the CUDA-core template."""
    if x.dtype != torch.bfloat16 or any(w.dtype != x.dtype for w in ws):
        return False
    return _tile_layout(x, ws)


def uses_int8(x, *ws) -> bool:
    """Whether a launch on ``x [E, C, D]`` and int8 weights ``ws`` (each
    ``{"q": [E, D, F], "s": [E, 1, F]}``) takes the int8-weight variant:
    bf16 x, int8 q, f32 s with unit stride along F; the tensor-core rules
    on the layout of x and q, and F and q's outer strides multiples of 16
    (TMA copies the int8 tiles, and its global strides are whole 16-byte
    units; past D and F it fills zeros)."""
    if x.dtype != torch.bfloat16 or not all(_is_int8(w) for w in ws):
        return False
    qs = [w["q"] for w in ws]
    E, Fo = x.shape[0], qs[0].shape[2]
    return (all(q.dtype == torch.int8 for q in qs)
            and all(w["s"].dtype == torch.float32
                    and tuple(w["s"].shape) == (E, 1, Fo)
                    and w["s"].stride(2) == 1 and w["s"].device == x.device
                    and w["s"].stride(0) == ws[0]["s"].stride(0) >= Fo
                    for w in ws)
            and _tile_layout(x, qs)
            and Fo % _Q_UNIT == 0
            and all(q.stride(0) % _Q_UNIT == 0 and q.stride(1) % _Q_UNIT == 0
                    for q in qs))


def _tile_layout(x, ws) -> bool:
    """The tensor-core variants' layout rule (any dtypes)."""
    D, Fo = x.shape[2], ws[0].shape[2]
    strides = (x.stride(0), x.stride(1)) + tuple(
        s for w in ws for s in (w.stride(0), w.stride(1)))
    return (D % _VEC == 0 and Fo % _VEC == 0
            and x.stride(2) == 1 and all(w.stride(2) == 1 for w in ws)
            and all(s % _VEC == 0 for s in strides)
            and all(t.data_ptr() % 16 == 0 for t in (x, *ws)))


def uses_narrow(x, w) -> bool:
    """Whether ``moe_gemm(x [E, C, D], w [E, D, F])`` takes the narrow
    variant: f32 throughout; D or F at most ``NARROW`` (a LoRA rank), both
    multiples of 4; unit inner strides, the outer strides of x and w
    multiples of 4 elements and both bases 16-byte aligned, so every row is
    whole 16-byte loads. ``moe_ffn_fused`` has no narrow variant."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        return False
    D, Fo = x.shape[2], w.shape[2]
    xs, wst = x.stride(), w.stride()
    return (min(D, Fo) <= NARROW and D % 4 == 0 and Fo % 4 == 0
            and xs[2] == 1 and wst[2] == 1
            and xs[0] % 4 == 0 and xs[1] % 4 == 0
            and wst[0] % 4 == 0 and wst[1] % 4 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def _narrow_ws_floats(E: int, C: int, D: int, F: int) -> int:
    return _library().moe_gemm_narrow_ws_floats(E, C, D, F)


def _launch_narrow(x, w, E, C, D, Fo):
    """The narrow variant: y, and for split D the workspace of the
    splits' partials."""
    y = torch.empty((E, C, Fo), dtype=torch.float32, device=x.device)
    n_ws = _narrow_ws_floats(E, C, D, Fo)
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device) \
        if n_ws else y
    rc = call_on_stream(
        _library().moe_gemm_narrow_launch, x, x.data_ptr(), x.stride(0),
        x.stride(1), w.data_ptr(), w.stride(0), w.stride(1), y.data_ptr(),
        ws.data_ptr(), E, C, D, Fo)
    _raise_on(rc, "moe_gemm")
    LAUNCHES["moe_gemm"] += 1
    NARROW_LAUNCHES["moe_gemm"] += 1
    return y


def _launch_int8(name, x, ws):
    """The int8-weight variant on ``{q, s}`` weights, or raise."""
    qs = [w["q"] for w in ws]
    E, C, D, Fo, _ = _check(x, qs, torch.int8)
    if not uses_int8(x, *ws):
        raise ValueError(
            f"{name}: int8 weights on {x.device} need bf16 x, q int8 and s "
            f"f32 [E, 1, F], D and x's strides multiples of 8, F and q's "
            f"strides multiples of 16, 16-byte bases; got x {x.dtype} "
            f"{tuple(x.shape)}, q {[tuple(q.shape) for q in qs]} strides "
            f"{[q.stride() for q in qs]}")
    y = torch.empty((E, C, Fo), dtype=x.dtype, device=x.device)
    ss = [w["s"] for w in ws]
    rc = call_on_stream(
        getattr(_library(), f"{name}_i8_launch"), x, x.data_ptr(),
        x.stride(0), x.stride(1), *[q.data_ptr() for q in qs],
        qs[0].stride(0), qs[0].stride(1), *[t.data_ptr() for t in ss],
        ss[0].stride(0), y.data_ptr(), E, C, D, Fo)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    INT8_LAUNCHES[name] += 1
    return y


#: the ways of the bit probe after way 0 (mma.sync.m16n8k16, the mma.sync
#: kernels' instruction, over 256 columns): (what, the columns it writes)
PROBE_WAYS = (("wgmma m64n8k16, A in registers (the int8 variant)", 8),
              ("wgmma m64n8k16, A MN-major in shared memory", 8),
              ("wgmma m64n64k16, A MN-major", 64),
              ("wgmma m64n160k16, A and B K-major (K2)", 160),
              ("wgmma m64n128k16, A and B MN-major (K3, two outputs)", 128),
              ("wgmma m64n256k16, A and B MN-major (K3, one output)", 256),
              ("wgmma m64n160k16, A MN-major, B K-major (K1)", 160))


def i8_probe(a, b):
    """The bit probe of the wgmma kernels' instructions: one chain of k16
    products in increasing k over ``a [steps, 64, 16]`` (rows m, columns
    k) and ``b [steps, 256, 16]`` (rows n), bf16 on the card, computed as
    ``mma.sync.m16n8k16`` (way 0, every column) and in each of
    ``PROBE_WAYS`` (its first N columns). Returns [8, 64, 256] f32, NaN
    where a way writes nothing."""
    if a.device.type != "cuda" or a.dtype != torch.bfloat16 \
            or b.dtype != torch.bfloat16 or a.shape[1:] != (64, 16) \
            or b.shape != (a.shape[0], 256, 16):
        raise ValueError("i8_probe takes bf16 a [steps, 64, 16] and b "
                         "[steps, 256, 16] on the card")
    a, b = a.contiguous(), b.contiguous()
    out = torch.full((1 + len(PROBE_WAYS), 64, 256), float("nan"),
                     device=a.device)
    _raise_on(call_on_stream(_library().moe_gemm_i8_probe, a, a.data_ptr(),
                             b.data_ptr(), out.data_ptr(), a.shape[0]),
              "i8_probe")
    return out


def probe_differ(out) -> list:
    """For each of ``PROBE_WAYS``, how many of its 64 x N outputs differ
    from way 0's (``mma.sync``) bits in ``i8_probe``'s result."""
    return [int((out[0, :, :n] != out[1 + i, :, :n]).sum())
            for i, (_, n) in enumerate(PROBE_WAYS)]


#: what keeps each route without a backward
INT8_NO_BACKWARD = ("int8 weights are served, never trained (ROADMAP.md "
                    "queue 1 item 4(a) gave the bf16 and f32 routes one)")
NARROW_NO_BACKWARD = ("the narrow variant's adapter products are not "
                      "trained (ROADMAP.md queue 1 item 4(a) gave the bf16 "
                      "and f32 routes one)")


def _launch(name, x, ws):
    """Check, allocate y, launch the variant the rules pick, count it."""
    refuse_autograd(name, x, *ws, why=INT8_NO_BACKWARD)
    if any(_is_int8(w) for w in ws):
        return _launch_int8(name, x, ws)
    E, C, D, Fo, vec_ok = _check(x, ws)
    if name == "moe_gemm" and uses_narrow(x, ws[0]):
        return _launch_narrow(x, ws[0], E, C, D, Fo)
    y = torch.empty((E, C, Fo), dtype=x.dtype, device=x.device)
    tc = uses_tensor_cores(x, *ws)
    w = ws[0]
    ptrs = [t.data_ptr() for t in ws]
    lib = _library()
    if tc:
        rc = call_on_stream(
            getattr(lib, f"{name}_tc_launch"), x, x.data_ptr(), x.stride(0),
            x.stride(1), *ptrs, w.stride(0), w.stride(1), y.data_ptr(), E, C,
            D, Fo)
    else:
        rc = call_on_stream(
            getattr(lib, f"{name}_launch"), x, _DTYPE_CODE[x.dtype],
            x.data_ptr(), x.stride(0), x.stride(1), *ptrs, w.stride(0),
            w.stride(1), y.data_ptr(), E, C, D, Fo, vec_ok)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    TENSOR_CORE_LAUNCHES[name] += tc
    return y


def _nbytes(*ts) -> int:
    """Bytes of tensors and int8 ``{q, s}`` weights."""
    return sum(_nbytes(*t.values()) if _is_int8(t) else t.nbytes
               for t in ts)


def _fake(name, x, ws, F_out: int, flops: float, extra=()):
    """The dry run's stand-in for a launch on fake tensors (shapes, no
    data): an empty [E, C, F_out] output in x's dtype, and the kernel's
    work reported (``kernels.sharded.report_work``): ``flops``, and the
    bytes of x, the weights, ``extra`` and the output, each moved once."""
    E, C, _ = x.shape
    y = x.new_empty((E, C, F_out))
    SH.report_work(name, flops, _nbytes(x, *ws, *extra, y))
    return y


def _forward_gemm(x, w):
    if SH.is_fake(x):
        E, C, D = x.shape
        Fo = _plain_shape(w)[2]
        return _fake("moe_gemm", x, (w,), Fo, 2.0 * E * C * D * Fo)
    if x.device.type == "cpu":
        return moe_gemm_ref(x, _plain(w))
    return _launch("moe_gemm", x, (w,))


def _forward_ffn(x, w_gate, w_up):
    if SH.is_fake(x):
        E, C, D = x.shape
        Fo = _plain_shape(w_gate)[2]
        return _fake("moe_ffn_fused", x, (w_gate, w_up), Fo,
                     4.0 * E * C * D * Fo)
    if x.device.type == "cpu":
        return moe_ffn_fused_ref(x, _plain(w_gate), _plain(w_up))
    return _launch("moe_ffn_fused", x, (w_gate, w_up))


def _records(x, *ws) -> bool:
    """Whether autograd records a call on tensor weights: it then goes
    through the Functions (int8 weights take the forward, which refuses
    on the card)."""
    return (torch.is_grad_enabled() and not any(_is_int8(w) for w in ws)
            and any(t.requires_grad for t in (x, *ws)))


def moe_gemm(x, w):
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] in x's dtype; w a tensor or
    int8 ``{q, s}``. Differentiable in x and a tensor w (``MoEGemm``)."""
    if _records(x, w):
        if x.device.type == "cuda" and uses_narrow(x, w):
            refuse_autograd("moe_gemm", x, w, why=NARROW_NO_BACKWARD)
        return MoEGemm.apply(x, w)
    return _forward_gemm(x, w)


def moe_ffn_fused(x, w_gate, w_up):
    """silu(x @ w_gate) * (x @ w_up): x [E, C, D]; w_* [E, D, F] (tensors
    or int8 ``{q, s}``) -> [E, C, F] in x's dtype. Differentiable in x and
    tensor weights (``MoEFFNFused``)."""
    if _records(x, w_gate, w_up):
        return MoEFFNFused.apply(x, w_gate, w_up)
    return _forward_ffn(x, w_gate, w_up)


# ---------------------------------------------------------------------------
# the backward: K1-K3 and the autograd Functions
# ---------------------------------------------------------------------------

def _dense(t):
    """t contiguous with a 16-byte-aligned base (a copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _count(name: str, rc: int, tc: bool) -> None:
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    BWD_TENSOR_CORE_LAUNCHES[name] += tc


def moe_ffn_fused_bwd(x, w_gate, w_up, dout, y=None):
    """(dg, du) [E, C, F] in x's dtype from x [E, C, D], w_gate, w_up
    [E, D, F] and dout [E, C, F], the gradient of ``moe_ffn_fused``'s
    output: the plain version on the CPU, else K1 (gate and up recomputed
    in the forward's k order, bit for bit its accumulators, then
    ``swiglu_bwd`` against dout; on the tensor-core route ``wgmma`` fed by
    TMA with dout's tile prefetched under the products, dg and du stored
    by TMA). ``y`` (on the card, [E, C, F] in x's dtype) also receives the
    forward's output from those accumulators: a check of the recompute."""
    if SH.is_fake(x):
        E, C, D = x.shape
        Fo = w_gate.shape[2]
        du = x.new_empty((E, C, Fo))
        dg = _fake("moe_ffn_fused_bwd", x, (w_gate, w_up), Fo,
                   4.0 * E * C * D * Fo, (dout, du))
        return dg, du
    if x.device.type == "cpu":
        return moe_ffn_fused_bwd_ref(x, w_gate, w_up, dout)
    E, C, D, Fo, vec_ok = _check(x, (w_gate, w_up))
    dout = _dense(dout)
    if dout.shape != (E, C, Fo) or dout.dtype != x.dtype \
            or dout.device != x.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype}: need "
                         f"[{E}, {C}, {Fo}] {x.dtype} on {x.device}")
    if y is not None and (y.shape != dout.shape or y.dtype != x.dtype
                          or not y.is_contiguous()):
        raise ValueError("y must be a contiguous [E, C, F] tensor in x's "
                         "dtype")
    dg, du = torch.empty_like(dout), torch.empty_like(dout)
    tc = uses_tensor_cores(x, w_gate, w_up) and (
        y is None or y.data_ptr() % 16 == 0)
    rc = call_on_stream(
        _library().moe_ffn_fused_bwd_launch, x, _DTYPE_CODE[x.dtype],
        int(tc), x.data_ptr(), x.stride(0), x.stride(1), w_gate.data_ptr(),
        w_up.data_ptr(), w_gate.stride(0), w_gate.stride(1),
        dout.data_ptr(), dg.data_ptr(), du.data_ptr(),
        0 if y is None else y.data_ptr(), E, C, D, Fo, vec_ok)
    _count("moe_ffn_fused_bwd", rc, tc)
    return dg, du


def _bwd_tiles(D: int, Fo: int, *ts) -> bool:
    """The backward's tensor-core rule: bf16; D and F multiples of 8; the
    outer strides of every operand multiples of 8 elements and every base
    16-byte aligned (the unit inner strides are the callers')."""
    return (all(t.dtype == torch.bfloat16 for t in ts)
            and D % _VEC == 0 and Fo % _VEC == 0
            and all(s % _VEC == 0 for t in ts for s in t.stride()[:2])
            and all(t.data_ptr() % 16 == 0 for t in ts))


def _operands(name, dys, others, shapes):
    """One or two dy_j made contiguous and aligned, checked with the other
    operands against their shapes, one dtype (bf16 or f32) and one card."""
    if len(dys) not in (1, 2):
        raise ValueError(f"{name}: one or two dy, got {len(dys)}")
    dys = [_dense(dy) for dy in dys]
    dt, dev = dys[0].dtype, dys[0].device
    for t, shape in zip(dys + others, shapes):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, need {shape} {dt} on {dev}")
    if dt not in _DTYPE_CODE or dev.type != "cuda":
        raise ValueError(f"{name}: bf16 or f32 on the card, got {dt} on "
                         f"{dev}")
    return dys


def moe_gemm_dx(dys, ws):
    """K2: ``sum_j dy_j @ w_j^T`` -> dx [E, C, D] in dy's dtype, for one
    or two pairs (dy_j [E, C, F], w_j [E, D, F] sharing strides, unit
    stride along F); each term accumulated in f32 and cast, the two added
    in f32 and cast again. The plain version on the CPU."""
    dys, ws = list(dys), list(ws)
    if SH.is_fake(dys[0]):
        E, C, Fo = dys[0].shape
        D = ws[0].shape[1]
        return _fake("moe_gemm_dx", dys[0], ws, D,
                     2.0 * E * C * D * Fo * len(dys), dys[1:])
    if dys[0].device.type == "cpu":
        return moe_gemm_dx_ref(dys, ws)
    if len(ws) != len(dys):
        raise ValueError(f"moe_gemm_dx: {len(dys)} dy, {len(ws)} w")
    E, C, Fo = dys[0].shape
    D = ws[0].shape[1]
    dys = _operands("moe_gemm_dx", dys, ws,
                    [(E, C, Fo)] * len(dys) + [(E, D, Fo)] * len(ws))
    w = ws[0]
    if w.stride(2) != 1 or any(t.stride() != w.stride() for t in ws):
        raise ValueError("moe_gemm_dx: w_j need one stride pair and unit "
                         "stride along F")
    dx = torch.empty((E, C, D), dtype=w.dtype, device=w.device)
    tc = _bwd_tiles(D, Fo, *dys, *ws, dx)
    two = len(dys) == 2
    rc = call_on_stream(
        _library().moe_gemm_dx_launch, w, _DTYPE_CODE[w.dtype], int(tc),
        len(dys), dys[0].data_ptr(), dys[two].data_ptr(), dys[0].stride(0),
        dys[0].stride(1), w.data_ptr(), ws[two].data_ptr(), w.stride(0),
        w.stride(1), dx.data_ptr(), E, C, D, Fo)
    _count("moe_gemm_dx", rc, tc)
    return dx


def moe_gemm_dw(a, dys):
    """K3: ``[a^T @ dy_j]`` -> dw_j [E, D, F] in a's dtype for a [E, C, D]
    and one or two dy_j [E, C, F], reduced over C in f32 in increasing c.
    The plain version on the CPU."""
    dys = list(dys)
    if SH.is_fake(a):
        E, C, D = a.shape
        Fo = dys[0].shape[2]
        dws = [a.new_empty((E, D, Fo)) for _ in dys]
        SH.report_work("moe_gemm_dw", 2.0 * E * C * D * Fo * len(dys),
                       _nbytes(a, *dys, *dws))
        return dws
    if a.device.type == "cpu":
        return moe_gemm_dw_ref(a, dys)
    if a.stride(2) != 1:
        a = a.contiguous()
    E, C, D = a.shape
    Fo = dys[0].shape[2]
    dys = _operands("moe_gemm_dw", dys, [a],
                    [(E, C, Fo)] * len(dys) + [(E, C, D)])
    dws = [torch.empty((E, D, Fo), dtype=a.dtype, device=a.device)
           for _ in dys]
    tc = _bwd_tiles(D, Fo, a, *dys, *dws)
    two = len(dys) == 2
    rc = call_on_stream(
        _library().moe_gemm_dw_launch, a, _DTYPE_CODE[a.dtype], int(tc),
        len(dys), a.data_ptr(), a.stride(0), a.stride(1), dys[0].data_ptr(),
        dys[two].data_ptr(), dys[0].stride(0), dys[0].stride(1),
        dws[0].data_ptr(), dws[two].data_ptr(), E, C, D, Fo)
    _count("moe_gemm_dw", rc, tc)
    return dws


class MoEGemm(torch.autograd.Function):
    """``moe_gemm`` with a gradient: the forward is today's launch (the
    plain version on the CPU) and saves x and w; the backward is K2 for dx
    and K3 for dw, each only where it is needed."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward_gemm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        dx = moe_gemm_dx((dy,), (w,)) if need_x else None
        dw = moe_gemm_dw(x, (dy,))[0] if need_w else None
        return dx, dw


class MoEFFNFused(torch.autograd.Function):
    """``moe_ffn_fused`` with a gradient: the forward is today's launch
    and saves x and the weights (not gate and up: K1 recomputes them); the
    backward is K1 (dg, du), K2 on both pairs (dx) and K3 on both outputs
    (dw_gate, dw_up), each only where it is needed."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up):
        ctx.save_for_backward(x, w_gate, w_up)
        return _forward_ffn(x, w_gate, w_up)

    @staticmethod
    def backward(ctx, dout):
        x, w_gate, w_up = ctx.saved_tensors
        need_x, need_g, need_u = ctx.needs_input_grad
        dg, du = moe_ffn_fused_bwd(x, w_gate, w_up, dout)
        dx = moe_gemm_dx((dg, du), (w_gate, w_up)) if need_x else None
        dys = [t for t, need in ((dg, need_g), (du, need_u)) if need]
        dws = iter(moe_gemm_dw(x, dys) if dys else ())
        return (dx, next(dws) if need_g else None,
                next(dws) if need_u else None)

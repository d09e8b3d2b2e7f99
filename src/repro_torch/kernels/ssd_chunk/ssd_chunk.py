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

The wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernels or raises: there is no fallback.
``LAUNCHES`` counts wrapper calls that launched (one per successful call,
whatever the number of kernels, nowhere else).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import (call_on_stream, load,
                                      refuse_autograd)

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"ssd_chunk": 0}

#: largest chunk length and state size one block's shared memory holds
MAX_CHUNK = MAX_STATE = 128

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_I, _P, _LL, _LL, _P, _P, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P,
             _P, _I, _I, _I, _I, _I, _I, _I, _P]
_lib = None


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
    zero-padded); the products run in f32. Returns (y [b, l, nh, hp] f32,
    S_final [b, nh, hp, n] f32)."""
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
    S = S0.float()
    ys = []
    for c in range(x.shape[1] // Q):
        sl = slice(c * Q, (c + 1) * Q)
        dtq = dt[:, sl].float()                          # [b, Q, nh]
        cum = torch.cumsum(dtq * A, dim=1)
        Bh = B[:, sl].float().repeat_interleave(hpg, dim=2)   # [b, Q, nh, n]
        Ch = C[:, sl].float().repeat_interleave(hpg, dim=2)
        xdt = x[:, sl].float() * dtq[..., None]          # [b, Q, nh, hp]
        seg = cum[:, :, None, :] - cum[:, None, :, :]    # [b, Q, Q, nh] (i, j)
        ldec = torch.where(causal, torch.exp(seg), torch.zeros_like(seg))
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


def ssd_chunk(x, dt, A, B, C, S0, chunk: int):
    """The chunked SSD scan of ``_ssd_chunked``: (y [b, l, nh, hp] f32,
    S_final [b, nh, hp, n] f32). See ``ssd_chunk_ref`` for the layouts."""
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, A, B, C, S0, chunk)
    refuse_autograd("ssd_chunk", x, dt, A, B, C, S0,
                    why="ROADMAP.md queue 1 item 4(c) is open")
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
    return y, S_final

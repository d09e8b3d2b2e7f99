"""RG-LRU linear recurrence: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``rglru_scan`` of
``src/repro/kernels/rglru_scan/rglru_scan.py`` (``pl.pallas_call`` at :57)
and computes the function the model calls, the reference's ``_scan_lru``
(``src/repro/models/rglru.py:100-127``): ``h_t = a_t * h_{t-1} + b_t`` from
a given ``h0``, so ``h[:, -1]`` is the carried state. The kernel is in
``csrc/rglru_scan.cu``; its header says what bounds it on the card and how
its design answers it.

The wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: there is no fallback.
``LAUNCHES`` counts kernel launches (one per successful launch, nowhere
else).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import (call_on_stream, load,
                                      refuse_autograd)

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"rglru_scan": 0}

#: time chunk of the reference's scan (rglru.py ``_CHUNK``)
_CHUNK = 256

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {        # C function -> (return type, argument types)
    "rglru_scan_launch": (_I, [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P]),
    "rglru_scan_ws_bytes": (_LL, [_I, _I, _I]),
}
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("rglru_scan")
        for fn, (res, args) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        _lib = lib
    return _lib


def rglru_scan_ref(a, b, h0):
    """Port of ``_scan_lru``: chunks of 256 steps, the carried state folded
    into each chunk's first element, and inside a chunk a log-depth
    inclusive scan of the pairs (a, b) under
    ``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)``. a, b: [B, T, W];
    h0: [B, W]; all f32 -> h [B, T, W] f32."""
    B, T, W = a.shape
    a, b = a.float(), b.float()
    chunk = min(_CHUNK, T)
    pad = (-T) % chunk
    if pad:
        a = torch.cat([a, a.new_ones((B, pad, W))], dim=1)
        b = torch.cat([b, b.new_zeros((B, pad, W))], dim=1)
    h = h0.float()
    outs = []
    for c in range(a.shape[1] // chunk):
        ai = a[:, c * chunk:(c + 1) * chunk]
        bi = b[:, c * chunk:(c + 1) * chunk].clone()
        bi[:, 0] = bi[:, 0] + ai[:, 0] * h
        off = 1
        while off < chunk:
            bi = torch.cat([bi[:, :off],
                            ai[:, off:] * bi[:, :-off] + bi[:, off:]], dim=1)
            ai = torch.cat([ai[:, :off], ai[:, off:] * ai[:, :-off]], dim=1)
            off *= 2
        h = bi[:, -1]
        outs.append(bi)
    return torch.cat(outs, dim=1)[:, :T]


def _check(a, b, h0) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda tensors, got "
                         f"{a.device}")
    if any(t.device != a.device for t in (b, h0)):
        raise ValueError(f"a on {a.device}, b on {b.device}, h0 on "
                         f"{h0.device}")
    if any(t.dtype != torch.float32 for t in (a, b, h0)):
        raise ValueError(f"dtypes a {a.dtype}, b {b.dtype}, h0 {h0.dtype}: "
                         f"the kernel takes float32")
    if a.dim() != 3 or b.shape != a.shape \
            or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}, h0 "
                         f"{tuple(h0.shape)}: need [B, T, W] and [B, W]")
    if not all(t.is_contiguous() for t in (a, b, h0)):
        raise ValueError("a, b and h0 must be contiguous")
    B, T, W = a.shape
    if not (1 <= B <= 65535 and T >= 1 and W >= 1):
        raise ValueError(f"B {B}, T {T}, W {W}: need 1 <= B <= 65535 and "
                         f"T, W >= 1")


@functools.lru_cache(maxsize=None)
def _ws_bytes(B: int, T: int, W: int) -> int:
    return _library().rglru_scan_ws_bytes(B, T, W)


def rglru_scan(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h0. a, b: [B, T, W] f32;
    h0: [B, W] f32 -> h [B, T, W] f32."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    refuse_autograd("rglru_scan", a, b, h0,
                    why="ROADMAP.md queue 1 item 4(b) is open")
    _check(a, b, h0)
    B, T, W = a.shape
    h = torch.empty_like(a)
    # chunk aggregates, done bits and the ticket (the launcher zeroes the
    # last two)
    ws = torch.empty(_ws_bytes(B, T, W), dtype=torch.uint8, device=a.device)
    rc = call_on_stream(
        _library().rglru_scan_launch, a, a.data_ptr(), b.data_ptr(),
        h0.data_ptr(), h.data_ptr(), ws.data_ptr(), ws.numel(), B, T, W)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES["rglru_scan"] += 1
    return h

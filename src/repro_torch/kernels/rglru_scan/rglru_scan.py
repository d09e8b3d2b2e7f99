"""RG-LRU linear recurrence: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``rglru_scan`` of
``src/repro/kernels/rglru_scan/rglru_scan.py`` (``pl.pallas_call`` at :57)
and computes the function the model calls, the reference's ``_scan_lru``
(``src/repro/models/rglru.py:100-127``): ``h_t = a_t * h_{t-1} + b_t`` from
a given ``h0``, so ``h[:, -1]`` is the carried state. The kernel is in
``csrc/rglru_scan.cu``; its header says what bounds it on the card and how
its design answers it.

The backward, ``rglru_scan_bwd``, is the same kernel run in reverse (the
gradient's recurrence ``g_t = dh_t + a_{t+1} g_{t+1}``, then ``da``,
``db`` and ``dh0`` in its epilogue); ``RGLRUScan`` wraps the two in an
autograd Function, which ``rglru_scan`` goes through while autograd
records.

The wrappers take the plain versions only for tensors on the CPU. For a
CUDA tensor they launch the kernel or raise: there is no fallback.
``LAUNCHES`` counts kernel launches (one per successful launch, nowhere
else).

DTensor inputs (the port's distribution layer) run the kernel on every
rank's shards through ``local_map``, in the layout
``kernels.sharded.scan_layout`` picks: the recurrence is elementwise over
W, so a rank's batch rows and W columns are an independent launch and no
collective runs in either direction; a split T, or a partial sum, is
redistributed to whole T explicitly first. On a ``FakeTensor`` (the dry
run) the wrappers allocate their outputs and report the work
(``kernels.sharded.report_work``): a multiply and an add an element
forward, the reverse scan's and ``da``'s three backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import sharded as SH
from repro_torch.kernels.build import call_on_stream, load

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"rglru_scan": 0, "rglru_scan_bwd": 0}

#: time chunk of the reference's scan (rglru.py ``_CHUNK``)
_CHUNK = 256

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {        # C function -> (return type, argument types)
    "rglru_scan_launch": (_I, [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P]),
    "rglru_scan_bwd_launch": (_I, [_P] * 8 + [_LL, _I, _I, _I, _P]),
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


def _wide(t):
    """t in f32, or in f64 where it is f64 (the gradient checks)."""
    return t if t.dtype == torch.float64 else t.float()


def rglru_scan_ref(a, b, h0):
    """Port of ``_scan_lru``: chunks of 256 steps, the carried state folded
    into each chunk's first element, and inside a chunk a log-depth
    inclusive scan of the pairs (a, b) under
    ``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)``. a, b: [B, T, W];
    h0: [B, W]; all f32 -> h [B, T, W] f32 (f64 in, f64 out)."""
    B, T, W = a.shape
    a, b = _wide(a), _wide(b)
    chunk = min(_CHUNK, T)
    pad = (-T) % chunk
    if pad:
        a = torch.cat([a, a.new_ones((B, pad, W))], dim=1)
        b = torch.cat([b, b.new_zeros((B, pad, W))], dim=1)
    h = _wide(h0)
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


def _sharded(a, b, h0):
    """``rglru_scan`` on DTensors a, b [B, T, W] and h0 [B, W] (a tensor:
    replicated): the kernel (its plain version on CPU shards) on every
    rank's rows and columns through ``local_map``, differentiable as the
    local call is (``RGLRUScan``); every gradient takes its input's
    layout, none is a partial sum."""
    from torch.distributed.tensor.experimental import local_map
    mesh = a.device_mesh
    lay = SH.scan_layout(a, a.shape[2])
    a, b = (SH.redistribute(t, mesh, lay.seq) for t in (a, b))
    h0 = SH.redistribute(h0, mesh, lay.state)
    s, st = list(lay.seq), list(lay.state)
    return local_map(rglru_scan, out_placements=s, in_placements=(s, s, st),
                     in_grad_placements=(s, s, st),
                     device_mesh=mesh)(a, b, h0)


def _sharded_bwd(a, h, h0, dh):
    """``rglru_scan_bwd`` on DTensors: every rank's rows and columns, in
    ``rglru_scan``'s layout; (da, db, dh0) laid out as a, b and h0."""
    from torch.distributed.tensor.experimental import local_map
    mesh = a.device_mesh
    lay = SH.scan_layout(a, a.shape[2])
    a, h, dh = (SH.redistribute(t, mesh, lay.seq) for t in (a, h, dh))
    h0 = SH.redistribute(h0, mesh, lay.state)
    s, st = list(lay.seq), list(lay.state)
    return local_map(rglru_scan_bwd, out_placements=(s, s, st),
                     in_placements=(s, s, st, s),
                     device_mesh=mesh)(a, h, h0, dh)


def _forward(a, b, h0):
    if SH.is_fake(a):        # the dry run: the kernel's output and work
        SH.report_work("rglru_scan", 2 * a.numel(),
                       4 * (3 * a.numel() + h0.numel()))
        return torch.empty_like(a)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
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


def rglru_scan_bwd_ref(a, h, h0, dh):
    """The gradient of ``rglru_scan``: from a [B, T, W], its output h, h0
    [B, W] and dh [B, T, W] (the gradient of h; the final state's is in its
    last row) -> (da, db [B, T, W], dh0 [B, W]), all f32. The gradient
    reaching h_t, ``g_t = dh_t + a_{t+1} g_{t+1}`` (g_T = 0), is the plain
    forward scan run on the reversed steps; ``db = g``, ``da_t = g_t
    h_{t-1}`` (h_{-1} = h0), ``dh0 = a_0 g_0``."""
    a, h, h0, dh = (_wide(t) for t in (a, h, h0, dh))
    B, T, W = a.shape
    a_next = torch.cat([a[:, 1:], a.new_ones((B, 1, W))], dim=1)
    g = rglru_scan_ref(a_next.flip(1), dh.flip(1), a.new_zeros((B, W)))
    g = g.flip(1)
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    return g * h_prev, g, a[:, 0] * g[:, 0]


def rglru_scan_bwd(a, h, h0, dh):
    """(da, db, dh0) of ``rglru_scan_bwd_ref``: the plain version on the
    CPU, else the kernel's reverse scan (one launch); DTensors on every
    rank's shards (``_sharded_bwd``)."""
    if SH.is_dtensor(a):
        return _sharded_bwd(a, h, h0, dh)
    if SH.is_fake(a):        # the dry run: the outputs and the work
        SH.report_work("rglru_scan_bwd", 3 * a.numel(),
                       4 * (5 * a.numel() + 2 * h0.numel()))
        return torch.empty_like(a), torch.empty_like(a), \
            torch.empty_like(h0)
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, h, h0, dh)
    dh = dh.contiguous()
    _check(a, dh, h0)
    if h.shape != a.shape or h.dtype != torch.float32 \
            or h.device != a.device or not h.is_contiguous():
        raise ValueError(f"h {tuple(h.shape)} {h.dtype}: need a contiguous "
                         f"f32 tensor shaped like a")
    B, T, W = a.shape
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), \
        torch.empty_like(h0)
    ws = torch.empty(_ws_bytes(B, T, W), dtype=torch.uint8, device=a.device)
    rc = call_on_stream(
        _library().rglru_scan_bwd_launch, a, a.data_ptr(), h.data_ptr(),
        h0.data_ptr(), dh.data_ptr(), da.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), ws.data_ptr(), ws.numel(), B, T, W)
    if rc != 0:
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["rglru_scan_bwd"] += 1
    return da, db, dh0


class RGLRUScan(torch.autograd.Function):
    """``rglru_scan`` with a gradient: the forward is the scan (the plain
    version on the CPU) and saves a, h and h0; the backward is the reverse
    scan, whose gradients come back where they are needed. On DTensors
    ``apply`` runs the Function on every rank's shards (``_sharded``)."""

    @classmethod
    def apply(cls, a, b, h0):
        if SH.is_dtensor(a):
            return _sharded(a, b, h0)
        return super().apply(a, b, h0)

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _forward(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        grads = rglru_scan_bwd(a, h, h0, dh)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def rglru_scan(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h0. a, b: [B, T, W] f32;
    h0: [B, W] f32 -> h [B, T, W] f32. Differentiable in a, b and h0
    (``RGLRUScan``) while autograd records. DTensors run it on every
    rank's shards (``_sharded``)."""
    if SH.is_dtensor(a):
        return _sharded(a, b, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, h0)):
        return RGLRUScan.apply(a, b, h0)
    return _forward(a, b, h0)

"""Ambient-mesh activation sharding constraints (MaxText-style logical
axes), the port of the reference's ``repro.sharding.ctx``.

Model code calls ``constrain(x, "dp", None, "model", ...)`` at key points.
Inside ``with use_mesh(mesh):`` (the port's counterpart of JAX's ambient
mesh) a DTensor ``x`` is redistributed to that layout, so the activation
layout cannot drift into batch-replicated layouts between layers (the
failure mode the reference guards GSPMD against). On a plain tensor, or
outside any mesh (single-device runs, the CPU tests), it is the identity,
keeping the model code mesh-agnostic.

Dim tokens:
    "dp"    — shard over the data-parallel axes (pod+data) if divisible
    "model" — shard over the model axis if divisible
    None    — leave unsharded
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels.sharded import is_dtensor, redistribute
from repro_torch.sharding.planner import Spec, axis_sizes, placements

_STATE = threading.local()


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh for ``constrain`` and the model's
    mesh-aware dispatch (``attention._heads_shardable``); inside it a plain
    tensor that meets a DTensor counts as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    _STATE.stack.append(mesh)
    try:
        # plain tensors the model makes itself (positions, masks, zeros)
        # meet DTensors as replicated ones
        with implicit_replication():
            yield mesh
    finally:
        _STATE.stack.pop()


def dp_axes(mesh) -> tuple:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def constrain_spec(shape, mesh, *dims) -> Spec:
    """The Spec ``constrain`` pins for a tensor of ``shape``: the
    reference's divisibility rule."""
    if len(dims) != len(shape):
        raise ValueError(f"constrain: {len(dims)} dims for rank-{len(shape)}")
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    spec = []
    for i, d in enumerate(dims):
        if d == "dp" and dp and shape[i] % dp_size == 0:
            spec.append(dp if len(dp) > 1 else dp[0])
        elif d == "model" and "model" in sizes and \
                shape[i] % sizes["model"] == 0:
            spec.append("model")
        else:
            spec.append(None)
    return Spec(*spec)


class _Pin(torch.autograd.Function):
    """A DTensor redistributed to ``pls``, its gradient too: a sharding
    constraint holds in both directions, as GSPMD's does. (DTensor's own
    ``redistribute`` leaves a gradient's partial sums pending, and they
    then travel through the backward as sequence splits and activation
    gathers instead of one all-reduce at the layer boundary.)"""

    @staticmethod
    def forward(ctx, x, pls):
        ctx.pls = pls
        if tuple(x.placements) == pls:
            return x.view_as(x)
        return redistribute(x, x.device_mesh, pls)

    @staticmethod
    def backward(ctx, grad):
        return redistribute(grad, grad.device_mesh, ctx.pls), None


def pin(x, pls):
    """DTensor ``x`` redistributed to the placements ``pls``, and its
    gradient too (``_Pin``) while autograd records."""
    pls = tuple(pls)
    if not x.requires_grad:
        return redistribute(x, x.device_mesh, pls)
    return _Pin.apply(x, pls)


def constrain(x, *dims):
    """``x`` redistributed to the layout ``dims`` name, and its gradient
    to the same layout, when ``x`` is a DTensor inside ``use_mesh``; else
    ``x`` itself."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = constrain_spec(tuple(x.shape), mesh, *dims)
    return pin(x, placements(spec, mesh))

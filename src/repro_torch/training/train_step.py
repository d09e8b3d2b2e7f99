"""Train step: remat + microbatched gradient accumulation + AdamW, the
port of the reference's ``repro.training.train_step``.

Master params live in f32; matrix leaves (ndim >= 2) are cast to the
compute dtype (bf16) inside the loss, so the gradients reach the f32 master
through the cast. Microbatches run one after another, their f32 gradients
summed in order into the masters' ``.grad`` and then divided by their
count, as the reference's ``lax.scan`` does. Optional int8 gradient
compression with error feedback runs before AdamW
(``repro_torch.training.compression``).

The step updates the state's tensors in place (params, m, v, and ef when
compressing) and returns a state holding them: one copy of the f32 state
on the card, where the reference's jitted step donates its input state.
``abstract_train_state`` gives the state on the ``meta`` device (shapes
and dtypes for the planner and the dry run) and ``train_state_specs`` its
per-leaf specs from a sharding plan. On a state of DTensors laid out by
those specs the step runs unchanged: the model's DTensor ops, AdamW's
in-place updates on each rank's shards, and the gradients' reduction to
their masters' layout (``_grad_like_param``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.bridge import leaves, tree_map
from repro_torch.kernels.sharded import (contiguous_stride, is_dtensor,
                                         redistribute)
from repro_torch.models.transformer import LM
from repro_torch.training import compression as comp
from repro_torch.training.optimizer import (AdamWHyper, adamw_init,
                                            adamw_update)


class TrainState(NamedTuple):
    params: Any                  # f32 master weights
    opt: Dict[str, Any]          # m, v, step
    ef: Optional[Any] = None     # error-feedback residual (compression)


def _to_master(params):
    return tree_map(lambda p: p.float(), params)


def _to_compute(params, dtype):
    return tree_map(lambda p: p.to(dtype) if p.dim() >= 2 else p, params)


def init_train_state(lm: LM, seed: int = 0, *, compress: bool = False,
                     device=None) -> TrainState:
    """f32 master weights of ``lm.init(seed)`` (drawn on ``device``, the
    card unless the caller asks for the CPU or ``meta``), zero AdamW
    moments and, with ``compress``, a zero error-feedback residual."""
    dev = resolve_device(device)
    params = _to_master(lm.init(seed, device=dev))
    ef = tree_map(torch.zeros_like, params) if compress else None
    return TrainState(params=params, opt=adamw_init(params), ef=ef)


def _grad_like_param(p):
    """``p.grad`` (zeros if none) in ``p``'s own layout: on a DTensor
    master this is the data-parallel reduction (a replicated leaf's
    gradient arrives as partial sums over the ranks that used it)."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    if is_dtensor(g):
        g = redistribute(g, p.device_mesh, p.placements)
    return g


def _microbatch(v, i: int, n: int):
    """Microbatch ``i`` of ``n`` of a [b, ...] batch tensor: rows
    ``[i b/n, (i+1) b/n)``; of a DTensor split over its batch, slice ``i``
    of every rank's own rows, so no rank takes another's. Where the rows
    must group as they do unsharded, ``distribute_batch`` puts the rows of
    microbatch ``i`` there, each rank its share in order (on one rank the
    two agree)."""
    if is_dtensor(v) and any(p.is_shard(0) for p in v.placements):
        from torch.distributed.tensor import DTensor
        local = v.to_local()
        m = local.shape[0] // n
        shape = (v.shape[0] // n,) + tuple(v.shape[1:])
        return DTensor.from_local(local[i * m:(i + 1) * m], v.device_mesh,
                                  v.placements, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))
    m = v.shape[0] // n
    return v[i * m:(i + 1) * m]


def distribute_batch(batch, plan, mesh, microbatches: int = 1):
    """The [b, ...] batch tensors as DTensors laid out by the plan's
    ``batch_specs``, for a step of ``microbatches``. Where the model routes
    the tokens of several rows together (the flattened MoE group,
    ``moe.flattens``), a microbatch must hold the rows it holds unsharded,
    so rows split over ``parts`` data ranks are put in the order in which
    every rank's ``i``-th of ``microbatches`` local slices is its share of
    microbatch ``i`` (global rows ``[i b/n, (i+1) b/n)``). Elsewhere each
    row's loss is its own, any partition of the rows gives the step's
    value, and the rows stay as ``distribute`` splits them. No
    communication: every rank holds the whole batch, as ``distribute``
    takes it."""
    from repro_torch.models.moe import flattens
    from repro_torch.sharding.planner import distribute, placements
    specs = plan.batch_specs
    regroup = (microbatches > 1
               and flattens(plan.cfg, batch["tokens"].shape[1]))
    out = {}
    for k, v in batch.items():
        parts = math.prod(mesh.size(d) for d, p in
                          enumerate(placements(specs[k], mesh))
                          if p.is_shard(0))
        if regroup and parts > 1:
            b = v.shape[0]
            if b % (microbatches * parts):
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches of "
                                 f"{parts} data ranks")
            order = torch.arange(b, device=v.device).reshape(
                microbatches, parts, -1).transpose(0, 1).reshape(-1)
            v = v[order]
        out[k] = distribute(v, specs[k], mesh)
    return out


def abstract_train_state(lm: LM, *, compress: bool = False) -> TrainState:
    """The train state on the ``meta`` device: its shapes and dtypes,
    no storage (the reference's ``jax.eval_shape`` of the init)."""
    return init_train_state(lm, 0, compress=compress, device="meta")


def train_state_specs(plan, state: TrainState) -> TrainState:
    """Specs for the whole train state from the plan's param specs: the
    moments and the error-feedback residual are laid out as their params,
    the step is replicated."""
    from repro_torch.sharding.planner import Spec
    pspec = plan.param_specs
    return TrainState(
        params=pspec,
        opt={"m": pspec, "v": pspec, "step": Spec()},
        ef=pspec if state.ef is not None else None)


def accumulate_grads(lm: LM, params, batch, compute_dtype=torch.bfloat16):
    """One (micro)batch's loss and backward with the matrices cast to
    ``compute_dtype``: the f32 gradients add into the masters' ``.grad``
    (the masters must require grad). Returns (loss, metrics), detached."""
    loss, metrics = lm.loss(_to_compute(params, compute_dtype), batch)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def make_train_step(lm: LM, *, hyper: AdamWHyper = AdamWHyper(),
                    microbatches: int = 1, compress: bool = False,
                    compute_dtype=torch.bfloat16):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds [b, ...] tensors (b a multiple of ``microbatches``) on the
    params' device, DTensors by ``distribute_batch`` on a sharded state."""

    def train_step(state: TrainState, batch):
        params = state.params
        masters = leaves(params)
        for p in masters:
            p.requires_grad_(True)
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32,
                           device=masters[0].device)
        for i in range(microbatches):
            part = {k: _microbatch(v, i, microbatches)
                    if v.dim() and k != "positions" else v
                    for k, v in batch.items()}
            loss = loss + accumulate_grads(lm, params, part,
                                           compute_dtype)[0]
        grads = tree_map(_grad_like_param, params)
        for p in masters:
            p.requires_grad_(False)
            p.grad = None
        if microbatches > 1:
            for g in leaves(grads):
                g.div_(microbatches)
            loss = loss / microbatches
        ef = state.ef
        if compress and ef is not None:
            grads, ef = comp.compress_tree(grads, ef)
        with torch.no_grad():
            new_params, opt, gn = adamw_update(grads, state.opt, params,
                                               hyper)
        metrics = {"loss": loss, "grad_norm": gn,
                   "step": opt["step"].float()}
        return TrainState(new_params, opt, ef), metrics

    return train_step

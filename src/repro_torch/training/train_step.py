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
``abstract_train_state`` and ``train_state_specs`` (the sharding plan) wait
for the port's distribution (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.bridge import leaves, tree_map
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
    params' device."""

    def train_step(state: TrainState, batch):
        params = state.params
        masters = leaves(params)
        for p in masters:
            p.requires_grad_(True)
            p.grad = None
        b = batch["tokens"].shape[0]
        mb = b // microbatches
        loss = torch.zeros((), dtype=torch.float32,
                           device=masters[0].device)
        for i in range(microbatches):
            part = {k: v[i * mb:(i + 1) * mb] if v.dim() and k != "positions"
                    else v for k, v in batch.items()}
            loss = loss + accumulate_grads(lm, params, part,
                                           compute_dtype)[0]
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
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

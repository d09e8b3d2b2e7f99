"""AdamW on nested dicts of torch tensors, the port of the reference's
``repro.training.optimizer`` (raw JAX, no optax).

Optimizer state tensors (m, v) are f32 trees shaped like the params. The
scalars the reference computes as f32 jnp scalars (the learning rate, the
bias corrections ``1 - b ** step``) are f32 tensors here too, so the
update rounds where the reference's does. Leaves are visited in the order
``jax.tree.leaves`` walks them (dict keys sorted, tuples in order), which
fixes the order ``global_norm`` sums them in.

The reference's functions return new trees; these update their
arguments in place (params, m, v, and the clipped grads), each op the
reference's in its order, through two temporaries a leaf: at a full-width
embedding (1.05 B parameters, 4.2 GB in f32) a chain of fresh tensors a
leaf, or a second copy of the state, would not fit beside it on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.bridge import leaves, tree_map


class AdamWHyper(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(h: AdamWHyper, step) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, as an f32 scalar tensor."""
    device = step.device if isinstance(step, torch.Tensor) else None
    step = _f32(step, device)
    warm = torch.clamp(_f32(step + 1) / max(h.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - h.warmup_steps)
                       / max(h.total_steps - h.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.9 * 0.5 * (1 + torch.cos(_f32(math.pi, device) * prog))
    return h.lr * warm * cos


def adamw_init(params):
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(_f32(total))


def clip_by_global_norm(grads, max_norm):
    """Scales ``grads`` in place by min(1, max_norm / max(norm, 1e-12));
    returns (grads, norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for g in leaves(grads):
        g.mul_(scale)
    return grads, gn


def adamw_update(grads, opt_state, params, h: AdamWHyper):
    """One AdamW step on f32 trees, in place: ``params``, ``m`` and ``v``
    are updated in their own storage and ``grads`` clipped in theirs (no
    second copy of the state on the card). Returns (params, state, grad
    norm), the state's step a new tensor."""
    grads, gn = clip_by_global_norm(grads, h.grad_clip)
    step = opt_state["step"] + 1
    lr = lr_at(h, step)
    stepf = step.float()
    b1c = 1.0 - _f32(h.b1, step.device) ** stepf
    b2c = 1.0 - _f32(h.b2, step.device) ** stepf

    def upd(p, g, m, v):
        # the reference's expressions in its order, through two temporaries
        g = g.float()
        tmp = torch.mul(g, 1 - h.b1)
        m.mul_(h.b1).add_(tmp)                       # b1 m + (1 - b1) g
        torch.mul(g, 1 - h.b2, out=tmp).mul_(g)
        v.mul_(h.b2).add_(tmp)                       # b2 v + (1 - b2) g g
        torch.div(v, b2c, out=tmp).sqrt_().add_(h.eps)
        delta = torch.div(m, b1c).div_(tmp)          # mh / (sqrt(vh) + eps)
        if p.dim() >= 2:            # decoupled weight decay on matrices only
            delta.add_(torch.mul(p, h.weight_decay, out=tmp))
        p.sub_(delta.mul_(lr))

    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        upd(p, g, m, v)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, gn

"""Gradient compression for the data-parallel reduce: int8 quantisation
with error feedback, the port of the reference's
``repro.training.compression``.

Per-tensor symmetric int8 with the residual carried to the next step;
leaves of fewer than two dims pass uncompressed. ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the integers match the
reference's. ``compress_tree`` is the hook ``make_train_step(compress=True)``
calls before AdamW.
"""

from __future__ import annotations

import torch



def quantize(x, bits: int = 8):
    """Symmetric per-tensor int quantisation. Returns (q, scale)."""
    qmax = float(2 ** (bits - 1) - 1)
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax / qmax, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def compress_leaf(g, ef):
    """Error-feedback compression of one gradient leaf: (g', residual)."""
    g = g.float() + ef
    if g.dim() < 2:          # tiny leaves: not worth compressing
        return g, torch.zeros_like(g)
    q, scale = quantize(g)
    deq = dequantize(q, scale)
    return deq, g - deq


def compress_tree(grads, ef_tree):
    """(compressed grads, new residuals), each shaped like ``grads``."""
    if isinstance(grads, dict):
        pairs = {k: compress_tree(grads[k], ef_tree[k]) for k in grads}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if isinstance(grads, (tuple, list)):
        pairs = [compress_tree(g, e) for g, e in zip(grads, ef_tree)]
        return (type(grads)(p[0] for p in pairs),
                type(grads)(p[1] for p in pairs))
    return compress_leaf(grads, ef_tree)

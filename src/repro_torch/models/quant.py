"""Weight-only int8 quantisation for serving: dequantise on read.

Quantised matrix params are ``{"q": int8, "s": f32 per-output-channel
scales}``, made by ``quantize_weight`` / ``quantize_tree`` with the
reference's rule and bits; ``as_weight`` dequantises at the matmul call
site, so at rest the weights cost half the memory while every consumer
still sees a dense matrix. The MoE expert kernels take a quantised weight
as it is and dequantise in shared memory (``kernels.moe_gemm``).

Every weight consumer calls ``as_weight`` (no-op for plain tensors), so the
same model code serves bf16/f32 and int8 checkpoints.
"""

from __future__ import annotations

import torch

#: leaves never quantised: embedding/unembedding (gather/loss paths),
#: depthwise convs (indexed per-tap), gates/router (f32 numerics)
EXCLUDE = ("embed", "lm_head", "conv", "gate_a", "gate_i", "router",
           "lambda", "scale", "bias")

_FLOATS = (torch.bfloat16, torch.float32, torch.float16)


def quantize_weight(w):
    """Symmetric per-output-channel int8: reduce only the contracting (−2)
    dim, so layer-stacked weights [L, in, out] get per-(layer, channel)
    scales [L, 1, out]. ``|w|``'s max is taken as ``max(max w, −min w)``
    and the quotient rounded in place, so the only f32 temporary is one
    copy of ``w``; the values are the reference's bit for bit (IEEE f32
    division, round half to even)."""
    wf = w.to(torch.float32, copy=True)
    ax = w.dim() - 2
    amax = torch.maximum(wf.amax(ax, keepdim=True),
                         wf.amin(ax, keepdim=True).neg())
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = wf.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def quantizes(name: str, shape, dtype, min_size: int = 1 << 12) -> bool:
    """``quantize_tree``'s rule for one leaf, from its key, shape and
    dtype: a float matrix (ndim >= 2, at least ``min_size`` elements) whose
    name is not in ``EXCLUDE``."""
    n = 1
    for d in shape:
        n *= int(d)
    return (name not in EXCLUDE and len(shape) >= 2 and dtype in _FLOATS
            and n >= min_size)


def quantize_tree(params, *, min_size: int = 1 << 12):
    """Quantise every float matrix leaf (ndim >= 2, size >= min_size) of a
    param tree, dicts walked by key and tuples (the hybrid's layers) in
    order; small leaves (norm scales, biases, A_log, ...) and EXCLUDE-listed
    names stay as they are. A leaf's name is its innermost key."""

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(t, str(i)) for i, t in enumerate(tree))
        if isinstance(tree, torch.Tensor) and quantizes(
                name, tree.shape, tree.dtype, min_size):
            return quantize_weight(tree)
        return tree

    return walk(params, "")


def stacked_init(shape, dtype, device, draw, int8: bool):
    """A layer-stacked matrix leaf ``shape`` = [n, ...] filled one slice at
    a time: ``draw()`` returns slice i in ``dtype``. With ``int8``, a leaf
    that ``quantizes`` (as a matrix whose name is not in ``EXCLUDE``) is
    built as an int8 stack and its f32 scales instead, each slice
    quantised as it is drawn: the same bits as ``quantize_weight`` of the
    whole stack (scales are per slice and channel), with no stack in
    ``dtype`` ever held."""
    if int8 and quantizes("", shape, dtype):
        q = torch.empty(shape, dtype=torch.int8, device=device)
        s = torch.empty(tuple(shape[:-2]) + (1, shape[-1]),
                        dtype=torch.float32, device=device)
        for i in range(shape[0]):
            qi = quantize_weight(draw())
            q[i].copy_(qi["q"])
            s[i].copy_(qi["s"])
        return {"q": q, "s": s}
    w = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        w[i].copy_(draw())
    return w


def abstract_quantize_tree(params):
    """``quantize_tree``'s result on the ``meta`` device, shapes and
    dtypes only, by the reference's ``abstract_quantize_tree`` rule (bf16
    or f32 matrices of at least 4096 elements outside ``EXCLUDE``): each
    becomes {"q": int8 of its shape, "s": f32 with the contracting (-2)
    dim 1}."""

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(t, str(i)) for i, t in enumerate(tree))
        n = 1
        for d in tree.shape:
            n *= int(d)
        if (name not in EXCLUDE and tree.dim() >= 2 and n >= (1 << 12)
                and tree.dtype in (torch.bfloat16, torch.float32)):
            sshape = tuple(1 if i == tree.dim() - 2 else d
                           for i, d in enumerate(tree.shape))
            return {"q": torch.empty(tree.shape, dtype=torch.int8,
                                     device="meta"),
                    "s": torch.empty(sshape, dtype=torch.float32,
                                     device="meta")}
        return tree.to("meta")

    return walk(params, "")


def is_quantized(p) -> bool:
    return isinstance(p, dict) and set(p.keys()) == {"q", "s"}


def as_weight(p, dtype=torch.bfloat16):
    """Dequantise-on-read hook used at every matmul call site."""
    if is_quantized(p):
        return (p["q"].float() * p["s"]).to(dtype)
    return p

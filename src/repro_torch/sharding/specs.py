"""Assigned input-shape cells and their stand-in inputs, the port of the
reference's ``repro.sharding.specs``.

Every (architecture × shape) cell is well-defined here:

    train_4k     seq=4096    global_batch=256   -> train step
    prefill_32k  seq=32768   global_batch=32    -> prefill (serve)
    decode_32k   seq=32768   global_batch=128   -> decode step (1 new token,
                                                   KV cache of seq_len)
    long_500k    seq=524288  global_batch=1     -> decode step; only for
                 sub-quadratic archs (SSM / hybrid / SWA).

``input_specs`` returns tensors on the ``meta`` device, the port's
counterpart of the reference's ``ShapeDtypeStruct``s: shapes and dtypes, no
storage, which the dry run distributes by the plan.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from typing import TYPE_CHECKING

if TYPE_CHECKING:     # the models package imports this one (constrain)
    from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_runnable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the sub-quadratic rule."""
    cell = SHAPES[shape_name]
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention decode state at 524288 tokens is "
                       "outside the contract (sub-quadratic rule; DESIGN.md)")
    if cell.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only architecture has no decode step"
    return True, ""


def input_specs(cfg: ModelConfig, shape_name: str, *, scale: float = 1.0,
                device="meta"):
    """Stand-ins (tensors on ``device``, ``meta`` by default) for every
    model input of this cell: (cell, batch, seq, {name: tensor}).

    ``scale`` < 1 shrinks batch/seq for small-mesh integration tests while
    keeping the same structure."""
    cell = SHAPES[shape_name]
    batch = max(1, int(cell.batch * scale))
    seq = max(8, int(cell.seq * scale))

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    specs = {"tokens": empty((batch, seq), torch.int32)}
    if cell.kind == "train":
        specs["labels"] = empty((batch, seq), torch.int32)
    if cell.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            nv = cfg.num_frontend_tokens or 256
            specs["vision_embeds"] = empty((batch, min(nv, seq), cfg.d_model),
                                           torch.float32)
        if cfg.family == "encdec":
            src = max(8, int(cfg.source_len * (scale if scale < 1 else 1)))
            specs["frames"] = empty((batch, src, cfg.d_model), torch.float32)
    if cell.kind == "decode":
        specs["tokens"] = empty((batch, 1), torch.int32)
    return cell, batch, seq, specs

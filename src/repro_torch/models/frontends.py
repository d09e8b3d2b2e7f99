"""Modality frontend stubs: the audio and vision entries specify the
transformer backbone only, so these helpers make deterministic fake
frame / patch embeddings for smoke runs and examples.

Each draws from the ``torch.Generator`` it is given, on that generator's
device. The draws differ from the reference package's ``jax.random`` ones
for the same seed, so a comparison across the two packages hands both the
same numpy arrays instead.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def fake_vision_embeds(cfg: ModelConfig, generator: torch.Generator,
                       batch: int) -> torch.Tensor:
    """[batch, n, d_model] f32 patch embeddings, n =
    ``cfg.num_frontend_tokens`` (256 if unset), scaled by 0.02."""
    n = cfg.num_frontend_tokens or 256
    return torch.randn((batch, n, cfg.d_model), generator=generator,
                       device=generator.device) * 0.02


def fake_audio_frames(cfg: ModelConfig, generator: torch.Generator,
                      batch: int, src_len: int | None = None) -> torch.Tensor:
    """[batch, src, d_model] f32 frame embeddings, src = ``src_len`` or
    ``cfg.source_len``, scaled by 0.02."""
    src = src_len or cfg.source_len
    return torch.randn((batch, src, cfg.d_model), generator=generator,
                       device=generator.device) * 0.02


def make_batch(cfg: ModelConfig, generator: torch.Generator, batch: int,
               seq: int) -> dict:
    """Synthetic full batch for ``cfg``: int32 ``tokens`` [batch, seq],
    next-token ``labels``, and the frontend's extras (``vision_embeds``,
    whose positions get label -1, or ``frames``)."""
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=generator, device=generator.device,
                           dtype=torch.int32)
    out = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.frontend == "vision":
        out["vision_embeds"] = fake_vision_embeds(cfg, generator, batch)
        nv = out["vision_embeds"].shape[1]
        if nv <= seq:                 # no training on the vision positions
            out["labels"][:, :nv] = -1
    if cfg.frontend == "audio":
        out["frames"] = fake_audio_frames(cfg, generator, batch)
    return out

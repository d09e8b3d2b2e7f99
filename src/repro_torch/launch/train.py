"""Training launcher with fault-tolerant operation, the port of the
reference's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch edge-tiny \
        --steps 200 --device cpu

Wires together: config → microbatched remat train step → synthetic data
stream → periodic checkpoints (the reference's on-disk format) →
deterministic restart (``--resume`` picks up the latest step AND the data
cursor) → straggler policy telemetry. It runs on the CUDA card (the
attention through the flash forward and backward kernels) unless the
caller passes ``--device cpu``, and raises when there is no card. The
reference's ``--production`` (its sharding plan over a device mesh) waits
for the port's distribution (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.transformer import LM
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, SyntheticLMStream
from repro_torch.training.fault_tolerance import StragglerPolicy
from repro_torch.training.optimizer import AdamWHyper
from repro_torch.training.train_step import init_train_state, make_train_step


def train(arch: str = "edge-tiny", *, steps: int = 100, batch: int = 8,
          seq: int = 128, smoke: bool = False, ckpt_dir: str | None = None,
          ckpt_every: int = 50, resume: bool = False, compress: bool = False,
          microbatches: int = 1, log_every: int = 10, seed: int = 0,
          device=None):
    """Returns (state, losses). ``device`` None or "cuda" is the card."""
    dev = resolve_device(None if device in (None, "cuda") else device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    lm = LM(cfg)
    hyper = AdamWHyper(total_steps=steps)
    step_fn = make_train_step(lm, hyper=hyper, microbatches=microbatches,
                              compress=compress)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=seed)
    start_step = 0
    state = None
    if resume and ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            like = init_train_state(lm, seed, compress=compress,
                                    device="meta")
            state, extra = ckpt.restore(ckpt_dir, last, like, device=dev)
            start_step = extra.get("data_step", last)
            print(f"resumed from step {last} (data cursor {start_step})")
    if state is None:
        state = init_train_state(lm, seed, compress=compress, device=dev)

    stream = SyntheticLMStream(data_cfg, start_step=start_step)
    straggler = StragglerPolicy()
    losses = []
    for i in range(start_step, start_step + steps):
        batch_np = stream.next_batch()
        batch_dev = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch_np.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch_dev)
        loss = float(metrics["loss"])        # waits for the step
        dt = time.perf_counter() - t0
        verdict = straggler.observe("worker-0", dt)
        losses.append(loss)
        if i % log_every == 0 or i == start_step + steps - 1:
            print(f"step {i:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt*1e3:7.1f} ms {verdict}", flush=True)
        if ckpt_dir and ((i + 1) % ckpt_every == 0 or
                         i == start_step + steps - 1):
            ckpt.save(ckpt_dir, i + 1, state,
                      extra={"data_step": stream.step, "loss": loss})
    return state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="edge-tiny", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    a = ap.parse_args()
    _, losses = train(a.arch, steps=a.steps, batch=a.batch, seq=a.seq,
                      smoke=a.smoke, ckpt_dir=a.ckpt_dir,
                      ckpt_every=a.ckpt_every, resume=a.resume,
                      compress=a.compress, microbatches=a.microbatches,
                      seed=a.seed, device=a.device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()

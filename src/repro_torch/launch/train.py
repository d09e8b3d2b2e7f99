"""Training launcher with fault-tolerant operation, the port of the
reference's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch edge-tiny \
        --steps 200 --device cpu

Wires together: config → microbatched remat train step → synthetic data
stream → periodic checkpoints (the reference's on-disk format) →
deterministic restart (``--resume`` picks up the latest step AND the data
cursor) → straggler policy telemetry. It runs on the CUDA card (the
attention through the flash forward and backward kernels) unless the
caller passes ``--device cpu``, and raises when there is no card.

``--production`` runs the step on the production mesh, as the
reference's does: launched under ``torchrun`` (one rank a GPU, NCCL), it
builds the 16×16 data×model mesh over the ranks (raising with fewer than
256), makes the sharding plan from the state, lays the state out as
``train_state_specs`` says and splits each batch over the data axis.
With ``--ckpt-dir`` every rank joins each save (rank 0 writes the
reference's one-file format); ``--resume`` plans from a ``meta`` state and
restores the latest checkpoint straight into the plan's layout, each rank
reading only its own shards onto its card.
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
from repro_torch.training.train_step import (distribute_batch,
                                             init_train_state,
                                             make_train_step,
                                             train_state_specs)


def train(arch: str = "edge-tiny", *, steps: int = 100, batch: int = 8,
          seq: int = 128, smoke: bool = False, ckpt_dir: str | None = None,
          ckpt_every: int = 50, resume: bool = False, compress: bool = False,
          microbatches: int = 1, production_mesh: bool = False,
          log_every: int = 10, seed: int = 0, device=None):
    """Returns (state, losses). ``device`` None or "cuda" is the card.
    ``production_mesh``: run on the production mesh (``_production``)."""
    dev = resolve_device(None if device in (None, "cuda") else device)
    if production_mesh:
        _join_world(dev)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    lm = LM(cfg)
    hyper = AdamWHyper(total_steps=steps)
    step_fn = make_train_step(lm, hyper=hyper, microbatches=microbatches,
                              compress=compress)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=seed)
    start_step = 0
    state = mesh = plan = None
    if resume and ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            like = init_train_state(lm, seed, compress=compress,
                                    device="meta")
            shardings = None
            if production_mesh:
                mesh, plan = _production_plan(cfg, like, batch, seq, dev)
                shardings = (mesh, train_state_specs(plan, like))
            state, extra = ckpt.restore(ckpt_dir, last, like,
                                        shardings=shardings, device=dev)
            start_step = extra.get("data_step", last)
            print(f"resumed from step {last} (data cursor {start_step})")
    if state is None:
        state = init_train_state(lm, seed, compress=compress, device=dev)
        if production_mesh:
            mesh, plan, state = _production(cfg, state, batch, seq, dev)

    stream = SyntheticLMStream(data_cfg, start_step=start_step)
    straggler = StragglerPolicy()
    losses = []
    for i in range(start_step, start_step + steps):
        batch_np = stream.next_batch()
        batch_dev = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch_np.items()}
        t0 = time.perf_counter()
        if mesh is None:
            state, metrics = step_fn(state, batch_dev)
        else:
            from repro_torch.sharding.ctx import use_mesh
            with use_mesh(mesh):
                state, metrics = step_fn(state, distribute_batch(
                    batch_dev, plan, mesh, microbatches))
            metrics = {k: v.full_tensor() for k, v in metrics.items()}
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


def _join_world(dev) -> None:
    """The process group of the ranks ``torchrun`` launched (its
    environment), NCCL with this rank's card, or gloo on the CPU."""
    import os
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if "RANK" not in os.environ:
        raise RuntimeError("--production runs under torchrun (one rank a "
                           "GPU): e.g. torchrun --nnodes=32 "
                           "--nproc-per-node=8 -m repro_torch.launch.train "
                           "--production")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")


def _production_plan(cfg, state, batch: int, seq: int, dev):
    """(mesh, plan) of ``state`` (its shapes alone: ``meta`` will do) on
    the production mesh over the launched ranks (the reference's
    ``--production``); raises with fewer ranks than the mesh needs."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import make_plan
    mesh = make_production_mesh(device_type=dev.type)
    return mesh, make_plan(cfg, mesh, "train", batch=batch, seq=seq,
                           param_tree=state.params)


def _production(cfg, state, batch: int, seq: int, dev):
    """(mesh, plan, ``state`` laid out by the plan) on the production
    mesh (``_production_plan``)."""
    from repro_torch.sharding.planner import distribute_tree
    mesh, plan = _production_plan(cfg, state, batch, seq, dev)
    state = distribute_tree(state, train_state_specs(plan, state), mesh)
    return mesh, plan, state


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
    ap.add_argument("--production", action="store_true",
                    help="the 16x16 production mesh, under torchrun")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    a = ap.parse_args()
    _, losses = train(a.arch, steps=a.steps, batch=a.batch, seq=a.seq,
                      smoke=a.smoke, ckpt_dir=a.ckpt_dir,
                      ckpt_every=a.ckpt_every, resume=a.resume,
                      compress=a.compress, microbatches=a.microbatches,
                      production_mesh=a.production, seed=a.seed,
                      device=a.device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()

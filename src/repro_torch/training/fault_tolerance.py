"""Fault tolerance for 1000+-node operation (design + simulatable logic).

Mechanisms (all exercised by tests on the CPU container):

* **Checkpoint/restart** — ``repro_torch.training.checkpoint`` + the resumable data
  cursor give deterministic restart; the train loop in
  ``repro_torch.launch.train`` wires heartbeats + periodic saves.
* **Elastic re-mesh** — ``remesh_after_failure``: given the surviving device
  list, choose the largest (data × model) grid that preserves the model-
  parallel degree, rebuild the plan, and restore the latest checkpoint onto
  it (GSPMD handles the re-sharding at device_put).
* **Straggler mitigation** — ``StragglerPolicy``: per-step deadline derived
  from a running p95 of step times; a worker exceeding it is marked suspect,
  and after ``strikes`` consecutive deadline misses the controller triggers
  re-mesh without it (training) — serving-side straggler handling lives in
  the QoS scheduler (``repro_torch.serving.scheduler``) as deadline-aware batch
  cutoffs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerPolicy:
    """Deadline-based straggler detection over step-time telemetry."""
    factor: float = 1.8          # deadline = factor * running p95
    strikes_to_evict: int = 3
    window: int = 50
    _times: list = field(default_factory=list)
    _strikes: dict = field(default_factory=dict)

    def deadline(self) -> float:
        if len(self._times) < 5:
            return float("inf")
        return self.factor * float(np.percentile(self._times[-self.window:], 95))

    def observe(self, worker: str, step_time: float) -> str:
        """Returns 'ok' | 'suspect' | 'evict'."""
        dl = self.deadline()
        self._times.append(step_time)
        if step_time <= dl:
            self._strikes[worker] = 0
            return "ok"
        self._strikes[worker] = self._strikes.get(worker, 0) + 1
        if self._strikes[worker] >= self.strikes_to_evict:
            return "evict"
        return "suspect"


def largest_grid(n_devices: int, model_degree: int) -> tuple[int, int]:
    """Largest (data, model) grid with fixed model degree fitting n devices."""
    if n_devices < model_degree:
        raise ValueError("fewer devices than the model-parallel degree")
    data = n_devices // model_degree
    return data, model_degree


def remesh_after_failure(all_devices, failed_ids, model_degree: int):
    """Pick survivors and the new mesh shape after a failure event.

    Returns (devices_kept, (data, model)). Devices beyond the largest full
    grid are spares (kept warm for the next failure).
    """
    survivors = [d for d in all_devices if getattr(d, "id", d) not in failed_ids]
    data, model = largest_grid(len(survivors), model_degree)
    keep = survivors[: data * model]
    return keep, (data, model)

"""Monte-Carlo latency model — paper §V-A.

End-to-end latency decomposes per Eq. (15):

    L = W_q + L_infer + L_net

* ``W_q``      — server-side queueing from offered load ρ, simulated with the
                 exact Lindley recursion W_{n+1} = max(0, W_n + S_n − A_n)
                 (Poisson arrivals at λ = ρ/E[S]), not an M/M/1 formula — the
                 tail blow-up near saturation is the phenomenon under test.
* ``L_infer``  — stochastic inference runtime (lognormal around the service
                 median; heavy-ish tail, σ configurable).
* ``L_net``    — transport: best-effort = base + lognormal jitter + rare
                 congestion spikes (Pareto mixture); QoS-provisioned = base +
                 small truncated jitter (the enforced p99.9 delay budget).

All times in milliseconds. Everything is vectorised numpy with a fixed seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SimConfig:
    n_requests: int = 20_000
    infer_median_ms: float = 40.0
    infer_sigma: float = 0.35
    # best-effort transport
    be_base_ms: float = 12.0
    be_sigma: float = 0.8
    be_spike_prob: float = 0.02
    be_spike_scale_ms: float = 80.0
    be_spike_alpha: float = 1.5       # Pareto tail index (heavy)
    # QoS-provisioned transport
    qos_base_ms: float = 8.0
    qos_sigma: float = 0.15
    qos_cap_ms: float = 25.0          # enforced delay budget
    seed: int = 0


class LatencyModel:
    def __init__(self, cfg: SimConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------
    def infer_times(self, rng, n: int) -> np.ndarray:
        c = self.cfg
        return c.infer_median_ms * np.exp(c.infer_sigma * rng.standard_normal(n))

    def queue_wait(self, rng, n: int, rho: float,
                   service_ms: np.ndarray) -> np.ndarray:
        """Lindley recursion at offered load ρ against the given services."""
        rho = min(max(rho, 1e-3), 0.999)
        lam = rho / float(np.mean(service_ms))          # arrivals per ms
        inter = rng.exponential(1.0 / lam, size=n)
        w = np.empty(n)
        acc = 0.0
        for i in range(n):
            w[i] = acc
            acc = max(0.0, acc + service_ms[i] - inter[i])
        return w

    def transport_best_effort(self, rng, n: int) -> np.ndarray:
        c = self.cfg
        base = c.be_base_ms * np.exp(c.be_sigma * rng.standard_normal(n))
        spikes = (rng.random(n) < c.be_spike_prob) * \
            c.be_spike_scale_ms * (rng.pareto(c.be_spike_alpha, n) + 1.0)
        return base + spikes

    def transport_qos(self, rng, n: int) -> np.ndarray:
        c = self.cfg
        jit = c.qos_base_ms * np.exp(c.qos_sigma * rng.standard_normal(n))
        return np.minimum(jit, c.qos_cap_ms)

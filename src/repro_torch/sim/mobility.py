"""§V mobility study (Fig. 4): interruption probability vs user speed.

Drives the REAL control-plane objects — AISession + MigrationController with
a VirtualClock — over a mobility trace, under two handover mechanisms:

* ``teardown``   — baseline: each handover tears the session down and
  re-establishes (DISCOVER→PAGE→PREPARE→COMMIT from scratch); the session is
  interrupted whenever the re-setup gap exceeds the tolerable gap.
* ``mbb``        — NE-AIaaS make-before-break migration: the target anchor is
  prepared and committed while the source keeps serving; interruption only
  if migration fails (state-transfer failure / deadline expiry) AND the
  source lease meanwhile lapses. Transfer is the closed-form wire model
  with injectable failures.
* ``mbb-plane``  — the same control plane, but every handover moves REAL
  session state through the sites' ServingPlane backends
  (export → fingerprint verify → import via ``state_transfer``), with
  export failures injected at the plane's injection points — the live
  data plane under ``VirtualClock``.

Handover events arrive as a Poisson process with rate v / cell_diameter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.asp import MobilityClass, default_asp
from repro_torch.core.clock import VirtualClock
from repro_torch.core.failures import SessionError
from repro_torch.core.orchestrator import Orchestrator


@dataclass
class MobilityResult:
    speed_kmh: float
    mechanism: str
    interruption_prob: float
    mean_gap_ms: float
    handovers_per_session: float


def simulate_mobility(speed_kmh: float, mechanism: str, *,
                      n_sessions: int = 60, window_s: float = 120.0,
                      cell_diameter_km: float = 0.8,
                      resetup_ms: float = 450.0,
                      tolerable_gap_ms: float = 150.0,
                      transfer_fail_prob: float = 0.02,
                      seed: int = 0) -> MobilityResult:
    rng = np.random.default_rng(seed + int(speed_kmh * 10))
    rate_per_s = (speed_kmh / 3600.0) / cell_diameter_km  # handovers / s
    interrupted = 0
    gaps = []
    total_handover = 0

    for s_idx in range(n_sessions):
        clock = VirtualClock()
        orch = Orchestrator(clock=clock)
        # make migration failures injectable & deterministic per session
        fail_draws = iter(rng.random(1024))

        asp = default_asp(mobility=MobilityClass.VEHICULAR)
        session = orch.establish(asp, invoker=f"ue-{s_idx}", zone="zone-a")

        if mechanism == "mbb-plane":
            # live data plane: serve once so the session has real state in
            # its plane backend, then inject export failures at the plane
            from repro_torch.serving.state_transfer import TransferInjections
            orch.serve(session, prompt_tokens=96, gen_tokens=16)

            def flaky_export(payload, _draws=fail_draws):
                if next(_draws) < transfer_fail_prob:
                    raise IOError("injected export failure")

            inj = TransferInjections(on_export=flaky_export)
            for site in orch.sites.values():
                orch.plane_for(site).migration_inject = inj
        else:
            def flaky_transfer(session, src, dst, _draws=fail_draws):
                if next(_draws) < transfer_fail_prob:
                    from repro_torch.core.failures import FailureCause
                    raise SessionError(FailureCause.STATE_TRANSFER_FAILURE,
                                       "injected transfer failure")
                return 0.040  # 40 ms of state movement

            orch.migrations.transfer_fn = flaky_transfer

        n_ho = rng.poisson(rate_per_s * window_s)
        total_handover += n_ho
        session_interrupted = False
        for _ in range(n_ho):
            if mechanism == "teardown":
                # teardown/re-establish: service gap = full re-setup time
                orch.release(session)
                clock.advance(resetup_ms / 1e3)
                gaps.append(resetup_ms)
                try:
                    session = orch.establish(asp, invoker=f"ue-{s_idx}",
                                             zone="zone-a")
                except SessionError:
                    session_interrupted = True
                    break
                if resetup_ms > tolerable_gap_ms:
                    session_interrupted = True
            else:  # make-before-break (closed-form or live plane transfer)
                out = orch.migrations.migrate(session, "zone-a")
                gaps.append(out.interruption_ms)
                if out.migrated:
                    # contract never left Committed(t): gap is 0
                    if out.interruption_ms > tolerable_gap_ms:
                        session_interrupted = True
                else:
                    # abort path keeps the source binding; interruption only
                    # if the source lease lapsed mid-migration
                    if not session.committed():
                        session_interrupted = True
        if session_interrupted:
            interrupted += 1

    return MobilityResult(
        speed_kmh=speed_kmh, mechanism=mechanism,
        interruption_prob=interrupted / n_sessions,
        mean_gap_ms=float(np.mean(gaps)) if gaps else 0.0,
        handovers_per_session=total_handover / n_sessions)

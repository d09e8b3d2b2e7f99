#!/usr/bin/env python3
"""``chip_smoke.py``'s distributed phase alone, on one CUDA card.

    python3 tools/dist_phase.py [--turns 5] [--no-dryrun]

Builds the kernels, checks decode_attention's lse output (``phase_lse``)
and runs ``phase_distributed``: minitron-8b's 4-layer train step on a 1x1
DTensor mesh of a one-rank NCCL group against the plain step from the
same seed (bit for bit, then ``--turns`` steps of each in turns), its
32-layer DTensor prefill and decode against the plain path's tokens, and
(unless ``--no-dryrun``) the two dry-run cells in subprocesses. The same
checks fail it as fail ``chip_smoke.py``. Run from this repository's root;
it prints the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=C.DIST_TURNS)
    ap.add_argument("--no-dryrun", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        C.fail("no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as DA
    from repro_torch.kernels.flash_attention import flash_attention as FA
    C.DIST_TURNS = args.turns
    t0 = time.perf_counter()
    C.phase_build()
    procs = [] if args.no_dryrun else C.start_dryruns()
    cfg = get_config("minitron-8b")
    C.phase_lse(cfg, get_config("qwen2-vl-72b"))
    C.phase_distributed(cfg, (DA, FA), procs)
    C.log(f"[dist_phase] {time.perf_counter() - t0:.1f} s")
    C.log(C.card())


if __name__ == "__main__":
    main()

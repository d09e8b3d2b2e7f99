#!/usr/bin/env python3
"""``chip_smoke.py``'s distributed phase alone, on one CUDA card.

    python3 tools/dist_phase.py [--turns 5] [--no-dryrun]

Builds the kernels, checks decode_attention's lse output (``phase_lse``)
and the expert and scan kernels at the local shapes of a 16-way model axis
(``phase_split_kernels``), and runs ``phase_distributed``: on a 1x1
DTensor mesh of a one-rank NCCL group, minitron-8b's and
qwen3-moe-30b-a3b's 4-layer, recurrentgemma-2b's 3-layer and
mamba2-1.3b's 4-layer train steps against the plain steps from the same
seed (bit for bit, then ``--turns`` steps of each in turns),
minitron-8b's 32-layer, qwen3-moe's 4-layer, int8 mixtral-8x7b's 4-layer,
recurrentgemma-2b's 26-layer and mamba2-1.3b's 48-layer DTensor prefill
and decode against the plain path's tokens, and (unless ``--no-dryrun``)
the dry-run cells in subprocesses. The same
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
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as DA
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    C.DIST_TURNS = args.turns
    t0 = time.perf_counter()
    C.phase_build()
    procs = [] if args.no_dryrun else C.start_dryruns()
    cfg = get_config("minitron-8b")
    moe_cfg = get_config("qwen3-moe-30b-a3b")
    mx_cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                                 serve_weight_dtype="int8")
    rg_cfg = get_config("recurrentgemma-2b")
    mb_cfg = get_config("mamba2-1.3b")
    C.phase_lse(cfg, get_config("qwen2-vl-72b"))
    C.phase_split_kernels(moe_cfg, mx_cfg, rg_cfg, mb_cfg)
    C.phase_distributed(cfg, (DA, FA, MG, RS, SC), procs, moe_cfg, mx_cfg,
                        rg_cfg, mb_cfg)
    C.log(f"[dist_phase] {time.perf_counter() - t0:.1f} s")
    C.log(C.card())


if __name__ == "__main__":
    main()

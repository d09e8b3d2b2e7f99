#!/usr/bin/env python3
"""Two checkouts' qwen3-moe-30b-a3b training step, in turns, on one CUDA
card.

    python3 tools/moe_train_ab.py parent=PATH change=PATH [--order 01100110]

Each ``LABEL=PATH`` names a checkout of this repository: its
``chip_smoke.py`` drives the training path (``drive_train`` at the
configuration ``moe_train_config`` picks: full width, 4 layers, sequence
4096, 2 microbatches, full remat) with its own ``src/repro_torch``, whose
kernels are built there at first use. ``--order`` lists the runs by their
argument's index (default parent, change, change, parent, twice); each run
is a fresh process and prints one ``[ab]`` JSON line: the wall ms of each
step but the first (3 on the data stream, 4 on one repeated batch), and
the profiled step's wall and device-busy ms. Then each label's median,
minimum and maximum step. The card's name and power limit come first. Run
from this repository's root; it needs one card.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path


def worker(label: str, path: Path) -> None:
    sys.path.insert(0, str(path / "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", path / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.configs import get_config
    cfg = smoke.moe_train_config(get_config("qwen3-moe-30b-a3b"))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = smoke.drive_train(cfg)
    text = log.getvalue()
    prof = re.search(r"wall ([\d.]+) ms/step \(profiled\), device busy "
                     r"([\d.]+) ms/step", text)
    steps = [ms for _, _, ms in out["steps"][1:] + out["repeat"][1:]]
    print("[ab] " + json.dumps({
        "label": label, "layers": cfg.num_layers, "steps_ms": steps,
        "profiled_wall_ms": float(prof.group(1)) if prof else None,
        "device_busy_ms": float(prof.group(2)) if prof else None}),
        flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", metavar="LABEL=PATH")
    ap.add_argument("--order", default="01100110")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    pairs = [r.split("=", 1) for r in args.runs]
    if args.worker:
        worker(pairs[0][0], Path(pairs[0][1]).resolve())
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    recs = []
    for i in args.order:
        label, path = pairs[int(i)]
        proc = subprocess.run(
            [sys.executable, __file__, f"{label}={path}", "--worker"],
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[ab] ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            raise SystemExit(f"run {label} failed ({proc.returncode})")
        print(lines[-1], flush=True)
        recs.append(json.loads(lines[-1][5:]))
    for label, _ in pairs:
        steps = [ms for r in recs if r["label"] == label
                 for ms in r["steps_ms"]]
        busy = [r["device_busy_ms"] for r in recs if r["label"] == label]
        if steps:
            print(f"{label:8} step ms: median {statistics.median(steps):.1f},"
                  f" min {min(steps):.1f}, max {max(steps):.1f} over "
                  f"{len(steps)} steps; profiled device busy ms/step "
                  + " ".join(f"{b:.2f}" for b in busy if b is not None),
                  flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Two checkouts' mamba2-1.3b prefill, in turns, on one CUDA card.

    python3 tools/prefill_ab.py parent=PATH change=PATH [--order 0110]
                                [--rounds 3]

Each ``LABEL=PATH`` names a checkout of this repository; its ``src/`` holds
the ``repro_torch`` that is measured (its ``ssd_chunk`` built there, at
first use, as the port does). ``--order`` lists the runs by their
argument's index (default parent, change, change, parent); each run is a
fresh process that draws mamba2-1.3b at full width and depth (random
weights from a seed) and prints one ``[ab]`` JSON line:

* ``ssd_device_ms``: ``ssd_chunk`` at the 2048-token prefill shape (b 1,
  nh 64, hp 64, n 128, Q 128, bf16 x/B/C, a non-zero S0), replayed from a
  CUDA graph;
* ``ttft_ms``: ``InferenceEngine.prefill_session`` of ``chip_smoke.py``'s
  8 engine prompts (528-1383 tokens; the three longest in the 2048
  bucket), ``--rounds`` times after one round to warm up;
* ``prefill``: one 1500-token prompt in the 2048 bucket through
  ``LM.prefill`` under torch.profiler: its wall ms, the device-busy ms and
  the ``ssd_chunk`` kernels' ms.

Then a table of each label's runs. The card's name and power limit come
first. Run from this repository's root; it needs one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def prefill_profile(cfg, params) -> dict:
    """Wall, device-busy and ssd_chunk ms of one profiled 1500-token
    prefill in the 2048 bucket (after one unprofiled)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import LM
    tokens = np.zeros((1, 2048), np.int32)
    tokens[0, :1500] = np.random.default_rng(5).integers(
        0, cfg.vocab_size, 1500)
    batch = {"tokens": torch.from_numpy(tokens).cuda(), "length": 1500}
    lm = LM(cfg)
    with torch.no_grad():
        lm.prefill(params, batch, 2048)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lm.prefill(params, batch, 2048)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3
           for e in kernels}
    return {"wall_ms": wall, "device_busy_ms": sum(dev.values()),
            "ssd_ms": sum(v for k, v in dev.items() if "ssd_" in k)}


def worker(label: str, path: Path, rounds: int) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs           # puts this checkout's src/ on the path
    sys.path.insert(0, str(path / "src"))
    import torch
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(
            path.resolve()):
        raise SystemExit(f"imported {repro_torch.__file__}, not from {path}")
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config("mamba2-1.3b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    nh, hp, g, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, \
        cfg.ssm_state

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(1, 2048, nh, hp).bfloat16()
    B, C = randn(1, 2048, g, n).bfloat16(), randn(1, 2048, g, n).bfloat16()
    dt = torch.rand((1, 2048, nh), generator=gen, device=dev) * 0.1
    A = -torch.arange(1, nh + 1, device=dev, dtype=torch.float32)
    S0 = randn(1, nh, hp, n)
    rec = {"label": label, "path": str(path),
           "ssd_device_ms": cs.graph_ms(lambda: SC.ssd_chunk(
               x, dt, A, B, C, S0, cfg.ssm_chunk), iters=10)}
    del x, B, C, dt, S0
    params = cs.init_model(cfg)
    lens, prompts = cs.engine_prompts(cfg)
    rec["prompt_lens"] = [int(v) for v in lens]
    rec["ttft_ms"] = []
    for r in range(rounds + 1):
        eng = InferenceEngine(cfg, params=params, slots=len(prompts),
                              max_len=2048, device="cuda")
        ttft = []
        for i, p in enumerate(prompts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.prefill_session(f"s{i}", p)       # ends in a host sync
            ttft.append((time.perf_counter() - t0) * 1e3)
        if r:                                     # round 0 warms up
            rec["ttft_ms"].append(ttft)
        del eng
        torch.cuda.empty_cache()
    rec["prefill"] = prefill_profile(cfg, params)
    print("[ab] " + json.dumps(rec), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", metavar="LABEL=PATH")
    ap.add_argument("--order", default="0110")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    pairs = [r.split("=", 1) for r in args.runs]
    if args.worker:
        worker(pairs[0][0], Path(pairs[0][1]), args.rounds)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    recs = []
    for i in args.order:
        label, path = pairs[int(i)]
        proc = subprocess.run(
            [sys.executable, __file__, f"{label}={path}", "--worker",
             "--rounds", str(args.rounds)],
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[ab] ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            raise SystemExit(f"run {label} failed ({proc.returncode})")
        print(lines[-1], flush=True)
        recs.append(json.loads(lines[-1][5:]))
    print(f"{'run':8} {'ssd replay ms':>13} {'TTFT 2048 bucket ms':>32} "
          f"{'prefill wall / device / ssd ms':>32}")
    for r in recs:
        long = [t[i] for t in r["ttft_ms"] for i, n in
                enumerate(r["prompt_lens"]) if n > 1024]
        p = r["prefill"]
        print(f"{r['label']:8} {r['ssd_device_ms']:13.4f} "
              f"{min(long):10.2f}-{max(long):.2f} (median "
              f"{statistics.median(long):.2f}) {p['wall_ms']:10.2f} / "
              f"{p['device_busy_ms']:.2f} / {p['ssd_ms']:.3f}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Two checkouts' prefill of one recurrent model, in turns, on one CUDA
card.

    python3 tools/prefill_ab.py parent=PATH change=PATH [--order 0110]
                                [--rounds 3] [--model mamba2-1.3b]

``--model`` is mamba2-1.3b (the default; its kernel ``ssd_chunk``) or
recurrentgemma-2b (its kernel ``rglru_scan``). Each ``LABEL=PATH`` names a
checkout of this repository; its ``src/`` holds the ``repro_torch`` that
is measured (its kernels built there, at first use, as the port does).
``--order`` lists the runs by their argument's index (default parent,
change, change, parent); each run is a fresh process that draws the model
at full width and depth (random weights from a seed) and prints one
``[ab]`` JSON line:

* ``kernel_device_ms``: the model's kernel at its 2048-token prefill
  shape, replayed from a CUDA graph: ``ssd_chunk`` at (b 1, nh 64, hp 64,
  n 128, Q 128, bf16 x/B/C, a non-zero S0), ``rglru_scan`` at (B 1, T
  2048, W 2560, a non-zero h0);
* ``host_us``: the host's time per call of the ``rglru_scan`` and
  ``flash_attention`` wrappers at small shapes (200 calls without a sync:
  the card keeps up, so this is the wrapper's host side);
* ``ttft_ms``: ``InferenceEngine.prefill_session`` of ``chip_smoke.py``'s
  8 engine prompts (528-1383 tokens; the three longest in the 2048
  bucket), ``--rounds`` times after one round to warm up;
* ``prefill``: one 1500-token prompt in the 2048 bucket through
  ``LM.prefill`` under torch.profiler: its wall ms, the device-busy ms and
  the model's kernel's ms.

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


#: model -> (its kernel, a substring of that kernel's device names)
KERNELS = {"mamba2-1.3b": ("ssd_chunk", "ssd_"),
           "recurrentgemma-2b": ("rglru_scan", "rglru")}


def prefill_profile(cfg, params, key: str) -> dict:
    """Wall, device-busy and kernel ms (device names holding ``key``) of
    one profiled 1500-token prefill in the 2048 bucket (after one
    unprofiled)."""
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
            "kernel_ms": sum(v for k, v in dev.items() if key in k)}


def kernel_device_ms(cs, cfg, gen) -> float:
    """The model's kernel at its 2048-token prefill shape, by CUDA-graph
    replay."""
    import torch
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if cfg.family == "hybrid":
        from repro_torch.kernels.rglru_scan import rglru_scan as RS
        W = cfg.lru_width
        a = torch.rand((1, 2048, W), generator=gen, device=dev) * 0.1 + 0.9
        b, h0 = randn(1, 2048, W) * 0.1, randn(1, W)
        return cs.graph_ms(lambda: RS.rglru_scan(a, b, h0), iters=10)
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    nh, hp, g, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, \
        cfg.ssm_state
    x = randn(1, 2048, nh, hp).bfloat16()
    B, C = randn(1, 2048, g, n).bfloat16(), randn(1, 2048, g, n).bfloat16()
    dt = torch.rand((1, 2048, nh), generator=gen, device=dev) * 0.1
    A = -torch.arange(1, nh + 1, device=dev, dtype=torch.float32)
    S0 = randn(1, nh, hp, n)
    return cs.graph_ms(lambda: SC.ssd_chunk(x, dt, A, B, C, S0,
                                            cfg.ssm_chunk), iters=10)


def wrapper_host_us(cs, gen) -> dict:
    """Host µs a call of the rglru_scan and flash_attention wrappers at
    small shapes."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    dev = torch.device("cuda")
    a = torch.rand((1, 64, 128), generator=gen, device=dev)
    b, h0 = torch.randn_like(a), torch.zeros((1, 128), device=dev)
    q = torch.randn((1, 64, 8, 64), generator=gen, device=dev).bfloat16()
    pos = torch.arange(64, device=dev, dtype=torch.int32)
    return {"rglru_scan": cs.host_us(lambda: RS.rglru_scan(a, b, h0)),
            "flash_attention": cs.host_us(lambda: FA.flash_attention(
                q, q, q, pos, pos, causal=True))}


def worker(label: str, path: Path, rounds: int, model: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs           # puts this checkout's src/ on the path
    sys.path.insert(0, str(path / "src"))
    import torch
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(
            path.resolve()):
        raise SystemExit(f"imported {repro_torch.__file__}, not from {path}")
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config(model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rec = {"label": label, "path": str(path), "model": model,
           "kernel": KERNELS[model][0],
           "kernel_device_ms": kernel_device_ms(cs, cfg, gen),
           "host_us": wrapper_host_us(cs, gen)}
    torch.cuda.empty_cache()
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
    rec["prefill"] = prefill_profile(cfg, params, KERNELS[model][1])
    print("[ab] " + json.dumps(rec), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", metavar="LABEL=PATH")
    ap.add_argument("--order", default="0110")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--model", choices=sorted(KERNELS), default="mamba2-1.3b")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    pairs = [r.split("=", 1) for r in args.runs]
    if args.worker:
        worker(pairs[0][0], Path(pairs[0][1]), args.rounds, args.model)
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
             "--rounds", str(args.rounds), "--model", args.model],
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[ab] ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            raise SystemExit(f"run {label} failed ({proc.returncode})")
        print(lines[-1], flush=True)
        recs.append(json.loads(lines[-1][5:]))
    name = KERNELS[args.model][0]
    print(f"{args.model}: {'run':8} {name + ' replay ms':>18} "
          f"{'TTFT 2048 bucket ms':>32} "
          f"{'prefill wall / device / ' + name + ' ms':>38} "
          f"{'host us rglru_scan / flash':>27}")
    for r in recs:
        long = [t[i] for t in r["ttft_ms"] for i, n in
                enumerate(r["prompt_lens"]) if n > 1024]
        p, h = r["prefill"], r["host_us"]
        print(f"{args.model}: {r['label']:8} {r['kernel_device_ms']:18.4f} "
              f"{min(long):10.2f}-{max(long):.2f} (median "
              f"{statistics.median(long):.2f}) {p['wall_ms']:16.2f} / "
              f"{p['device_busy_ms']:.2f} / {p['kernel_ms']:.3f} "
              f"{h['rglru_scan']:14.1f} / {h['flash_attention']:.1f}")


if __name__ == "__main__":
    main()

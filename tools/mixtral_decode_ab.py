#!/usr/bin/env python3
"""Two checkouts' int8 expert wrappers and mixtral-8x7b's int8 decode, in
turns, on one CUDA card.

    python3 tools/mixtral_decode_ab.py parent=PATH change=PATH
                                       [--order 01100110] [--rounds 3]

Each ``LABEL=PATH`` names a checkout of this repository; its ``src/`` holds
the ``repro_torch`` that is measured (kernels built there, at first use, as
the port does). ``--order`` lists the runs by their argument's index
(default parent, change, change, parent, twice); each run is a fresh
process and prints one ``[ab]`` JSON line:

* the int8 wrappers at mixtral-8x7b's decode shape (E 8, C 8; the fused
  gate/up D 4096 F 14336, the down product D 14336 F 4096, random int8
  weights from a seed): ``host_us``, the host's time a call over 200 calls
  issued without a sync, of the whole wrapper, of its Python checks
  (``_check`` and ``uses_int8``) and of the C launcher alone (called
  through ctypes with the wrapper's arguments: for the TMA design this
  holds the three tensor maps it encodes a call); ``replay_ms``, one call
  by CUDA-graph replay;
* mixtral-8x7b at full width and depth on int8 weights (random, from a
  seed): the 8 prompts of ``chip_smoke.py``'s mixtral path prefilled on an
  engine of 8 slots at max_len 8192 (TTFT of each), then ``--rounds``
  rounds of 64 decode steps in fused chunks of 16, each round's wall ms a
  step and tok/s, and one profiled round of 4 steps: device-busy ms a step
  and the expert kernels' share of it.

Then a table with each label's runs. The card's name and power limit come
first. Run from this repository's root; it needs one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HOST_CALLS = 200


def host_us(fn, calls: int = HOST_CALLS) -> float:
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def wrapper_times(cs, MG, build) -> tuple:
    """Host µs a call (wrapper, checks, C launcher) and replay ms of both
    int8 wrappers at C 8."""
    import torch
    from repro_torch.models.quant import quantize_weight
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def q8(shape):
        w = (torch.randn(shape, generator=gen, device=dev)
             * shape[1] ** -0.5).to(torch.bfloat16)
        return quantize_weight(w)

    E, D, Fd = 8, 4096, 14336
    wg, wu, wd = q8((E, D, Fd)), q8((E, D, Fd)), q8((E, Fd, D))
    host, replay = {}, {}
    for name, ws, din, fo in (("moe_ffn_fused", (wg, wu), D, Fd),
                              ("moe_gemm", (wd,), Fd, D)):
        x = torch.randn((E, 8, din), generator=gen, device=dev).bfloat16()
        fn = MG.moe_ffn_fused if name == "moe_ffn_fused" else MG.moe_gemm
        qs, ss = [w["q"] for w in ws], [w["s"] for w in ws]
        y = torch.empty((E, 8, fo), dtype=torch.bfloat16, device=dev)
        launcher = getattr(MG._library(), f"{name}_i8_launch")
        args = (x.data_ptr(), x.stride(0), x.stride(1),
                *[q.data_ptr() for q in qs], qs[0].stride(0),
                qs[0].stride(1), *[s.data_ptr() for s in ss],
                ss[0].stride(0), y.data_ptr(), E, 8, din, fo)
        host[name] = {
            "wrapper": host_us(lambda: fn(x, *ws)),
            "checks": host_us(lambda: (MG._check(x, qs, torch.int8),
                                       MG.uses_int8(x, *ws))),
            "launcher": host_us(
                lambda: build.call_on_stream(launcher, x, *args))}
        replay[name] = cs.graph_ms(lambda: fn(x, *ws))
    return host, replay


def device_split(prof, steps: int) -> dict:
    """Device-busy ms a step and the expert kernels' ms a step."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    experts = [e for e in events
               if any(k in e.key for k in ("tc::tc_kernel<", "i8::kernel<"))]
    return {"device_busy_ms": sum(map(dev_us, events)) / steps / 1e3,
            "experts_ms": sum(map(dev_us, experts)) / steps / 1e3,
            "expert_launches": sum(e.count for e in experts) // steps}


def worker(label: str, path: Path, rounds: int) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs           # puts this checkout's src/ on the path
    sys.path.insert(0, str(path / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(
            path.resolve()):
        raise SystemExit(f"imported {repro_torch.__file__}, not from {path}")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    from repro_torch.serving.engine import InferenceEngine
    build.build_all(["moe_gemm"])
    host, replay = wrapper_times(cs, MG, build)
    rec = {"label": label, "path": str(path), "host_us": host,
           "replay_ms": replay, "ttft_ms": [], "decode": []}
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              serve_weight_dtype="int8")
    params = cs.init_model(cfg)
    eng = InferenceEngine(cfg, params=params, slots=8,
                          max_len=cs.MIXTRAL_MAX_LEN, device="cuda")
    for i, p in enumerate(cs.mixtral_prompts(cfg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill_session(f"s{i}", p)        # ends in a host sync
        rec["ttft_ms"].append((time.perf_counter() - t0) * 1e3)
    eng.decode_round(steps=4)                  # warm
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            eng.decode_round(steps=16)         # ends in a D2H
        dt = time.perf_counter() - t0
        rec["decode"].append({"ms_step": dt / 64 * 1e3,
                              "tok_s": 8 * 64 / dt})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode_round(steps=4)
        wall = time.perf_counter() - t0
    rec["profiled"] = {"wall_ms": wall / 4 * 1e3, **device_split(prof, 4)}
    print("[ab] " + json.dumps(rec), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", metavar="LABEL=PATH")
    ap.add_argument("--order", default="01100110")
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
    print(f"{'run':8} {'kernel':14} {'wrapper us':>10} {'checks us':>10} "
          f"{'launcher us':>11} {'replay ms':>10}")
    for r in recs:
        for name, h in r["host_us"].items():
            print(f"{r['label']:8} {name:14} {h['wrapper']:10.1f} "
                  f"{h['checks']:10.1f} {h['launcher']:11.1f} "
                  f"{r['replay_ms'][name]:10.4f}")
    for r in recs:
        p = r["profiled"]
        print(f"{r['label']:8} mixtral decode ms/step "
              + " ".join(f"{d['ms_step']:.2f}" for d in r["decode"])
              + " (tok/s " + " ".join(f"{d['tok_s']:.1f}"
                                      for d in r["decode"])
              + f"); profiled: wall {p['wall_ms']:.2f}, device busy "
              f"{p['device_busy_ms']:.2f}, experts {p['experts_ms']:.2f} ms/"
              f"step in {p['expert_launches']} launches; TTFT ms "
              + " ".join(f"{t:.0f}" for t in r["ttft_ms"]))
    for label, _ in pairs:
        steps = [d["ms_step"] for r in recs if r["label"] == label
                 for d in r["decode"]]
        if steps:
            print(f"{label:8} mixtral decode ms/step: median "
                  f"{statistics.median(steps):.2f}, min {min(steps):.2f}, "
                  f"max {max(steps):.2f} over {len(steps)} rounds")


if __name__ == "__main__":
    main()

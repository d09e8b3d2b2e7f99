#!/usr/bin/env python3
"""Two checkouts' decode attention and minitron-8b decode, in turns, on one
CUDA card.

    python3 tools/decode_ab.py parent=PATH change=PATH [--order 0110]
                               [--rounds 2]

Each ``LABEL=PATH`` names a checkout of this repository; its ``src/`` holds
the ``repro_torch`` that is measured (kernels built there, at first use, as
the port does). ``--order`` lists the runs by their argument's index
(default parent, change, change, parent); each run is a fresh process and
prints one ``[ab]`` JSON line:

* the decode-attention wrappers at minitron-8b's decode shape (B 8, Hq 32,
  Hkv 8, D 128, S 2048, lengths 1 ... 2048, bf16; paged: page 128 through
  a shuffled block table; 4 input sets in rotation, as ``chip_smoke.py``
  times them): ``ms``, eager calls back to back (host side included);
  ``device_ms``, the same calls replayed from a CUDA graph; ``host_us``,
  the host's time per call over 200 calls issued without a sync (the card
  keeps up, so this is the wrapper's host side); SDPA on the dense views
  measured the same three ways; and ``host_parts``, the host's time per
  call of each step a wrapper's host side takes (its input checks, an
  allocation, the device guard, reading the current stream), over 2000
  calls each;
* minitron-8b (full width and depth, random weights from a seed): decode
  tok/s of the dense and the paged engine, 8 slots with
  ``chip_smoke.py``'s prompts, 64 steps in fused chunks of 16; ``--rounds``
  rounds of dense then paged (0: no engine).

Then a table with each label's runs. The card's name and power limit come
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
HOST_CALLS = 200


def host_us(fn, calls: int = HOST_CALLS) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def kernel_times(cs, DA) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    S, page, Hkv, g, D = 2048, 128, 8, 4, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    lens_host = np.array([1, S - 1, S, 517, 1024, 1500, 129, 64], np.int32)
    B = len(lens_host)
    tables, P = cs.decode_table(lens_host, S, page, seed=7)
    lengths = torch.from_numpy(lens_host).to(dev)
    tbl = torch.from_numpy(tables).to(dev)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    sets = [cs.decode_inputs(gen, B, Hkv, g, D, S, torch.bfloat16, tables,
                             P, page) for _ in range(4)]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]

    def dense():
        x = nxt()
        return DA.decode_attention(x["q"], x["k"], x["v"], lengths)

    def paged():
        x = nxt()
        return DA.paged_decode_attention(x["q"], x["pk"], x["pv"], lengths,
                                         tbl)

    def sdpa():
        x = nxt()
        return F.scaled_dot_product_attention(
            x["q"][:, :, None], x["k"], x["v"], attn_mask=mask,
            enable_gqa=True)

    def guard():
        with torch.cuda.device(dev):
            pass

    x, idx = sets[0], torch.cuda.current_device()
    parts = {name: host_us(fn, 2000) for name, fn in (
        ("check", lambda: DA._check_common(x["q"], x["k"], x["v"], lengths,
                                           B, Hkv)),
        ("empty", lambda: torch.empty((B, Hkv * g, D), dtype=torch.bfloat16,
                                      device=dev)),
        ("device_guard", guard),
        ("current_device", torch.cuda.current_device),
        ("current_stream", lambda: torch.cuda.current_stream(dev)
         .cuda_stream),
        ("raw_stream", lambda: torch._C._cuda_getCurrentRawStream(idx)))}
    out = {}
    for name, fn in (("decode_attention", dense),
                     ("paged_decode_attention", paged), ("sdpa", sdpa)):
        out[name] = {"ms": cs.time_ms(fn), "device_ms": cs.graph_ms(fn),
                     "host_us": host_us(fn)}
    return out, parts


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
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention as DA
    build.build_all()
    times, parts = kernel_times(cs, DA)
    rec = {"label": label, "path": str(path), "kernels": times,
           "host_parts": parts, "tok_s": {"dense": [], "paged": []}}
    if rounds:
        cfg = get_config("minitron-8b")
        params = cs.init_model(cfg)
        _, prompts = cs.engine_prompts(cfg)
    for _ in range(rounds):
        for paged in (False, True):
            rec["tok_s"]["paged" if paged else "dense"].append(
                cs.run_engine(cfg, params, prompts, paged=paged, steps=64,
                              chunk=16, profile=False)[2])
            torch.cuda.empty_cache()
    print("[ab] " + json.dumps(rec), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", metavar="LABEL=PATH")
    ap.add_argument("--order", default="0110")
    ap.add_argument("--rounds", type=int, default=2)
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
    print(f"{'run':8} {'kernel':24} {'ms':>8} {'device_ms':>10} "
          f"{'host_us':>8}")
    for r in recs:
        for name, k in r["kernels"].items():
            print(f"{r['label']:8} {name:24} {k['ms']:8.4f} "
                  f"{k['device_ms']:10.4f} {k['host_us']:8.1f}")
    for r in recs:
        print(f"{r['label']:8} host us per call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in r["host_parts"].items()))
    for label, _ in pairs if args.rounds else ():
        for layout in ("dense", "paged"):
            tps = [t for r in recs if r["label"] == label
                   for t in r["tok_s"][layout]]
            print(f"{label:8} minitron-8b {layout} decode tok/s: mean "
                  f"{statistics.mean(tps):.1f}, median "
                  f"{statistics.median(tps):.1f} over {len(tps)} runs")
    for r in recs:
        print(f"{r['label']:8} minitron-8b decode tok/s: dense "
              f"{' '.join(f'{t:.1f}' for t in r['tok_s']['dense'])}, paged "
              f"{' '.join(f'{t:.1f}' for t in r['tok_s']['paged'])}")


if __name__ == "__main__":
    main()

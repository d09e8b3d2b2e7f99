#!/usr/bin/env python3
"""The SSD backward (``ssd_chunk_bwd``: three kernels) against the parent
tree's, with the tensor-core route's design choices undone one at a time,
and mamba2-1.3b's training step parent against change, on one CUDA card.

    mkdir -p _checkout/parent && git archive HEAD | tar -x -C _checkout/parent
    python3 tools/ssd_bwd_ab.py [--parent _checkout/parent] [--rounds 2]
                                [--only tree ...] [--step-order 01100110]
                                [--no-kernels] [--no-step]

Kernels, in this one process: the parent's ``ssd_chunk_bwd.cu`` (with its
own ``kernels/`` on the include path), this tree's, and this tree's with
one choice undone (``EDITS``: slices of 1, 2 or 4 heads of a group instead
of 8; the states' next chunk waited for as soon as it is issued instead of
landing under this chunk's products) are built by ``nvcc`` all at once
into the git-ignored ``src/repro_torch/kernels/_build/``, their ptxas lines
printed. Each is loaded in turn into the wrapper, held to the plain
backward (bf16 at mamba2-1.3b's train microbatch: b 1, l 4096, nh 64, hp
64, n 128, g 1, Q 128, the forward's states kept; the card's tolerances of
``chip_smoke.py``) and timed by CUDA-graph replay (10 calls captured,
inputs rotating over two sets) in rounds that go parent, tree, variants
and back. Two choices have no variant: ``wgmma`` in place of
``mma.sync`` (none was written) and two blocks an SM (a chunk block holds
215 KB of shared memory). ``--only`` keeps a named variant.

Step: each ``--step-order`` digit runs a fresh process on the parent (0)
or this tree (1) that drives ``chip_smoke.drive_train`` of its own
checkout at ``recurrent_train_config(mamba2-1.3b)`` (full width, all 48
layers, sequence 4096, 2 microbatches, full remat) and prints one
``[ab]`` JSON line: each step's wall ms but the first, the profiled step's
wall and device-busy ms and its ``ssd_chunk_bwd`` ms. Then each side's
median, minimum and maximum step. The card's name and power limit come
first. A run's host can be 1.3-2.2x slower than another call's: compare
only within one call. A variant whose edit no longer matches the source
stops the run.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import io
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KERNELS = Path("src/repro_torch/kernels")
SRC = ROOT / KERNELS / "ssd_chunk/csrc/ssd_chunk_bwd.cu"

#: variant -> [(text in the source, its replacement)]
EDITS = {
    "slices of 1 head (8 kept)": [
        ("constexpr int kSliceHeads = 8;", "constexpr int kSliceHeads = 1;")],
    "slices of 2 heads (8 kept)": [
        ("constexpr int kSliceHeads = 8;", "constexpr int kSliceHeads = 2;")],
    "slices of 4 heads (8 kept)": [
        ("constexpr int kSliceHeads = 8;", "constexpr int kSliceHeads = 4;")],
    "states_bwd: the next chunk's copies waited for at once (in flight "
    "under this chunk kept)": [
        ("    if (c > 0) stage_chunk(c - 1, buf ^ 1);          // lands "
         "meanwhile\n",
         "    if (c > 0) {\n      stage_chunk(c - 1, buf ^ 1);\n"
         "      cp_wait_all();\n    }\n")],
}

SHAPE = dict(b=1, l=4096, nh=64, hp=64, g=1, n=128, Q=128)
#: chip_smoke.py's tolerances: dx, ddt, dA, dB, dC, dS0 (bf16 outputs
#: 1e-2 of the largest magnitude, f32 1e-4, dA 2e-4)
TOLS = (1e-2, 1e-4, 2e-4, 1e-2, 1e-2, 1e-4)


def variants() -> dict:
    """This tree's source and each variant's text; exits where an edit
    does not match the source exactly once."""
    src = SRC.read_text()
    out = {"tree": src}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"ssd_bwd_ab: the edit {old[:200]!r} of {name!r} "
                         f"no longer matches {SRC.name}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(parent: Path, only=()) -> dict:
    """One shared library per source, all nvcc runs at once (the parent's
    with its own headers); prints each one's ptxas lines."""
    from repro_torch.kernels.build import (BUILD_DIR, NVCC_FLAGS, nvcc_path,
                                           source_key)
    psrc = parent / KERNELS / "ssd_chunk/csrc/ssd_chunk_bwd.cu"
    if not psrc.exists():
        sys.exit(f"ssd_bwd_ab: no parent source at {psrc}")
    jobs = {"parent": (psrc.read_text(), parent / KERNELS)}
    for name, text in variants().items():
        if not only or name in only:
            jobs[name] = (text, ROOT / KERNELS)
    procs, libs = [], {}
    for name, (text, inc) in jobs.items():
        d = BUILD_DIR / f"ssd_bwd_ab-{source_key(text + str(inc))}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "ssd_chunk_bwd.cu").write_text(text)
        libs[name] = d / "libssd_bwd_ab.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(inc), "-o",
               str(libs[name]), str(d / "ssd_chunk_bwd.cu")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"ssd_bwd_ab: nvcc failed for {name!r}:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line or "C75" in line:
                m = re.search(r"(tc\d+\w+?_bwd|ssd_\w+?)E", entry)
                if m:
                    print(f"[ssd_bwd_ab] {name}: {m.group(1)} "
                          f"{line.strip()[:110]}", flush=True)
    return libs


def use(path: str, parent: bool) -> None:
    """Load the library at ``path`` into the wrapper; the parent's has no
    shares count (a share a head)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    lib = ctypes.CDLL(path)
    lib.ssd_chunk_bwd_launch.argtypes = SC._BWD_ARGTYPES
    lib.ssd_chunk_bwd_launch.restype = ctypes.c_int
    if parent:
        lib.ssd_chunk_bwd_shares = lambda code, nh, hp, g: nh
    else:
        lib.ssd_chunk_bwd_shares.argtypes = [ctypes.c_int] * 4
        lib.ssd_chunk_bwd_shares.restype = ctypes.c_int
    SC._bwd_lib = lib
    SC._bwd_shares.cache_clear()


def graph_ms(torch, fn, iters: int = 10, reps: int = 5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def kernels(args) -> None:
    import torch
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    libs = build(Path(args.parent).resolve(), args.only)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    b, l, nh, hp, g, n, Q = (SHAPE[k] for k in "b l nh hp g n Q".split())

    def inputs():
        r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa
        t = {"x": r(b, l, nh, hp).bfloat16(),
             "dt": torch.rand((b, l, nh), generator=gen, device=dev) * 0.099
             + 1e-3,
             "A": -torch.arange(1, nh + 1, device=dev, dtype=torch.float32),
             "B": r(b, l, g, n).bfloat16(), "C": r(b, l, g, n).bfloat16(),
             "S0": r(b, nh, hp, n), "dy": r(b, l, nh, hp),
             "dS": r(b, nh, hp, n)}
        fa = [t[k] for k in ("x", "dt", "A", "B", "C", "S0")]
        t["ws"] = SC._forward(*fa, Q)[2]
        return t

    def call(t):
        return SC.ssd_chunk_bwd(t["x"], t["dt"], t["A"], t["B"], t["C"],
                                t["S0"], t["dy"], t["dS"], Q, ws=t["ws"])

    sets = [inputs() for _ in range(2)]
    want = SC.ssd_chunk_bwd_ref(*(sets[0][k].float() for k in (
        "x", "dt", "A", "B", "C", "S0", "dy", "dS")), Q)
    for name, lib in libs.items():
        use(str(lib), name == "parent")
        got = call(sets[0])
        rel = [float((x.float() - w).abs().max() / w.abs().max())
               for x, w in zip(got, want)]
        ok = all(r <= t for r, t in zip(rel, TOLS)) and all(
            bool(torch.isfinite(x).all()) for x in got)
        print(f"[ssd_bwd_ab] {name}: {'within' if ok else 'OUTSIDE'} the "
              f"tolerances of the plain backward (err / max "
              + " ".join(f"{r:.2e}" for r in rel) + ")", flush=True)
        del got
    order = list(libs)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            use(str(libs[name]), name == "parent")
            it = {"i": 0}

            def nxt():
                it["i"] ^= 1
                return call(sets[it["i"]])
            print(f"[ssd_bwd_ab] round {r} {name}: {graph_ms(torch, nxt):.4f}"
                  f" ms by replay", flush=True)


def step_worker(label: str, path: Path) -> None:
    sys.path.insert(0, str(path / "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", path / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.configs import get_config
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        cfg = smoke.recurrent_train_config(get_config("mamba2-1.3b"))
        out = smoke.drive_train(cfg)
    text = log.getvalue()
    prof = re.search(r"wall ([\d.]+) ms/step \(profiled\), device busy "
                     r"([\d.]+) ms/step", text)
    ssd = re.search(r": ssd_chunk_bwd ([\d.]+) ms/step", text)
    steps = [ms for _, _, ms in out["steps"][1:] + out["repeat"][1:]]
    print("[ab] " + json.dumps({
        "label": label, "layers": cfg.num_layers, "steps_ms": steps,
        "profiled_wall_ms": float(prof.group(1)) if prof else None,
        "device_busy_ms": float(prof.group(2)) if prof else None,
        "ssd_chunk_bwd_ms": float(ssd.group(1)) if ssd else None}),
        flush=True)


def step(args) -> None:
    pairs = [("parent", Path(args.parent).resolve()), ("change", ROOT)]
    recs = []
    for i in args.step_order:
        label, path = pairs[int(i)]
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", f"{label}={path}"],
            capture_output=True, text=True, timeout=1200)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[ab] ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            raise SystemExit(f"run {label} failed ({proc.returncode})")
        print(lines[-1], flush=True)
        recs.append(json.loads(lines[-1][5:]))
    for label, _ in pairs:
        mine = [r for r in recs if r["label"] == label]
        steps = [ms for r in mine for ms in r["steps_ms"]]
        if steps:
            print(f"{label:8} step ms: median {statistics.median(steps):.1f}"
                  f", min {min(steps):.1f}, max {max(steps):.1f} over "
                  f"{len(steps)} steps; profiled device busy ms/step "
                  + " ".join(f"{r['device_busy_ms']}" for r in mine)
                  + "; ssd_chunk_bwd ms/step "
                  + " ".join(f"{r['ssd_chunk_bwd_ms']}" for r in mine),
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="_checkout/parent")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", action="append", default=[],
                    help="a variant to keep (tree: this tree's source), "
                         "once for each; all by default")
    ap.add_argument("--step-order", default="01100110")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--no-step", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        label, path = args.worker.split("=", 1)
        step_worker(label, Path(path))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if not args.no_kernels:
        kernels(args)
    if not args.no_step:
        step(args)


if __name__ == "__main__":
    main()

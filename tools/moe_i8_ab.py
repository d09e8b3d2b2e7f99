#!/usr/bin/env python3
"""Design choices of the grouped expert GEMMs' int8-weight variant, on one
CUDA card.

    python3 tools/moe_i8_ab.py [--rounds 2]

Builds variants of ``src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu``,
each with one choice of the int8 variant (namespace ``i8``) undone, all
``nvcc`` runs started together, into the git-ignored
``src/repro_torch/kernels/_build/``, and prints the ptxas lines (registers,
spills, C7512 and other notes) of their int8 kernels. A variant is a few
text edits of the source (``EDITS``) or a patch beside this file
(``PATCHES``: placement (ii), A dequantised into a 128-byte-swizzled bf16
tile in shared memory that wgmma reads by descriptor). Then, in rounds
(whole, variants, whole, variants) in this one process, it loads each
variant's library into the wrappers in turn: the bits of both kernels
against the tensor-core variant on ``as_weight(w)`` at ragged shapes (D
off a stage, F off a tile, C 1-300) and at each of mixtral-8x7b's four
expert shapes (E 8; gate/up D 4096 F 14336, down D 14336 F 4096; C 8 and
640), then the time of one call at those four shapes by CUDA-graph replay
(20 calls captured, one weight set: each int8 matrix, 470 MB, streams past
the 50 MB L2), and the wrapper's host time a call at C 8. The first run
of the whole source also prints the bit probe (``moe_gemm.i8_probe``).
The card's name and power limit come first. A variant whose edit or patch
no longer matches the source stops the run: bring it up to date with the
kernel (a patch: ``diff -u`` of the source and the edited copy).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SRC = ROOT / "src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu"

#: variant -> [(text in the source, its replacement)]
EDITS = {
    "ring of 4 stages at decode, 3 at prefill (6, 4 kept)": [
        ("kDecodeStages = 6;", "kDecodeStages = 4;"),
        ("kPrefillStages = 4;", "kPrefillStages = 3;")],
    "decode stage rows 128 fused / 64 down (64 / 128 kept)": [
        ("kFusedDecodeRows = 64;", "kFusedDecodeRows = 128;"),
        ("kDownDecodeRows = 128;", "kDownDecodeRows = 64;")],
    "C > 64: 160 rows a block (320 kept)": [
        ("return launch<kFused, 1, 160, 2, 64, kPrefillStages>(a);",
         "return launch<kFused, kW, 160, 1, 64, kPrefillStages>(a);")],
}

#: variant -> a unified diff of the source, beside this file
PATCHES = {
    "A from a bf16 tile in shared memory (placement ii)":
        "moe_i8_ab_smem_a.diff",
}

RAGGED = ((3, 1, 48, 144), (5, 9, 64, 80), (4, 9, 16, 16), (3, 161, 48, 80),
          (2, 300, 16, 144), (5, 40, 2048, 768), (2, 70, 24, 16))


def hunks(diff: str) -> list:
    """The (old, new) text of each hunk of a unified diff: its context and
    removed lines, its context and added lines."""
    out = []
    for hunk in re.split(r"^@@[^\n]*@@\n", diff, flags=re.M)[1:]:
        old, new = [], []
        for line in hunk.splitlines(keepends=True):
            if line.startswith((" ", "-")):
                old.append(line[1:])
            if line.startswith((" ", "+")):
                new.append(line[1:])
        out.append(("".join(old), "".join(new)))
    return out


def variants() -> dict:
    """The whole source and each variant's text; exits where an edit or a
    hunk does not match the source exactly once."""
    src = SRC.read_text()
    out = {"whole": src}
    changes = dict(EDITS)
    for name, diff in PATCHES.items():
        changes[name] = hunks((Path(__file__).parent / diff).read_text())
    for name, edits in changes.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"moe_i8_ab: the edit {old[:200]!r} of {name!r} "
                         f"no longer matches {SRC.name}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict) -> dict:
    """One shared library per variant, all nvcc runs at once; prints the
    ptxas lines of each variant's int8 kernels."""
    from repro_torch.kernels.build import BUILD_DIR, nvcc_cmd, source_key
    procs, libs = [], {}
    for name, text in sources.items():
        d = BUILD_DIR / f"moe_i8_ab-{source_key(text)}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "moe_gemm.cu").write_text(text)
        libs[name] = d / "libmoe_i8_ab.so"
        procs.append((name, subprocess.Popen(
            nvcc_cmd(d / "moe_gemm.cu", libs[name]), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"moe_i8_ab: nvcc failed for {name!r}:\n{log}")
        entry, notes = "", {}
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "C75" in line:
                code = re.search(r"C75\d\d", line).group(0)
                if code not in notes:
                    print(f"[moe_i8_ab] {name}: {line.strip()[:200]}",
                          flush=True)
                notes[code] = notes.get(code, 0) + 1
            elif ("registers" in line or "spill" in line) \
                    and "2i86kernel" in entry:
                m = re.search(r"2i86kernelI(\w+?)EEv", entry)
                print(f"[moe_i8_ab] {name}: kernel<{m.group(1) if m else '?'}"
                      f"> {line.strip()[:110]}", flush=True)
        print(f"[moe_i8_ab] {name}: ptxas notes {notes or 'none'}", flush=True)
    return libs


def run(lib_path: str, label: str, probe: bool) -> None:
    """One variant: its library in the wrappers, the bits, the times; one
    line."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    from repro_torch.models.quant import as_weight, quantize_weight
    lib = ctypes.CDLL(lib_path)
    for fn, args in MG._ARGTYPES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.moe_gemm_narrow_ws_floats.argtypes = [ctypes.c_int] * 4
    lib.moe_gemm_narrow_ws_floats.restype = ctypes.c_longlong
    MG._lib = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def q8(shape):
        w = randn(shape, shape[1] ** -0.5)
        w[:, :, 1] = 0
        return quantize_weight(w)

    def call(name, x, ws):
        fn = MG.moe_ffn_fused if name == "moe_ffn_fused" else MG.moe_gemm
        return fn(x, *ws)

    def graph_ms(fn, iters=20, reps=5):
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
        return start.elapsed_time(end) / (reps * iters)

    if probe:
        steps = 4096
        pa = (torch.randn((steps, 64, 16), generator=gen, device=dev)
              * torch.exp2(torch.randint(-8, 9, (steps, 64, 1),
                                         generator=gen, device=dev).float())
              ).bfloat16()
        pb = torch.randn((steps, 256, 16), generator=gen, device=dev
                         ).bfloat16()
        out = MG.i8_probe(pa, pb)
        torch.cuda.synchronize()
        print("[moe_i8_ab] probe (%d k16 steps): " % steps + "; ".join(
            f"{what} {'!=' if d else '=='} mma.sync ({d} of {64 * n} "
            f"differ)" for (what, n), d in zip(MG.PROBE_WAYS,
                                               MG.probe_differ(out))),
            flush=True)

    bad = []
    for Eo, Co, Do, Fo in RAGGED:
        xo = randn((Eo, Co + 3, Do))[:, 3:]
        xo[0] = 0
        g8, u8 = q8((Eo, Do, Fo)), q8((Eo, Do, Fo))
        for name, ws in (("moe_ffn_fused", (g8, u8)), ("moe_gemm", (g8,))):
            got = call(name, xo, ws)
            ref = call(name, xo, [as_weight(w) for w in ws])
            if not torch.equal(got, ref):
                bad.append(f"{name} E {Eo} C {Co} D {Do} F {Fo} "
                           f"({int((got != ref).sum())} differ)")
    def host_us(fn, calls=200):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / calls * 1e6

    E, D, Fd = 8, 4096, 14336
    wg, wu, wd = q8((E, D, Fd)), q8((E, D, Fd)), q8((E, Fd, D))
    parts, host = [], []
    for name, C in (("moe_ffn_fused", 8), ("moe_gemm", 8),
                    ("moe_ffn_fused", 640), ("moe_gemm", 640)):
        fused = name == "moe_ffn_fused"
        x = randn((E, C, D if fused else Fd))
        ws = (wg, wu) if fused else (wd,)
        got = call(name, x, ws)
        ref = call(name, x, [as_weight(w) for w in ws])
        if not torch.equal(got, ref):
            bad.append(f"{name} C {C} ({int((got != ref).sum())} differ)")
        del ref
        parts.append(f"{name} C {C} {graph_ms(lambda: call(name, x, ws)):.4f}")
        if C == 8:
            qs = [w["q"] for w in ws]
            checks = host_us(lambda: (MG._check(x, qs, torch.int8),
                                      MG.uses_int8(x, *ws)))
            host.append(f"{name} {host_us(lambda: call(name, x, ws)):.1f} "
                        f"(checks {checks:.1f})")
    torch.cuda.synchronize()
    print(f"[moe_i8_ab] {label}: " + "; ".join(parts) + " ms; bits "
          + ("== the tensor-core variant on as_weight(w) at "
             f"{2 * len(RAGGED)} ragged cases and the 4 mixtral shapes"
             if not bad else "DIFFER: " + ", ".join(bad))
          + "; wrapper host us a call at C 8: " + ", ".join(host), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("moe_i8_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build(variants())
    for r in range(args.rounds):
        for label, lib in libs.items():
            run(str(lib), label, probe=r == 0 and label == "whole")


if __name__ == "__main__":
    main()

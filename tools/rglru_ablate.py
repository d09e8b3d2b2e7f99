#!/usr/bin/env python3
"""Where the time of ``rglru_scan`` goes, on one CUDA card.

    python3 tools/rglru_ablate.py

Builds variants of ``src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu``
(all ``nvcc`` runs started together, into the git-ignored
``src/repro_torch/kernels/_build/``): the source as it is; other tile
shapes, occupancy, cache hints and fold staging, whose outputs are held to
the plain version (max abs error printed, ``RG_TOL`` 1e-5); and cuts, with
one part of the kernel taken out (their outputs are wrong; only their
times count). Each line carries the float4 path's ptxas registers and
spill stores. Then
it calls each variant's launcher at recurrentgemma-2b's 2048-token
prefill shape (B 1, T 2048, W 2560, f32, a non-zero h0) and prints, one
line per variant, the kernel's and the memset's device time per call
(torch.profiler over 20 calls) and the call's time by CUDA-graph replay.
The card's name and power limit come first. A variant whose text no
longer matches the source stops the run: edit it here with the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SRC = ROOT / "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu"

_WARPS, _STEPS = "constexpr int kWarps = 8;", "constexpr int kSteps = 8;"


def _shape(warps: int, steps: int):
    return [(_WARPS, f"constexpr int kWarps = {warps};"),
            (_STEPS, f"constexpr int kSteps = {steps};")]


#: variant -> (True if its output must still be right, [(text, replacement)])
VARIANTS = {
    "4 warps x 16 steps (chunk 64)": (True, _shape(4, 16)),
    "4 warps x 8 steps (chunk 32)": (True, _shape(4, 8)),
    "3 blocks an SM (launch bounds)": (True, [(
        "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")]),
    "default cache policy (no .cs)": (True, [
        ("stream ? __ldcs(p) : __ldg(p)", "__ldg(p)"),
        ("__stcs(reinterpret_cast<float4*>(row + w), v);",
         "*reinterpret_cast<float4*>(row + w) = v;")]),
    "fold staging 8 chunks at a time": (True, [(
        "constexpr int kStage = 32;", "constexpr int kStage = 8;")]),
    "cut: no carry fold": (False, [(
        "for (int j = 0; j < c;) {", "for (int j = 0; j < 0;) {")]),
    "cut: no waits for earlier chunks": (False, [(
        "const int ready = min(clear ? __ffsll(clear) - 1 : 64, c - j);",
        "const int ready = c - j;")]),
    "cut: no warp composition": (False, [(
        "    if (warp > 0) {\n      float4 pw",
        "    if (false) {\n      float4 pw")]),
    "cut: no stores": (False, [(
        "      if (t0 + s < g.T)\n        store4<kVec>(",
        "      if (false)\n        store4<kVec>(")]),
    "cut: scalar edge path at every W": (False, [(
        "const bool vec = W % 4 == 0 &&", "const bool vec = false &&")]),
}


def variants() -> dict:
    src = SRC.read_text()
    out = {"whole": (True, src)}
    for name, (right, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                sys.exit(f"rglru_ablate: {name!r} no longer matches "
                         f"{SRC.name}: {old!r}")
            text = text.replace(old, new)
        out[name] = (right, text)
    return out


def build(sources: dict) -> dict:
    """One shared library per variant, all nvcc runs at once."""
    from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc_path
    procs, libs = [], {}
    for name, (_, text) in sources.items():
        key = hashlib.sha256(text.encode()).hexdigest()[:16]
        d = BUILD_DIR / f"rglru_ablate-{key}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "rglru_scan.cu").write_text(text)
        libs[name] = d / "librglru_ablate.so"
        if not libs[name].exists():
            procs.append((name, d, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(libs[name]),
                 str(d / "rglru_scan.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for name, d, proc in procs:
        log, _ = proc.communicate()
        (d / "build.log").write_text(log)
        if proc.returncode != 0:
            sys.exit(f"rglru_ablate: nvcc failed for {name!r}:\n{log}")
    return libs


def ptxas(lib: Path) -> str:
    """Registers and spill stores of the float4 path, from its build."""
    import re
    log = (lib.parent / "build.log").read_text()
    entry, regs, spills = "", "?", "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "ILb1E" in entry:
            m = re.search(r"Used (\d+) registers", line)
            regs = m.group(1) if m else regs
            m = re.search(r"(\d+) bytes spill stores", line)
            spills = m.group(1) if m else spills
    return f"{regs} registers, {spills} B spill stores"


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    if not torch.cuda.is_available():
        sys.exit("rglru_ablate: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    sources = variants()
    libs = build(sources)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, T, W = 1, 2048, 2560
    a = torch.rand((B, T, W), generator=gen, device=dev) * 0.1 + 0.9
    b = torch.randn((B, T, W), generator=gen, device=dev) * 0.1
    h0 = torch.randn((B, W), generator=gen, device=dev)
    want = RS.rglru_scan_ref(a, b, h0)
    h = torch.empty_like(a)
    print(f"[rglru_ablate] yardstick torch.mul(a, b, out=h), the same bytes: "
          f"{cs.graph_ms(lambda: torch.mul(a, b, out=h), iters=10):.4f} ms "
          f"by replay", flush=True)
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for fn, (res, args) in RS._SIGNATURES.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
        ws = torch.empty(lib.rglru_scan_ws_bytes(B, T, W), dtype=torch.uint8,
                         device=dev)

        def call():
            rc = lib.rglru_scan_launch(
                a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
                ws.data_ptr(), ws.numel(), B, T, W,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"rglru_ablate: {name!r} launch failed ({rc})")

        h.fill_(float("nan"))
        call()
        torch.cuda.synchronize()
        right = sources[name][0]
        err = float((h - want).abs().max()) if right else None
        if right and not bool(((h - want).abs() <= cs.RG_TOL + cs.RG_TOL
                               * want.abs()).all()):
            sys.exit(f"rglru_ablate: {name!r} disagrees with the plain "
                     f"version (max abs err {err:.3e})")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        parts = {("memset" if "Memset" in e.key else "kernel"):
                 getattr(e, "self_device_time_total", 0.0) / 20 / 1e3
                 for e in prof.key_averages()
                 if getattr(e, "self_device_time_total", 0.0) > 0}
        replay = cs.graph_ms(call, iters=10)
        print(f"[rglru_ablate] {name} ({ptxas(path)}): kernel "
              f"{parts.get('kernel', 0):.4f} "
              f"ms, memset {parts.get('memset', 0):.4f} ms, replay "
              f"{replay:.4f} ms, "
              + (f"max abs err {err:.3e}" if right else "output cut"),
              flush=True)


if __name__ == "__main__":
    main()

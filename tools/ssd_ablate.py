#!/usr/bin/env python3
"""Where the time of ``ssd_chunk``'s bf16 route goes, on one CUDA card.

    python3 tools/ssd_ablate.py

Builds variants of ``src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu``
with one part of one kernel cut out (their outputs are wrong; only their
times count), all ``nvcc`` runs started together, into the git-ignored
``src/repro_torch/kernels/_build/``. Then it calls each variant's launcher
at mamba2-1.3b's 2048-token prefill shape (b 1, l 2048, nh 64, hp 64, n
128, Q 128, g 1; bf16 x, B, C) and prints each kernel's device time per
call, from torch.profiler over 20 calls, one line per variant. The card's
name and power limit come first. A variant whose cut no longer matches
the source stops the run: edit its text here with the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SRC = ROOT / "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu"

#: variant -> (kernel whose body is cut, text in it, its replacement)
CUTS = {
    "outputs: no diagonal (score tiles, M, M x)": (
        "ssd_outputs(Args a) {",
        "const int njp = active ? min(warp + 1, q16 / 16) : 0;",
        "const int njp = 0;"),
    "outputs: no exp in M's even columns": (
        "ssd_outputs(Args a) {",
        "gacc[t][2 * r] * __expf(ci - cj.x) * dj.x",
        "gacc[t][2 * r] * dj.x"),
    "outputs: no carried-state product": (
        "ssd_outputs(Args a) {",
        "  if (active) {\n#pragma unroll\n    for (int ks = 0;",
        "  if (false) {\n#pragma unroll\n    for (int ks = 0;"),
    "outputs: no y stores": (
        "ssd_outputs(Args a) {",
        "for (int e = tid; e < qlen * (kP / 4); e += kThreads) {",
        "for (int e = tid; e < 0; e += kThreads) {"),
    "states: no products": (
        "ssd_states(Args a) {",
        "for (int ks = 0; active && ks < q16 / 16; ++ks) {",
        "for (int ks = 0; false && ks < q16 / 16; ++ks) {"),
    "states: no S_in stores": (
        "ssd_states(Args a) {",
        "    state_io(a.ws", "    if (0) state_io(a.ws"),
    "states: no B copies": (
        "ssd_states(Args a) {",
        "    stage<kNS>(", "    if (0) stage<kNS>("),
}


def variants() -> dict:
    src = SRC.read_text()
    out = {"whole": src}
    for name, (kernel, old, new) in CUTS.items():
        start = src.index(kernel)
        at = src.find(old, start)
        if at < 0:
            sys.exit(f"ssd_ablate: the cut {name!r} no longer matches "
                     f"{SRC.name}")
        out[name] = src[:at] + new + src[at + len(old):]
    return out


def build(sources: dict) -> dict:
    """One shared library per variant, all nvcc runs at once."""
    from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc_path
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs, libs = [], {}
    for name, text in sources.items():
        key = hashlib.sha256(text.encode()).hexdigest()[:16]
        d = BUILD_DIR / f"ssd_ablate-{key}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "ssd_chunk.cu").write_text(text)
        libs[name] = d / "libssd_ablate.so"
        if not libs[name].exists():
            procs.append((name, subprocess.Popen(
                [nvcc_path(), *flags, "-o", str(libs[name]),
                 str(d / "ssd_chunk.cu")])))
    for name, proc in procs:
        if proc.wait() != 0:
            sys.exit(f"ssd_ablate: nvcc failed for {name!r}")
    return libs


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    if not torch.cuda.is_available():
        sys.exit("ssd_ablate: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build(variants())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, l, nh, hp, g, n, Q = 1, 2048, 64, 64, 1, 128, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(b, l, nh, hp).bfloat16()
    B, C = randn(b, l, g, n).bfloat16(), randn(b, l, g, n).bfloat16()
    dt = torch.rand((b, l, nh), generator=gen, device=dev) * 0.1
    A = -torch.arange(1, nh + 1, device=dev, dtype=torch.float32)
    S0 = randn(b, nh, hp, n)
    y, Sf = torch.empty((b, l, nh, hp), device=dev), torch.empty_like(S0)
    ws = torch.empty(SC._ws_floats(0, b, l, nh, hp, n, Q), device=dev)
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).ssd_chunk_launch
        fn.argtypes, fn.restype = SC._ARGTYPES, ctypes.c_int

        def call():
            rc = fn(0, x.data_ptr(), x.stride(0), x.stride(1),
                    dt.data_ptr(), A.data_ptr(), B.data_ptr(), B.stride(0),
                    B.stride(1), C.data_ptr(), C.stride(0), C.stride(1),
                    S0.data_ptr(), y.data_ptr(), Sf.data_ptr(),
                    ws.data_ptr(), b, l, nh, hp, g, n, Q,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"ssd_ablate: {name!r} launch failed ({rc})")

        for _ in range(5):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        parts = {e.key.split("(")[0].replace("tc::", ""):
                 getattr(e, "self_device_time_total", 0.0) / 20 / 1e3
                 for e in prof.key_averages()
                 if getattr(e, "self_device_time_total", 0.0) > 0}
        print(f"[ssd_ablate] {name}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in sorted(parts.items())), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Design choices of ``flash_attention_bwd``'s bf16 route, on one CUDA card.

    python3 tools/flash_bwd_ab.py

Builds variants of
``src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu``,
each with one choice undone, all ``nvcc`` runs started together, into the
git-ignored ``src/repro_torch/kernels/_build/``, and prints the ptxas
spill lines of their wgmma kernels. Then, in two rounds (whole, variants,
whole, variants), it calls each variant's launcher through the wrapper:
the worst row error of dq, dk, dv against the plain backward at a ragged
causal GQA shape (sq 300, d 128, keys at -1), and at minitron-8b's
4096-token train microbatch and 2048-token prefill and seamless-m4t-
medium's encoder shape the time of a call (CUDA events over 20 calls,
two input sets past the L2) and each kernel's device time (torch.profiler
over 5 calls). The card's name and power limit come first. A variant
whose edit no longer matches the source stops the run: edit its text here
with the kernel.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SRC = ROOT / ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_bwd.cu")

#: variant -> [(text in the source, its replacement)]
EDITS = {
    "no turns (the consumer warpgroups issue products at will)": [
        ('asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + w) : "memory");', ""),
        ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - w) : "memory");',
         "")],
    "two stages": [("kStages = 3;", "kStages = 2;")],
    "setmaxnreg 24 / 240": [("kProducerRegs = 40;", "kProducerRegs = 24;"),
                            ("kConsumerRegs = 232;", "kConsumerRegs = 240;")],
}

SHAPES = (  # label, (b, sq, skv, hq, hkv, d), causal
    ("train microbatch s 4096", (1, 4096, 4096, 32, 8, 128), True),
    ("prefill s 2048", (1, 2048, 2048, 32, 8, 128), True),
    ("seamless encoder s 1536", (1, 1536, 1536, 16, 16, 64), False),
)


def variants() -> dict:
    src = SRC.read_text()
    out = {"whole": src}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"flash_bwd_ab: the edit {old!r} of {name!r} no "
                         f"longer matches {SRC.name}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict) -> dict:
    """One shared library per variant, all nvcc runs at once; prints the
    ptxas spill lines of each variant's wgmma kernels."""
    from repro_torch.kernels.build import BUILD_DIR, nvcc_cmd, source_key
    procs, libs = [], {}
    for name, text in sources.items():
        d = BUILD_DIR / f"flash_bwd_ab-{source_key(text)}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attention_bwd.cu").write_text(text)
        libs[name] = d / "libflash_bwd_ab.so"
        procs.append((name, subprocess.Popen(
            nvcc_cmd(d / "flash_attention_bwd.cu", libs[name]),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"flash_bwd_ab: nvcc failed for {name!r}:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill" in line or "C75" in line:
                m = re.search(r"(dkdv_wgmma_kernel|dq_wgmma_kernel)ILi(\d+)E",
                              line if "C75" in line else entry)
                if m:
                    print(f"[flash_bwd_ab] {name}: {m.group(1)}<{m.group(2)}>"
                          f" {line.strip()[:110]}", flush=True)
    return libs


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import flash_attention as FA
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build(variants())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def inputs(b, sq, skv, hq, hkv, d, causal, holes=False):
        x = {n: torch.randn(s, generator=gen, device=dev).bfloat16()
             for n, s in (("q", (b, sq, hq, d)), ("k", (b, skv, hkv, d)),
                          ("v", (b, skv, hkv, d)), ("do", (b, sq, hq, d)))}
        x["qpos"] = torch.arange(sq, dtype=torch.int32, device=dev)
        x["kpos"] = torch.arange(skv, dtype=torch.int32, device=dev)
        if holes:
            x["kpos"][skv // 3:skv // 3 + 70] = -1
        x["o"], x["lse"] = FA.flash_attention_lse(
            x["q"], x["k"], x["v"], x["qpos"], x["kpos"], causal=causal)
        return x

    def bwd(x, causal):
        return FA.flash_attention_bwd(x["q"], x["k"], x["v"], x["o"],
                                      x["lse"], x["do"], x["qpos"],
                                      x["kpos"], causal=causal)

    def row_err(got, want):
        got, want = got.float(), want.float()
        norm = want.norm(dim=-1)
        floor = 1e-3 * max(float(norm.square().mean().sqrt()),
                           want.shape[-1] ** 0.5)
        return float(((got - want).norm(dim=-1) / norm.clamp(min=floor))
                     .max())

    ragged = inputs(1, 300, 300, 8, 2, 128, True, holes=True)
    want = FA.flash_attention_bwd_ref(
        ragged["q"], ragged["k"], ragged["v"], ragged["o"], ragged["lse"],
        ragged["do"], ragged["qpos"], ragged["kpos"], causal=True,
        block_q=256, block_kv=1024)
    sets = [[inputs(*shape, causal) for _ in range(2)]
            for _, shape, causal in SHAPES]
    order = list(libs) * 2
    for name in order:
        lib = ctypes.CDLL(str(libs[name]))
        lib.flash_attention_bwd_launch.argtypes = FA._BWD_ARGTYPES
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        FA._bwd_lib = lib
        err = max(row_err(g, w) for g, w in zip(bwd(ragged, True), want))
        parts = [f"ragged worst row {err:.2e}"]
        for (label, _, causal), xs in zip(SHAPES, sets):
            it = [0]

            def call():
                it[0] += 1
                return bwd(xs[it[0] % 2], causal)

            for _ in range(3):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
            kernels = {(re.findall(r"(\w+_kernel)", e.key) or [e.key])[0]:
                       getattr(e, "self_device_time_total", 0.0) / 5e3
                       for e in prof.key_averages()
                       if getattr(e, "self_device_time_total", 0.0) > 0}
            parts.append(f"{label} {start.elapsed_time(end) / 20:.4f} ms ("
                         + ", ".join(f"{k} {v:.4f}"
                                     for k, v in sorted(kernels.items()))
                         + ")")
        print(f"[flash_bwd_ab] {name}: " + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The expert backward's K1 (``moe_ffn_fused_bwd``), K2 (``moe_gemm_dx``)
and K3 (``moe_gemm_dw``) against the parent tree's, and with their design
choices undone, on one CUDA card.

    mkdir -p _checkout/parent && git archive HEAD | tar -x -C _checkout/parent
    python3 tools/moe_grad_ab.py [--parent _checkout/parent] [--rounds 2]
                                 [--only tree ...]

Builds the parent's ``moe_gemm.cu`` (with its own ``kernels/`` on the
include path), this tree's, and variants of this tree's with one choice of
namespace ``wgrad`` undone: text edits of the source (``EDITS``) or a patch
beside this file (``PATCHES``: the outputs written by 16-byte ``st.global``
from the staged tile instead of the TMA store; K1 as one pipeline of both
consumers on 128-column units; K1's gate and up split across the
consumers; K1's x multicast to a cluster of two blocks; K1's stages of 32
rows of D, x in the 64-byte swizzle), and K1 with one
of its parts cut out (``DIAGNOSTICS``: timed, outputs not compared).
``--only`` keeps a named variant (``tree``: this tree's source), once for
each. All ``nvcc`` runs
start together, into the git-ignored ``src/repro_torch/kernels/_build/``;
the ptxas lines (registers, spills, C75xx notes) of each variant's K1, K2
and K3 kernels are printed. Then, in this one process, each library in
turn is loaded into the wrappers: its K1 (dg, du and the check output y),
K2 and K3 outputs against the parent's, bit for bit, at ragged shapes (C
1-321, D and F off every tile, a strided x or ``a``, C past K3's resident
chunks and the 160-row chunk of K1 and K2; K1 at its own 22) and at the
five train shapes of qwen3-moe-30b-a3b (E 128, C 160; K1 x . [w_gate,
w_up] with dout; K2 one pair dy . w_down^T and two pairs, K3 one output
act^T . dy and two x^T . dg, x^T . du); then each train shape timed by
CUDA-graph replay (10 calls captured, inputs rotating over two sets, each
weight 403 MB: past the 50 MB L2), in rounds that go parent, tree,
variants and back (parent, tree, tree, parent: each pair in turns). The
card's name and power limit come first. A variant whose edit or patch no
longer matches the source stops the run: bring it up to date with the
kernel (a patch: ``diff -u`` of the source and the edited copy).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KERNELS = Path("src/repro_torch/kernels")
SRC = ROOT / KERNELS / "moe_gemm/csrc/moe_gemm.cu"

#: where the hint variant puts its TMA store with an L2 cache policy
#: (CUTLASS's CacheHintSm90 evict-first value)
_ANCHOR = "constexpr int kBM = 128;"
_HINTED = """
__device__ __forceinline__ void tma_store_hint(const CUtensorMap* map,
                                               uint32_t src, int c0, int c1,
                                               int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4}], [%1], %5;\\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "l"(0x12F0000000000000ull)
      : "memory");
}
"""

#: variant -> [(text in the source, its replacement)]
EDITS = {
    "a persistent grid, one block an SM of 132 (one block a unit kept)": [
        ("kern<<<units, kThreads, L::kAlloc, st>>>(ma,",
         "kern<<<units < 132 ? units : 132, kThreads, L::kAlloc, st>>>(ma,"),
        ("kern<<<units, kThreads, L::kAlloc, st>>>(mw0,",
         "kern<<<units < 132 ? units : 132, kThreads, L::kAlloc, st>>>(mw0,")],
    "K1: both pipelines start at once (the second half a unit later kept)": [
        ("      if (p == 1) mbar_wait(half, 0);\n", "")],
    "K1: dout loaded once the k loop is done (under it kept)": [
        ("if (kt == min(S, nk) - 1) {        // dout, under the k loop\n",
         "if (kt == nk - 1) {                // dout, after the loop\n"
         "            mbar_wait(empty(s), (it / S) & 1);\n")],
    "K2: a ring of 3 stages (5 kept)": [
        ("constexpr int kDxRing = 5;", "constexpr int kDxRing = 3;")],
    "K3: a ring of 3 chunks of a (5 kept)": [
        ("constexpr int kDwRing = 5;", "constexpr int kDwRing = 3;")],
    "K3: a ring of 10 chunks of a (5 kept)": [
        ("constexpr int kDwRing = 5;", "constexpr int kDwRing = 10;")],
    "K3 one output: 128 columns a unit (256 kept)": [
        ("return dw_launch<1, 256, kDwDepth",
         "return dw_launch<1, 128, kDwDepth")],
    "outputs stored with an L2 evict-first hint (no hint kept)": [
        (_ANCHOR, _ANCHOR + _HINTED),
        ("tma_store_3d(c < BN / 64 ? &tm_o0 : &tm_o1,",
         "tma_store_hint(c < BN / 64 ? &tm_o0 : &tm_o1,"),
        ("tma_store_3d(&tm_o, ot,", "tma_store_hint(&tm_o, ot,"),
        ("if (t == 0) tma_store_3d(map, tile, f0, c0, e);",
         "if (t == 0) tma_store_hint(map, tile, f0, c0, e);")],
}

#: K1's time without one of its parts (edits as above; the outputs are
#: wrong and not compared): where the time goes
DIAGNOSTICS = {
    "K1 without its epilogue (timing only)": [
        ("    mbar_wait(dout_full, nd & 1);\n",
         "    mbar_wait(dout_full, nd & 1);\n    if (D > 0) continue;\n")],
    "K1 loads only: no wgmma, no epilogue (timing only)": [
        ("        wgmma_tk(ga, desc(st + L::kX + ks * 2048, 8192, 1024), b);\n"
         "        wgmma_tk(ua, desc(st + L::kX + L::kW + ks * 2048, 8192, "
         "1024), b);\n",
         "        if (D < 0) wgmma_tk(ga, desc(st + L::kX + ks * 2048, 8192, "
         "1024), b);\n"),
        ("    mbar_wait(dout_full, nd & 1);\n",
         "    mbar_wait(dout_full, nd & 1);\n    if (D > 0) continue;\n")],
    "K1 without its TMA stores (timing only)": [
        ("      if (t == 0) tma_store_3d(map, tile, f0, c0, e);\n",
         "      if (t == 0 && D < 0) tma_store_3d(map, tile, f0, c0, e);\n")],
    "K1 loading half of x's rows (timing only)": [
        ("  if (!map_bf16(&mx, encode, x, D, C, E, sxc, sxe, 64, NR) ||",
         "  if (!map_bf16(&mx, encode, x, D, C, E, sxc, sxe, 64, NR / 2) ||"),
        ("          mbar_arrive_tx(full(s), L::kStage);\n#pragma unroll\n"
         "          for (int b = 0; b < BK / 64; ++b)\n",
         "          mbar_arrive_tx(full(s), L::kStage - L::kX / 2);\n"
         "#pragma unroll\n          for (int b = 0; b < BK / 64; ++b)\n")],
}

#: variant -> a unified diff of the source, beside this file
PATCHES = {
    "16-byte st.global (TMA store kept)": "moe_grad_ab_st_global.diff",
    "K1: one pipeline, both consumers on 128-column units (two pipelines "
    "of 64-column units kept)": "moe_grad_ab_k1_lockstep.diff",
    "K1: gate and up split across the consumers, one block a 64-column "
    "unit (each consumer both kept)": "moe_grad_ab_k1_split.diff",
    "K1: x multicast to a cluster of two blocks, each loading half (each "
    "block all of x kept)": "moe_grad_ab_k1_cluster.diff",
    "K1: 32-row stages (x in the 64-byte swizzle), rings of 4 (64-row "
    "stages, rings of 2 kept)": "moe_grad_ab_k1_r32.diff",
}

#: (E, C, D, F) of the ragged cases; the last strides x and a past their
#: rows
RAGGED = ((3, 1, 16, 8), (2, 9, 48, 72), (4, 37, 40, 136), (2, 161, 64, 24),
          (2, 200, 264, 40), (3, 70, 2056, 16), (2, 321, 136, 200))
#: K1's own ragged cases besides RAGGED (C 1-321, D 8-2056 off every
#: 64-row stage, F 8-200 off every 64- and 128-column tile); the last
#: three stride x past its rows
K1_RAGGED = ((1, 8, 72, 128), (2, 160, 128, 64), (3, 159, 200, 56),
             (1, 17, 24, 192), (2, 64, 520, 96), (1, 3, 8, 8),
             (2, 100, 1000, 8), (2, 250, 96, 80), (1, 120, 2048, 768),
             (2, 33, 112, 104), (3, 5, 176, 48), (1, 240, 64, 136),
             (2, 12, 1032, 40), (1, 300, 16, 8), (4, 2, 32, 200))

#: (label, kernel, train shape's case)
TRAIN = (("K1", "k1"), ("K2 one pair", "dx1"), ("K2 two pairs", "dx2"),
         ("K3 one output", "dw1"), ("K3 two outputs", "dw2"))
#: the train shapes' cases held bit for bit (K1 with its check output)
BITS = ("k1y", "dx1", "dx2", "dw1", "dw2")


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
    """This tree's source and each variant's text; exits where an edit or
    a hunk does not match the source exactly once."""
    src = SRC.read_text()
    out = {"tree": src}
    changes = {**EDITS, **DIAGNOSTICS}
    for name, diff in PATCHES.items():
        changes[name] = hunks((Path(__file__).parent / diff).read_text())
    for name, edits in changes.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"moe_grad_ab: the edit {old[:200]!r} of {name!r} "
                         f"no longer matches {SRC.name}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(parent: Path, only=()) -> dict:
    """One shared library per source, all nvcc runs at once (the parent's
    with its own headers); prints the ptxas lines of the tree's and each
    variant's K1, K2 and K3 kernels. ``only``: the variants to build
    besides the parent (all when empty)."""
    from repro_torch.kernels.build import (BUILD_DIR, NVCC_FLAGS, nvcc_path,
                                           source_key)
    jobs = {}
    psrc = parent / KERNELS / "moe_gemm/csrc/moe_gemm.cu"
    if not psrc.exists():
        sys.exit(f"moe_grad_ab: no parent source at {psrc}")
    jobs["parent"] = (psrc.read_text(), parent / KERNELS)
    for name, text in variants().items():
        if not only or name in only:
            jobs[name] = (text, ROOT / KERNELS)
    procs, libs = [], {}
    for name, (text, inc) in jobs.items():
        d = BUILD_DIR / f"moe_grad_ab-{source_key(text + str(inc))}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "moe_gemm.cu").write_text(text)
        libs[name] = d / "libmoe_grad_ab.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(inc), "-o",
               str(libs[name]), str(d / "moe_gemm.cu")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"moe_grad_ab: nvcc failed for {name!r}:\n{log}")
        entry, notes = "", {}
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            m = re.search(r"5wgrad\d+(d[xw]_kernel|dgu_kernel)I(\w+?)EEv",
                          line if "C75" in line else entry)
            if "C75" in line and m:
                code = re.search(r"C75\d\d", line).group(0)
                notes[code] = notes.get(code, 0) + 1
            elif m and ("registers" in line or "spill" in line):
                print(f"[moe_grad_ab] {name}: {m.group(1)}<{m.group(2)}> "
                      f"{line.strip()[:110]}", flush=True)
        if name != "parent":
            print(f"[moe_grad_ab] {name}: ptxas notes in K1 / K2 / K3 "
                  f"{notes or 'none'}", flush=True)
    return libs


def use(path: str) -> None:
    """Load the library at ``path`` into the wrappers."""
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    lib = ctypes.CDLL(path)
    for fn, args in MG._ARGTYPES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.moe_gemm_narrow_ws_floats.argtypes = [ctypes.c_int] * 4
    lib.moe_gemm_narrow_ws_floats.restype = ctypes.c_longlong
    MG._lib = lib


def cases(torch, gen):
    """name -> (inputs, call) for the ragged cases and two input sets of
    the train shapes; call(inputs) returns a list of outputs."""
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    dev = torch.device("cuda")

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).bfloat16()

    def k1y(t):
        y = torch.empty_like(t["dout"])
        return [*MG.moe_ffn_fused_bwd(t["x"], t["wg"], t["wu"], t["dout"],
                                      y=y), y]

    calls = {
        "k1": lambda t: list(MG.moe_ffn_fused_bwd(t["x"], t["wg"], t["wu"],
                                                  t["dout"])),
        "k1y": k1y,
        "dx1": lambda t: [MG.moe_gemm_dx((t["dy"],), (t["wd"],))],
        "dx2": lambda t: [MG.moe_gemm_dx((t["dg"], t["du"]),
                                         (t["wg"], t["wu"]))],
        "dw1": lambda t: MG.moe_gemm_dw(t["act"], (t["dy"],)),
        "dw2": lambda t: MG.moe_gemm_dw(t["x"], (t["dg"], t["du"]))}

    def inputs(E, C, D, F, pad=0):
        return {"x": rn(E, C + pad, D)[:, pad:], "dg": rn(E, C, F),
                "dout": rn(E, C, F),
                "du": rn(E, C, F), "act": rn(E, C, F), "dy": rn(E, C, D),
                "wg": rn(E, D, F, scale=D ** -0.5),
                "wu": rn(E, D, F, scale=D ** -0.5),
                "wd": rn(E, F, D, scale=F ** -0.5)}

    ragged = {}
    for i, (E, C, D, F) in enumerate(RAGGED):
        t = inputs(E, C, D, F, pad=8 if i == len(RAGGED) - 1 else 0)
        for k, fn in calls.items():
            if k != "k1":
                ragged[f"{k} E {E} C {C} D {D} F {F}"] = (t, fn)
    for i, (E, C, D, F) in enumerate(K1_RAGGED):
        t = inputs(E, C, D, F, pad=8 * (i >= len(K1_RAGGED) - 3))
        ragged[f"k1y E {E} C {C} D {D} F {F}"] = (t, calls["k1y"])
    train = [inputs(128, 160, 2048, 768) for _ in range(2)]
    return ragged, train, calls


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="_checkout/parent")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", action="append", default=[],
                    help="a variant to keep (tree: this tree's source), "
                         "once for each; all by default")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("moe_grad_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build(Path(args.parent).resolve(), args.only)
    gen = torch.Generator(device="cuda").manual_seed(28)
    ragged, train, calls = cases(torch, gen)

    use(str(libs["parent"]))
    want = {k: fn(t) for k, (t, fn) in ragged.items()}
    want.update({k: calls[k](train[0]) for k in BITS})
    torch.cuda.synchronize()
    for name, lib in libs.items():
        if name == "parent":
            continue
        if name in DIAGNOSTICS:
            print(f"[moe_grad_ab] {name}: outputs not compared", flush=True)
            continue
        use(str(lib))
        got = {k: fn(t) for k, (t, fn) in ragged.items()}
        got.update({k: calls[k](train[0]) for k in BITS})
        torch.cuda.synchronize()
        bad = [f"{k} ({sum(int((g != w).sum()) for g, w in zip(got[k], v))}"
               f" differ)" for k, v in want.items()
               if not all(torch.equal(g, w) for g, w in zip(got[k], v))]
        print(f"[moe_grad_ab] {name}: K1, K2 and K3 == the parent's bit "
              f"for bit at {len(ragged)} ragged cases and the "
              f"{len(BITS)} train shapes"
              if not bad else f"[moe_grad_ab] {name}: DIFFER from the "
              f"parent's at {', '.join(bad)}", flush=True)
        del got
    del want
    torch.cuda.empty_cache()

    order = list(libs)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            use(str(libs[name]))
            parts = []
            for label, k in TRAIN:
                it = {"i": 0}

                def call(k=k):
                    it["i"] ^= 1
                    return calls[k](train[it["i"]])
                parts.append(f"{label} {graph_ms(torch, call):.4f}")
            print(f"[moe_grad_ab] round {r} {name}: " + "; ".join(parts)
                  + " ms by replay", flush=True)


if __name__ == "__main__":
    main()

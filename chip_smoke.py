#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Run from the repository root. It builds the port's CUDA kernels from the
sources in the checkout and drives the port's main path at the full width of
minitron-8b (32 layers, d_model 4096, 32 query heads over 8 KV heads,
head_dim 128, vocab 256000; random bf16 weights from a seed):

1. build   — nvcc for every kernel library, all started together;
2. kernels — each kernel against its plain PyTorch version at minitron's
             decode shapes (B 8, S 2048, ragged lengths incl. 1, S-1, S;
             paged: page 128, a shuffled block table whose unused entries
             are the scratch page 0), with kernel / plain / library times
             and the least time the card could take;
3. serve   — ``repro_torch.launch.serve.serve`` through the northbound
             gateway: 4 sessions, 8 requests, 8 slots, max_len 2048;
4. engine  — dense and paged engines, 8 slots with 512-1536-token prompts
             and 64 decode steps: TTFT, decode tok/s, and token-identical
             streams between the two layouts;
5. reference — a small model (edge-tiny, f32) on the card against the same
             model on the CPU through the plain versions.

Phases 3 and 4 are the main path: the launch counters are set to 0 just
before phase 3 and read just after phase 4, and each kernel must have been
launched there. Any failed phase fails the run (exit 1). The last two lines
are the card's name and power limit, then the result JSON.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOPS = 989e12             # H100 SXM data sheet, dense tensor cores
ATOL = RTOL = 1e-2              # bf16 output vs the f32 plain version
REF_ATOL = 1e-3                 # f32 logits, card vs CPU (no TF32)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {len(build.SOURCES)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at minitron's decode shapes
# ---------------------------------------------------------------------------

def phase_kernels(cfg):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention as DA

    B, Hq, Hkv, D, S, page = 8, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim, 2048, 128
    pps = S // page
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1234)
    lens_host = np.array([1, S - 1, S, 517, 1024, 1500, 129, 64], np.int32)
    lengths = torch.from_numpy(lens_host).to(dev)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]            # [B, 1, 1, S]

    # paged pool: every row's pages scattered over a shuffled pool; table
    # entries past a row's length stay at the scratch page 0; pool pages no
    # row owns (page 0 included) hold finite garbage that must never reach
    # the softmax
    rng = np.random.default_rng(7)
    P = 1 + B * pps + 5
    perm = 1 + rng.permutation(P - 1)[:B * pps]
    tables = np.zeros((B, pps), np.int32)
    for b in range(B):
        used = -(-int(lens_host[b]) // page)
        tables[b, :used] = perm[b * pps:b * pps + used]
    tbl = torch.from_numpy(tables).to(dev)

    def inputs():
        q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dt)
        # dense cache in the engine's own layout [B, S, Hkv, D]
        ck = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dt)
        cv = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dt)
        pk = torch.full((P, page, Hkv, D), 3e4, device=dev, dtype=dt)
        pv = torch.full((P, page, Hkv, D), -3e4, device=dev, dtype=dt)
        for b in range(B):
            for j in range(-(-int(lens_host[b]) // page)):
                pk[tables[b, j]] = ck[b, j * page:(j + 1) * page]
                pv[tables[b, j]] = cv[b, j * page:(j + 1) * page]
        return {"q": q, "k": ck.transpose(1, 2), "v": cv.transpose(1, 2),
                "pk": pk, "pv": pv}

    # timed launches rotate over input sets larger than the 50 MB L2
    # together, so each launch reads its K/V from device memory, as a
    # decode step does after the other layers have passed through L2
    sets = [inputs() for _ in range(4)]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]

    def sdpa(x):
        return F.scaled_dot_product_attention(
            x["q"][:, :, None], x["k"], x["v"], attn_mask=mask,
            enable_gqa=True)

    valid_rows = int(lens_host.sum())
    kv_bytes = 2 * valid_rows * Hkv * D * 2
    qo_bytes = 2 * B * Hq * D * 2 + B * 4
    flops = 4 * valid_rows * Hq * D
    cases = [
        ("decode_attention", "src/repro/kernels/decode_attention/"
         "decode_attention.py:88",
         lambda x: DA.decode_attention(x["q"], x["k"], x["v"], lengths),
         lambda x: DA.decode_attention_ref(x["q"], x["k"], x["v"], lengths),
         lambda x: DA.decode_attention_ref(x["q"].float(), x["k"].float(),
                                           x["v"].float(), lengths),
         kv_bytes + qo_bytes),
        ("paged_decode_attention", "src/repro/kernels/decode_attention/"
         "decode_attention.py:205",
         lambda x: DA.paged_decode_attention(x["q"], x["pk"], x["pv"],
                                             lengths, tbl),
         lambda x: DA.paged_decode_attention_ref(x["q"], x["pk"], x["pv"],
                                                 lengths, tbl),
         lambda x: DA.paged_decode_attention_ref(
             x["q"].float(), x["pk"].float(), x["pv"].float(), lengths, tbl),
         kv_bytes + qo_bytes + B * pps * 4),
    ]
    rows = {}
    outs = {}
    for name, replaces, kern, plain, plain_f32, nbytes in cases:
        out = kern(sets[0])
        torch.cuda.synchronize()
        ref = plain_f32(sets[0])
        err = (out.float() - ref).abs()
        bad = err > ATOL + RTOL * ref.abs()
        if not torch.isfinite(out).all() or bool(bad.any()):
            fail(f"{name}: kernel disagrees with its plain version "
                 f"(max abs err {float(err.max()):.3e}, "
                 f"{int(bad.sum())} elements past atol=rtol={ATOL})")
        outs[name] = out
        ms = time_ms(lambda: kern(nxt()))
        plain_ms = time_ms(lambda: plain(nxt()), iters=10)
        # the library call on the linear [B, Hkv, S, D] view (for the paged
        # row too: PyTorch has no single call that reads a block table)
        library_ms = time_ms(lambda: sdpa(nxt()))
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/"
                      "decode_attention.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}
        log(f"[kernels] {name}: max_abs_err {float(err.max()):.3e} "
            f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} "
            f"({nbytes / 1e6:.1f} MB moved at least)")
    if not torch.equal(outs["decode_attention"],
                       outs["paged_decode_attention"]):
        fail("paged kernel is not bit-identical to the dense kernel on the "
             "same logical cache")
    log("[kernels] paged output bit-identical to dense output")
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path at full width
# ---------------------------------------------------------------------------

def phase_serve(params):
    from repro_torch.launch.serve import serve
    t0 = time.perf_counter()
    served, reports = serve("minitron-8b", sessions=4, requests=8, slots=8,
                            max_len=2048, gen_tokens=16, params=params,
                            device="cuda", quiet=True)
    log(f"[serve] minitron-8b: served {served}/8 in "
        f"{time.perf_counter() - t0:.2f} s")
    if served != 8:
        fail(f"serve() served {served}/8 requests")
    for sid, rep in reports.items():
        log(f"[serve] {sid}: n={rep.n} ttft_ms={rep.z.get('t_ff_ms')} "
            f"q99_ms={rep.z.get('q99_ms')}")


def run_engine(cfg, params, prompts, *, paged: bool, steps: int, chunk: int):
    import torch
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, params=params, slots=len(prompts),
                          max_len=2048, paged=paged, device="cuda")
    ttft = []
    for i, p in enumerate(prompts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill_session(f"s{i}", p)        # ends in a host sync
        ttft.append((time.perf_counter() - t0) * 1e3)
    toks = {f"s{i}": [] for i in range(len(prompts))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps // chunk):
        for sid, block in eng.decode_round(steps=chunk).items():
            toks[sid].extend(block)
    dt = time.perf_counter() - t0               # decode_round ends in a D2H
    profile_round(eng, "paged" if paged else "dense")
    return toks, ttft, len(prompts) * steps / dt


def profile_round(eng, name: str, steps: int = 4) -> None:
    """Where a decode step's time goes: one fused round of ``steps`` under
    torch.profiler — device-busy share of the wall time (the profiler's own
    host cost inflates the wall, so the share is a lower bound), the
    kernels that take the most device time, and the host ops that take the
    most host time. The profile's launches count toward the main path's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode_round(steps=steps)
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: host ops (aten::mm, ...) also report the device time of
    # the kernels they launched, which would count it twice
    avgs = prof.key_averages()
    events = [e for e in avgs
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events)
    log(f"[profile] {name}: {steps} steps wall {wall_us / steps / 1e3:.2f} "
        f"ms/step (profiled), device busy {busy / steps / 1e3:.2f} ms/step "
        f"= {100 * busy / wall_us:.1f}% of wall")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        log(f"[profile] {name}:   {dev_us(e) / steps / 1e3:8.3f} ms/step "
            f"x{e.count // steps:<4d} {e.key[:90]}")
    host = [e for e in avgs if str(e.device_type).endswith("CPU")]
    log(f"[profile] {name}: host ops "
        f"{sum(e.count for e in host) // steps} per step; by self CPU time:")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"[profile] {name}:   {e.self_cpu_time_total / steps / 1e3:8.3f}"
            f" ms/step x{e.count // steps:<5d} {e.key[:60]}")


def phase_engine(cfg, params):
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(512, 1537, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    out = {}
    for paged in (False, True):
        toks, ttft, tps = run_engine(cfg, params, prompts, paged=paged,
                                     steps=64, chunk=16)
        name = "paged" if paged else "dense"
        out[name] = toks
        log(f"[engine] {name}: prompts {lens.tolist()} ttft_ms "
            f"{[round(t, 2) for t in ttft]} decode {tps:.1f} tok/s "
            f"(8 slots x 64 steps, chunks of 16)")
    for sid in out["dense"]:
        a, b = out["dense"][sid], out["paged"][sid]
        if a != b:
            i = next(j for j in range(len(a)) if a[j] != b[j])
            fail(f"dense and paged engines diverge for {sid} at step {i}: "
                 f"{a[i]} vs {b[i]}")
        if len(a) != 64 or not all(0 <= t < cfg.vocab_size for t in a):
            fail(f"{sid}: {len(a)} tokens, expected 64 in range")
    log("[engine] dense and paged token streams identical (8 x 64 tokens)")


def check_logits(cfg, params):
    """Full-width prefill gives finite logits of the expected shape."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import LM
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, 64))).cuda()
    with torch.no_grad():
        logits, cache = LM(cfg).prefill(params, {"tokens": tokens}, 128)
    if tuple(logits.shape) != (1, cfg.padded_vocab) \
            or not torch.isfinite(logits[:, :cfg.vocab_size]).all():
        fail(f"full-width prefill logits {tuple(logits.shape)} not finite "
             f"of shape (1, {cfg.padded_vocab})")
    log(f"[reference] minitron-8b prefill logits finite, shape "
        f"{tuple(logits.shape)}")


# ---------------------------------------------------------------------------
# phase 5: small model on the card vs the CPU plain path
# ---------------------------------------------------------------------------

def phase_reference():
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM

    # full f32 matmul products on the card (PyTorch's default, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("edge-tiny"), dtype="float32")
    lm = LM(cfg)
    cpu_params = lm.init(5, "cpu")
    gpu_params = tree_map(lambda t: t.cuda(), cpu_params)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                               size=(2, 40))
    worst = 0.0
    with torch.no_grad():
        for paged in (False, True):
            res = []
            for params, dev in ((cpu_params, "cpu"), (gpu_params, "cuda")):
                toks = torch.from_numpy(prompt).to(dev)
                logits, cache = lm.prefill(params, {"tokens": toks}, 64)
                if paged:
                    # the same rows laid out as pages of 16 through a table
                    L_, b, S, kh, hd = cache["layers"]["k"].shape
                    pps = S // 16
                    ids = torch.arange(1, 1 + b * pps, device=dev,
                                       dtype=torch.int32).reshape(b, pps)
                    layers = {}
                    for key in ("k", "v"):
                        pool = torch.zeros((L_, 1 + b * pps, 16, kh, hd),
                                           device=dev)
                        pool[:, 1:] = cache["layers"][key].reshape(
                            L_, b * pps, 16, kh, hd)
                        layers[key] = pool
                    cache = {"layers": layers, "block": ids,
                             "pos": cache["pos"]}
                steps = [logits.cpu()]
                tok = logits.argmax(-1)
                for _ in range(8):
                    lg, cache = lm.decode_step(params, cache, tok[:, None])
                    steps.append(lg[:, 0].cpu())
                    tok = lg[:, 0].argmax(-1)
                res.append(torch.stack(steps))
            err = float((res[0] - res[1]).abs().max())
            worst = max(worst, err)
            log(f"[reference] edge-tiny f32 {'paged' if paged else 'dense'}:"
                f" card vs CPU max |logit diff| {err:.3e} over prefill + 8 "
                f"decode steps")
    if worst > REF_ATOL:
        fail(f"card and CPU logits differ by {worst:.3e} > {REF_ATOL}")


# ---------------------------------------------------------------------------

def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch.bridge import leaves
        from repro_torch.configs import get_config
        from repro_torch.kernels.decode_attention import decode_attention \
            as DA
        from repro_torch.models.transformer import LM
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    phase_build()
    cfg = get_config("minitron-8b")
    rows = phase_kernels(cfg)

    t0 = time.perf_counter()
    params = LM(cfg).init(0, "cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    log(f"[init] minitron-8b {n / 1e9:.2f} B params in "
        f"{time.perf_counter() - t0:.1f} s")

    DA.reset_launches()
    phase_serve(params)
    gc.collect()                    # the serve() fleet's four KV caches
    torch.cuda.empty_cache()
    after_serve = dict(DA.LAUNCHES)
    phase_engine(cfg, params)
    launches = dict(DA.LAUNCHES)
    log(f"[main path] launches after serve {after_serve}, after engine "
        f"{launches}")
    for name, row in rows.items():
        row["launches"] = launches[name]
        if launches[name] == 0:
            fail(f"{name} was not launched on the main path")

    check_logits(cfg, params)
    del params
    torch.cuda.empty_cache()
    phase_reference()
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": list(rows.values())}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

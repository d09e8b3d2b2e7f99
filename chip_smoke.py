#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py            # everything (the result line at the end)
    python3 chip_smoke.py --quick    # build, kernel checks, small models

Run from the repository root. It builds the port's CUDA kernels from the
sources in the checkout and drives the port's main paths at full width
(random weights from a seed), printing each phase's seconds on a
``[time]`` line:

* minitron-8b (dense GQA: 32 layers, d_model 4096, 32 query heads over 8
  KV heads, head_dim 128, vocab 256000; bf16);
* minitron-8b with per-session LoRA adapters (rank 8, grouped route);
* qwen3-moe-30b-a3b (MoE: 48 layers, d_model 2048, 32 query heads over 4
  KV heads, 128 experts top-8, expert d_ff 768, vocab 151936; bf16, 30.5 B
  params) at full width and depth;
* mixtral-8x7b (MoE with a sliding window: 32 layers, d_model 4096, 32
  query heads over 8 KV heads of 128, window 4096, 8 experts top-2, expert
  d_ff 14336, vocab 32000; 46.7 B params) at full width and 16 of its 32
  layers (``MIXTRAL_LAYERS``: the script's time limit) with int8 weights
  (47.0 GB at full depth), drawn on the card by ``LM.init`` at
  ``serve_weight_dtype="int8"``;
* qwen2-vl-72b (dense GQA with M-RoPE and the vision frontend stub: 80
  layers, d_model 8192, 64 query heads over 8 KV heads of 128, d_ff
  29568, vocab 152064, M-RoPE sections (16, 24, 24), 256 vision tokens)
  at full width and depth with int8 weights (75.3 GB), drawn the same
  way;
* recurrentgemma-2b (hybrid: 26 layers in the pattern rec, rec, attn —
  18 RG-LRU blocks of width 2560, 8 local-attention layers, MQA 10 q heads
  over 1 KV head of 256, window 2048 — vocab 256000; bf16) at full width
  and depth;
* mamba2-1.3b (SSM: 48 Mamba-2 SSD layers, d_model 2048, 64 heads of 64,
  state 128, chunk 128, vocab 50280; bf16) at full width and depth;
* seamless-m4t-medium (encoder-decoder: 12 encoder and 12 decoder layers,
  d_model 1024, 16 heads of 64, d_ff 4096, vocab 256206, 1536 source
  frames from the audio frontend stub; bf16) at full width and depth,
  through the model's entry points (the engine serves no encdec model, in
  either package);
* a split session: a recurrentgemma-2b draft verified by minitron-8b,
  both at full width and depth, speculative decode on one card;
* training: minitron-8b at full width and 4 of its 32 layers (its f32
  train state at full depth, 158 GB, needs more than one card), sequence
  4096, batch 2 in 2 microbatches, full remat, bf16 compute on f32 master
  weights, AdamW, through ``make_train_step`` with the flash forward and
  backward kernels;
* training qwen3-moe-30b-a3b the same way at full width and 4 of its 48
  layers (3.12 B parameters), through the flash kernels, the expert
  kernels and their backward kernels (K1 ``moe_ffn_fused_bwd``, K2
  ``moe_gemm_dx``, K3 ``moe_gemm_dw``);
* training recurrentgemma-2b (2.69 B parameters) and mamba2-1.3b (1.34 B)
  the same way at full width and depth (fewer layers only if the
  predicted peak passed 75 GB; the depth is printed), through
  ``rglru_scan`` and its reverse scan ``rglru_scan_bwd``, and through
  ``ssd_chunk`` and its three backward kernels ``ssd_chunk_bwd``;
* training seamless-m4t-medium (0.98 B parameters) the same way at full
  width and depth, 12 encoder and 12 decoder layers, each row with 1536
  frames from the audio frontend stub, through the flash kernels in the
  encoder's self attention and the decoder's self and cross attention;
* the distribution layer (``repro_torch.sharding``, DTensor on a torch
  ``DeviceMesh``) on a 1x1 mesh of a one-rank NCCL group: minitron-8b's
  and qwen3-moe-30b-a3b's 4-layer train steps with their states laid out
  by the sharding plan, minitron-8b's 32-layer, qwen3-moe-30b-a3b's
  4-layer and int8 mixtral-8x7b's 4-layer prefill and decode with the
  params and the cache laid out by the decode plan, the recurrent
  families' train steps and serving, and seamless-m4t-medium's train step
  and serving at full depth (its cross K/V caches in the plan's layout),
  each against the same path on plain tensors; mamba2-1.3b's DTensor
  train state saved as a checkpoint, restored from a ``meta`` tree into
  the plan's layout, and a step from it against the step from the state
  in memory.

Phases:

1. build   — nvcc for every kernel library, all started together;
2. kernels — each kernel against its plain PyTorch version on the main
             paths' shapes, with kernel / plain / library times and the
             least time the card could take: decode attention (ptxas
             registers and spills of each instantiation) at lengths 0, 1,
             kChunk - 1, kChunk, kChunk + 1 and S in bf16 and f32, its
             splits' combine order pinned by an f32 cancellation, then
             minitron-8b's, qwen3-moe-30b-a3b's and seamless-m4t-medium's
             decoder shapes (B 8, S 2048, lengths 1 ... 2048; paged: a
             shuffled block table whose unused entries are the scratch
             page 0; qwen2-vl-72b's shape is checked at the ragged lengths
             here and timed on its path, at the batches it decodes),
             timed beside SDPA by eager calls
             (``ms``, host side included, as every kernel row) and by
             CUDA-graph replay (``device_ms``), and paged output equal to
             dense output bit for bit throughout;
             the grouped GEMMs at
             qwen3-moe's expert shapes (decode C 8, prefill C 160; the
             tensor-core variant, asserted, with rows 0-7 at C 160 equal
             to C 8 bit for bit) and at the adapter route's two f32
             products (the narrow variant, asserted, with a row's bits
             equal at C 1, 8 and 72 and any position), after ragged shapes
             of all three variants (C 1-300, D 4-4100, F 4-4096), timed
             eager and by CUDA-graph replay beside ``torch.bmm`` both ways
             (and, for the adapter products, the host µs a call); the
             int8-weight variant (``wgmma`` on TMA-fed int8 tiles): the
             ptxas lines of its kernels (no spill, no C7512) and their
             HGMMA instructions (``cuobjdump -sass``, none fails), then
             ragged shapes (C 1-300, F 16-768, an empty expert,
             strided x, a zero weight column) and mixtral's four expert
             shapes (gate/up and down, C 8 and 640), each output equal to
             the tensor-core variant's on ``as_weight(w)`` bit for bit,
             rows 0-7 of C 640 equal to a C 8 call and a CUDA-graph replay
             equal to the eager call, int8 weights it does not take (F off
             16, q's stride off 16) raising, timed eager and by replay
             beside ``as_weight`` + the bf16 kernel, ``as_weight`` +
             ``torch.bmm`` and ``torch.bmm`` on bf16 weights, with the
             wrapper's host µs a call at C 8;
             rglru_scan and ssd_chunk at the recurrent paths' 2048-token
             prefill shapes with a carried state (and ssd_chunk at a
             ragged l), eager and by replay, the SSD route's two kernels'
             and the RG-LRU scan's kernel and memset device times and its
             wrapper's host µs a call, after ragged shapes down to the
             smoke configs' widths (T 1-4200, W 1-2560, B 1-3, rows off 16
             bytes; l 1-1000, both routes, strided views of one buffer,
             strides off 8, zero-dt steps carrying the state), the RG-LRU
             scan's bits (eager == eager == graph replay, a row's bits
             equal at B 1 and 3, identity steps keep the state exactly);
             flash_attention at minitron-8b's and qwen2-vl-72b's
             2048-token causal prefills and seamless-m4t-medium's encoder
             (1536 frames), cross attention (1024 x 1536) and training
             microbatch (the decoder's 4096-token causal self attention,
             the cross attention of 4096 over 1536), after ragged
             shapes (head dims 16-128 in f32 and bf16, -1 key positions,
             a first kv-tile with no valid key, reversed key positions,
             every engine bucket at minitron's and qwen2-vl's widths,
             qwen2-vl's 1024-token vision prompt with stream 0 tied over
             its 256 image tokens), compared on the
             rows that have a valid key, and the ptxas registers and
             spills of its bf16 route at head dims 64 and 128;
             flash_attention's backward (dq, dk, dv from q, k, v, the
             forward's output and lse, and dO): the ptxas registers and
             spills of its wgmma kernels and their HGMMA instructions
             (none fails), then against its plain version at ragged
             shapes in f32 (1e-5) and bf16 (each row within 2e-2 of its
             norm in L2), every route the launcher dispatches to, a row's
             bits at b 1 equal to the same row's at b 2, then at the
             training path's 4096-token microbatch (where three planted
             faults, a key tile or a query tile dropped, must fail that
             bound), minitron-8b's 2048 prefill and
             seamless-m4t-medium's encoder and cross shapes and its
             training microbatch's two, each with
             the forward with lse equal to the forward without it bit for
             bit and a CUDA-graph replay equal to the eager call, timed
             eager and by replay beside SDPA's backward (eager, and its
             kernels' device time from the profiler, by name);
             the expert kernels' backward (K1 ``moe_ffn_fused_bwd``, K2
             ``moe_gemm_dx`` on one pair and two, K3 ``moe_gemm_dw`` on
             one output and two): the ptxas lines of K1's, K2's and K3's
             wgmma kernels (no spill, no note that wgmma is serialized)
             and their HGMMA instructions (none fails), the bit probe
             (every ``wgmma`` shape and operand layout of the int8
             variant, K1, K2 and K3 against ``mma.sync`` over 4096 k16
             steps: any differing output fails), then against their plain
             versions
             at ragged shapes (C 1-200, D 8-2056, F 8-136, C off 8 for
             K3; bf16 on the tensor and the CUDA cores, f32), qwen3-moe's
             smoke shapes in f32 (1e-5) and the training path's (E 128, C
             160, D 2048, F 768; bf16 rows within 2e-2 of their norm, the
             tensor-core route asserted), K1's forward from its
             recomputed gate and up equal to ``moe_ffn_fused``'s bit for
             bit, K1, K2 and K3 by replay equal to eager, K1's and K2's
             rows 0-7 at C 160 to a C 8 call and K1's and K3's expert 0 at
             E 128 to that expert alone, each timed eager and by replay
             beside ``torch.bmm`` on
             the same products and the bound in bytes and in operations;
             then, under autograd on the card, the expert kernels' int8
             and narrow variants and both decode kernels must refuse (no
             backward kernel);
             the recurrent kernels' backward: rglru_scan_bwd (the scan run
             in reverse) and ssd_chunk_bwd (three kernels: the states'
             gradient carried from the last chunk, every chunk's dx, ddt,
             dB and dC in parallel, the heads' shares summed) against
             their plain backward at ragged shapes (T 1-4200, W 1-2560,
             B 1-3; l 1-1000, hp 8-72, n 8-128, g 1-2, Q 16-128, f32 and
             bf16, the bf16 route with the forward's states and without),
             at the probe's decay span (dt 0.7, A -1 .. -64, chunks of
             128: every gradient finite, held to the plain backward in
             f64) and at the training microbatches (B 1 T 4096 W 2560;
             b 1 l 4096 nh 64 hp 64 n 128 in bf16 and f32), always with a
             nonzero h0 / S0 and the final state's cotangent; eager ==
             eager again == graph replay bit for bit, a row's bits equal
             alone and in B 3; timed eager and by replay beside the plain
             backward (and torch.cumsum for the scan), with each kernel's
             device time and the bound in bytes and operations;
3. serve   — ``repro_torch.launch.serve.serve`` through the northbound
             gateway: 4 sessions, 8 requests, 8 slots, max_len 2048;
4. engine  — dense and paged engines, 8 slots with 512-1536-token prompts
             and 64 decode steps: TTFT, decode tok/s, a profiled decode
             round, and token-identical streams between the two layouts;
   adapters — 8 sessions (2 base, 2 for each of 3 adapters from the
             adapter catalog) through a ServingPlane over a RealEngineBackend
             on an engine with an AdapterRuntime: the mixed batch gives each
             session the tokens it gets alone, and base sessions the tokens
             of an engine without adapters;
   moe     — minitron freed, qwen3-moe-30b-a3b drawn on the card; phases 3
             and 4 again for it;
   mixtral — qwen3-moe freed, mixtral-8x7b drawn on the card in int8: 8
             sessions (prompts of 1000-6000 tokens, two past the window,
             one of 4090 whose decode wraps the ring) x 64 greedy tokens
             through a ServingPlane over a RealEngineBackend on an
             InferenceEngine (8 slots, max_len 8192), then the same
             prompts on a direct engine (TTFT, decode tok/s, a profiled
             round); every expert-kernel launch on the int8 variant, no
             attention kernel (banded prefill, ring decode); outside the
             window, the plane's streams equal the direct engine's,
             paged=True keeps the dense layout and its tokens, a wrapped
             session's mid-stream export (``kvcache.cache_bytes`` of one
             slot) continues in a fresh engine, finite prefill logits, a
             profiled 8192-bucket prefill with the expert kernels' share
             and peak memory under 80 GB;
   qwen2-vl — mixtral freed (device memory allocated near 0),
             qwen2-vl-72b drawn on the card in int8; the engines' slots
             from a predicted peak (8 at max_len 2048 if it leaves 1.5 GB
             of the card's total_memory, else 4; never two engines of this
             model at once); both decode kernels timed at the path's
             batches (the slots, and the vision prompt's B 1, S 1040)
             before its window: 8 text sessions (prompts of 500-1900 tokens)
             x 32 greedy tokens through a ServingPlane over a
             RealEngineBackend, then the same prompts on direct dense
             engines (TTFT, decode tok/s, a profiled round) and paged
             engines, then a 1024-token vision prompt through ``LM.prefill``
             (``vision_embeds`` [1, 256, 8192] over the first 256 tokens,
             explicit [3, 1, s] positions with the image's 16 x 16 grid in
             streams 1-2) and 16 ``LM.decode_step``s; flash_attention 80
             times a prefill, the decode kernels 80 a step of their
             layout, no other kernel; outside the window, the plane's
             streams equal the direct engines', paged equal dense, a
             mid-stream export continues in a fresh engine (2 slots),
             finite prefill logits, the vision prompt's logits finite and
             its cache not a text-only prefill's, a profiled 2048-bucket
             prefill (each profile sums ``as_weight``'s kinds of kernel —
             copies, casts, f32 products — beside the cuBLAS GEMMs), and
             the peak memory printed beside total_memory and under it;
   recurrent — each recurrent model drawn in turn (the previous one freed):
             phases 3 and 4 (dense engine) with rglru_scan launched 18 times
             and ssd_chunk 48 times per prefill, the decode-attention
             kernels and flash_attention not at all; then, outside the
             launch window, paged=True keeps the dense layout and its
             tokens, a mid-stream export (exactly ``kvcache.cache_bytes``
             of one slot) imported into a fresh engine continues
             token-identically, the full-width prefill logits are finite,
             and a profiled 2048-bucket prefill;
   encdec  — seamless-m4t-medium: 8 prompts of 64-1024 tokens, each with
             1536 frames, right-padded to the engine's buckets and
             prefilled through ``LM.prefill`` (flash_attention 36 times a
             prefill: 12 encoder, 12 causal self, 12 cross), then 64 greedy
             ``LM.decode_step``s on the batch of 8 (decode_attention 12
             times a step): TTFT split into encoder and decoder, decode
             ms/step and tok/s, peak memory; outside the window, finite
             logits and cross K/V unchanged by decode;
   split   — a session established through the port's control plane
             (``split_policy="require"``: an edge draft anchor hosting
             recurrentgemma-2b, a regional verify anchor hosting
             minitron-8b), one engine per anchor, a 1000-token prompt, 32
             committed tokens an arm, γ 4: target-only greedy, the real
             pair, oracle proposals (~30% corrupted), a twin draft and a
             mid-stream verify migration into a paged engine; every arm's
             stream bitwise the target-only one, the oracle arm's
             acceptance strictly in (0, 1), the twin's 1.0; outside the
             window, the draft's rolled-back states equal a plain decode's
             and the release frees both anchors;
   train   — minitron-8b at 4 layers (the previous paths' memory
             released): ``init_train_state`` on the card, 3 steps of
             ``make_train_step`` on the synthetic data stream and 4 on one
             repeated batch (AdamW, lr 1e-4 after a 1-step warmup), each
             timed (step ms, tokens/s, model TFLOP/s against the bf16
             peak); every step launches flash_attention twice a layer and
             microbatch (forward and remat recompute) and
             flash_attention_bwd once; the repeated batch's loss falls;
             the peak memory beside its prediction and total_memory; then,
             outside the window, a 1-layer step at full width with the
             attention's kernels against the same step with its plain
             forward and backward on the card (loss 1e-3, each gradient
             leaf within 2e-2 of its norm in L2), and two planted faults
             in the backward kernel's outputs that must fail it;
   train moe — qwen3-moe-30b-a3b likewise at 4 layers (3 if the predicted
             peak passes 75 GB): every step launches the expert kernels
             twice a layer, microbatch and 2048-token chunk (forward and
             recompute), K1 once and K2 and K3 twice, all on the tensor
             cores; the 1-layer check holds the expert kernels and K1-K3
             against their plain versions, with two planted faults (dw of
             one expert's w_down zeroed; dx without du @ w_up^T for one
             expert's rows);
   train rec, train ssm — recurrentgemma-2b and mamba2-1.3b likewise at
             full depth (``recurrent_train_config``): every step launches
             rglru_scan twice and rglru_scan_bwd once a RG-LRU block and
             microbatch (18 blocks: 72 and 36; the local attention is
             banded, no flash kernel), ssd_chunk 136 times and
             ssd_chunk_bwd 48 times a microbatch (48 layers: the forward,
             each layer's recompute and each of the 8 √L groups' recompute
             but for its last layer; ``remat_forwards``); the 1-layer
             checks hold the kernels against the plain forward and
             backward, with planted faults (the scan: the gradient carried
             into one 64-step chunk dropped, that chunk's da zeroed; the
             SSD: the state's gradient carried into one chunk dropped, ddt
             without its A·rcumsum(dcum) term); each path prints its
             seconds;
   train encdec — seamless-m4t-medium likewise at full depth, 1536
             frames a row (``train_batches``): every step launches
             flash_attention 144 and flash_attention_bwd 72 times (36
             attention layers a microbatch: 12 encoder, 12 decoder self,
             12 cross; the forward twice under full remat);
   distributed — the distribution layer (started right after the build:
             eight dry-run cells, minitron-8b train_4k, phi3-medium-14b
             prefill_32k, qwen3-moe-30b-a3b train_4k, mixtral-8x7b
             decode_32k, mamba2-1.3b train_4k, recurrentgemma-2b
             long_500k, seamless-m4t-medium train_4k and prefill_32k
             at full scale on the 16x16 production mesh, each
             a subprocess of its own with a fake world of 256 ranks under
             ``FakeTensorMode``, no card: each must be ``ok`` with a
             per-device peak under the card's total_memory, and prints
             its record, estimates from the H100 data sheet's constants);
             a one-rank NCCL group and a 1x1 ``DeviceMesh``: minitron-8b's
             and qwen3-moe-30b-a3b's 4-layer train steps (seq 4096, 2
             microbatches, full remat) with their states laid out by
             ``make_plan`` and ``train_state_specs``, each against the
             plain step from the same seed (loss, grad norm and every
             updated leaf bit for bit, or within 1e-3 of the leaf's norm
             where DTensor's ops differ; the launches of every kernel
             equal, the expert kernels and K1-K3 too), then both steps 5
             times in turns on the same tensors (median ms, DTensor's
             host overhead); through the decode plan, 2 prompts, a
             prefill and 8 greedy decode steps whose tokens equal the
             plain path's: minitron-8b at 32 layers (prompts of 512;
             flash 32 a prefill, decode attention 32 a step),
             qwen3-moe-30b-a3b at 4 layers (prompts of 512; its MoE
             layers through one ``local_map`` region each) and
             mixtral-8x7b on int8 weights at 4 layers (prompts of 4500
             past its 4096-token window: banded prefill, the ring filled
             and read rank by rank, no attention kernel); the recurrent
             families' train steps and serving; seamless-m4t-medium's
             train step at full depth (frames, flash 144 and its backward
             72 a step, as the plain step's) and its serving at full
             depth (2 prompts of 512 with 1536 frames each; flash 36 a
             prefill, decode attention 12 a step; the cross K/V caches
             DTensors in the plan's layout);
             decode_attention's lse output is checked with the kernels
             (phase 2: minitron's and qwen2-vl's decode shapes, lengths
             0, one shard of S, S), and so are the expert kernels at the
             local shapes of a 16-way model axis (phase 2: qwen3-moe's 8
             experts a rank and mixtral's 896 f columns, against the
             whole launch), and so are the flash kernels (phase 2: one of
             seamless-m4t-medium's 16 heads, its encoder's 1536 x 1536
             and the cross attention's 4096 x 1536, forward and backward
             against the whole launch's head);
5. reference — small models in f32 on the card against the same models on
             the CPU through the plain versions: edge-tiny (dense and
             paged), edge-tiny with adapters (grouped route on the card,
             its products on the narrow variant, gather on the CPU), the
             qwen3-moe smoke config, the
             recurrentgemma-2b and mamba2-1.3b smoke configs, the
             seamless-m4t-medium smoke config (head_dim 32), the
             mixtral-8x7b smoke config with int8 weights (window 16) and
             the qwen2-vl-72b smoke config (head_dim 32, M-RoPE (8, 4, 4))
             with vision embeddings and distinct [3, b, s] streams, stream
             0 first ``arange``, then tied over the image (Qwen2-VL's
             layout, which the causal mask of the flash kernel reads);
             and edge-tiny's, the qwen3-moe, seamless-m4t-medium (with
             frames), recurrentgemma-2b and mamba2-1.3b smoke configs' f32
             train microbatch with full remat: loss and every gradient
             leaf (the f32 routes of the
             flash kernels, of the expert kernels and K1-K3, of the
             recurrent kernels and their backward, forward and backward).

Each main path is driven with every launch counter set to 0 just before it
and read just after, and each kernel the path runs must have been launched
there (flash_attention exactly once per full-attention layer of each
prefill: 32 for minitron-8b, 48 for qwen3-moe-30b-a3b, 80 for
qwen2-vl-72b, 36 for seamless-m4t-medium, 0 for the recurrent families;
the decode kernels 80 per qwen2-vl-72b step of their layout; on the split
path 32 per minitron-8b prefill, rglru_scan 18 per recurrentgemma-2b
prefill, the decode kernels 32 per dense or paged minitron-8b step; on
the training paths flash_attention 16 and flash_attention_bwd 8 a step
(on the 1x1 DTensor steps too; minitron-8b's DTensor serving path
flash_attention 32 and decode_attention 256); on seamless-m4t-medium's
training path and its 1x1 DTensor step flash_attention 144 and
flash_attention_bwd 72 a step, on its DTensor serving path
flash_attention 36 a prefill and decode_attention 12 a step,
and on qwen3-moe's moe_gemm and moe_ffn_fused 32, moe_ffn_fused_bwd 16,
moe_gemm_dx and moe_gemm_dw 32 a step; on recurrentgemma-2b's rglru_scan
72 and rglru_scan_bwd 36, on mamba2-1.3b's ssd_chunk 272 and
ssd_chunk_bwd 96 a step);
the
checks of a path's result (each adapter session alone, the full-width
prefill logits and a profiled prefill, the recurrent, encdec, mixtral and
qwen2-vl checks) run after that read and are not counted. Every grouped-GEMM
launch of the qwen3-moe path must have taken the tensor-core variant,
every one of the adapter path's the narrow variant (its products are f32
and rank-sized) and every one of the mixtral path's the int8 variant.
Each
profiled decode round prints its decode attention share, the profiled
recurrent prefills their rglru_scan or ssd_chunk share. Any failed phase
fails the run (exit 1). The last two lines are the card's name and power
limit, then the result JSON.
"""

from __future__ import annotations

import atexit
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOPS = 989e12             # H100 SXM data sheet, dense tensor cores
F32_FLOPS = 67e12               # H100 SXM data sheet, f32 outside them
ATOL = RTOL = 1e-2              # bf16 output vs the f32 plain version
F32_TOL = 1e-5                  # f32 kernel output vs the plain version
RG_TOL = 1e-5                   # RG-LRU scan: the kernel's chunk-parallel
#                                 f32 scan (64-step chunk products, folded
#                                 in chunk order) vs the plain log-depth scan
SSD_TOL = 1e-3                  # SSD scan: f32 sums of 16-128 terms and a
#                                 2048-step carried state, in another order
REF_ATOL = 1e-3                 # f32 logits, card vs CPU (no TF32)
BWD_KERNELS = ("dkdv_wgmma_kernel", "dq_wgmma_kernel")  # its bf16 route
BWD_ROW = 2e-2                  # bf16 flash backward vs its plain version:
#                                 each row of dq, dk, dv (one position's
#                                 head vector) in L2, of that row's norm,
#                                 floored at 1e-3 of the rows' rms norm or
#                                 of a row of ones (a row with a single key
#                                 cancels to ~0, and so may every row).
#                                 H100: the kernel 2.4e-3 to 6.2e-3 (dS is
#                                 rounded to bf16), planted faults >= 0.63
TRAIN_LAYERS = 4                # minitron-8b's training path: full width,
TRAIN_SEQ = 4096                # 4 of its 32 layers (f32 state of 32
TRAIN_BATCH = 2                 # layers: 158 GB), the reference's train_4k
TRAIN_MICRO = 2                 # sequence, batch 2 in 2 microbatches
TRAIN_STEPS = 3                 # steps on the data stream
REPEAT_STEPS = 4                # then steps on one repeated batch
GRAD_REL = 2e-2                 # 1-layer step, kernel vs plain attention:
#                                 each gradient leaf in L2, of its norm.
#                                 H100: the kernels 6.6e-3, the planted
#                                 faults 4.7e-2 (dq) and 7.3e-2 (dk, dv)
FAULT_TILE = slice(1024, 1088)  # the 64-key tile a planted fault drops
RG_BWD_TOL = 1e-5               # rglru_scan_bwd vs its plain backward, of
#                                 each gradient's largest magnitude (f32,
#                                 another order; H100: <= 2.4e-7)
SSD_BWD_TOL = 1e-4              # ssd_chunk_bwd's f32 gradients vs its plain
#                                 backward, of each's largest magnitude
#                                 (H100: <= 1.8e-5, ddt at the train shape)
SSD_BWD_DA = 2e-4               # its dA: every step's share summed (H100:
#                                 <= 4.8e-5, at the probe's span)
SSD_BWD_BF16 = 1e-2             # its bf16 outputs dx, dB, dC: rounded once
#                                 (H100: <= 3.3e-3)
SPAN_DT, SPAN_A = 0.7, 64.0     # the probe's span: a chunk's decay past 88
FAULT_SSD_STEP = 3072           # the chunk boundary whose carried state
#                                 gradient a planted fault drops
REC_TRAIN_BYTES = 75e9          # recurrentgemma-2b's and mamba2-1.3b's
#                                 training paths: full width, every layer
#                                 the predicted peak keeps within this
MOE_TRAIN_LAYERS = 4            # qwen3-moe-30b-a3b's training path: full
MOE_TRAIN_BYTES = 75e9          # width, 4 of its 48 layers, 3 if the
#                                 predicted peak passes 75 GB; the same
#                                 sequence, batch and microbatches
ENCDEC_STEPS = 64               # greedy decode steps of the encdec path


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def row_err(got, want):
    """Each [..., d] row's ``||got - want|| / ||want||``, the norm floored
    at 1e-3 of the larger of the rows' rms norm and a row of ones'."""
    got, want = got.float(), want.float()
    norm = want.norm(dim=-1)
    floor = 1e-3 * max(float(norm.square().mean().sqrt()),
                       want.shape[-1] ** 0.5)
    return (got - want).norm(dim=-1) / norm.clamp(min=floor)


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


def host_us(fn, calls: int = 200) -> float:
    """Host time of one ``fn()`` in µs: ``calls`` calls issued without a
    sync (the card keeps up with a short kernel, so this is the call's host
    side: checks, allocation, launches)."""
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


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph,
    the graph replayed ``reps`` times between two events. A call whose host
    side (checks, allocation, two launches) takes longer than its kernels
    is timed by ``time_ms`` at the host's rate; a replay has no host side."""
    import torch
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


def profiled_ms(fn, calls: int = 5):
    """Device time of one ``fn()`` summed over the kernels it launches,
    from torch.profiler over ``calls`` calls after a warm-up, and those
    kernels by name: [(name, ms a call)], the longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [(e.key, getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
                / calls / 1e3) for e in prof.key_averages()]
    kernels = sorted([k for k in kernels if k[1] > 0], key=lambda k: -k[1])
    return sum(t for _, t in kernels), kernels


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
        entry = ""
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]          # mangled kernel name
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {entry}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main paths' shapes
# ---------------------------------------------------------------------------

def decode_table(lens_host, S: int, page: int, seed: int):
    """A shuffled block table [B, pps] (pps * page >= S) for rows of the
    given lengths: each row's pages scattered over a pool of P pages, the
    entries past a row's length at the scratch page 0. Returns (tables,
    P)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    B, pps = len(lens_host), -(-S // page)
    P = 1 + B * pps + 5
    perm = 1 + rng.permutation(P - 1)[:B * pps]
    tables = np.zeros((B, pps), np.int32)
    for b in range(B):
        used = -(-int(lens_host[b]) // page)
        tables[b, :used] = perm[b * pps:b * pps + used]
    return tables, P


def decode_inputs(gen, B, Hkv, g, D, S, dtype, tables, P, page):
    """q [B, Hq, D]; the dense cache in the engine's layout [B, S, Hkv, D]
    (as the [B, Hkv, S, D] views the model passes); and a page pool [P,
    page, Hkv, D] holding the same rows through ``tables``. Pool pages no
    row owns (page 0 included) hold finite garbage that must never reach
    the softmax."""
    import torch
    dev = torch.device("cuda")
    q = torch.randn((B, Hkv * g, D), generator=gen, device=dev).to(dtype)
    ck = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    cv = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    pk = torch.full((P, page, Hkv, D), 3e4, device=dev, dtype=dtype)
    pv = torch.full((P, page, Hkv, D), -3e4, device=dev, dtype=dtype)
    for b in range(B):
        for j in range(tables.shape[1]):
            if tables[b, j]:
                n = min(page, S - j * page)
                pk[tables[b, j], :n] = ck[b, j * page:j * page + n]
                pv[tables[b, j], :n] = cv[b, j * page:j * page + n]
    return {"q": q, "k": ck.transpose(1, 2), "v": cv.transpose(1, 2),
            "pk": pk, "pv": pv}


def decode_kv_chunk() -> int:
    """The decode kernels' split length ``kChunk``, read from their source
    (the ragged lengths sit around it)."""
    import re
    src = (ROOT / "src" / "repro_torch" / "kernels" / "decode_attention" /
           "csrc" / "decode_attention.cu").read_text()
    return int(re.search(r"constexpr int kChunk = (\d+);", src).group(1))


def log_decode_build() -> None:
    """ptxas registers and spills of each decode-attention instantiation
    (the split kernel by dtype, head_dim and layout; the combine by dtype
    and head_dim)."""
    import re
    from repro_torch.kernels import build
    entry = ""
    for line in build.build_log("decode_attention").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            m = re.search(r"decode_attn_splitI(13__nv_bfloat16|f)Li(\d+)ELb"
                          r"([01])E", entry)
            c = re.search(r"decode_attn_combineI(13__nv_bfloat16|f)Li(\d+)E",
                          entry)
            if m:
                what = (f"split {'f32' if m.group(1) == 'f' else 'bf16'} d "
                        f"{m.group(2)} "
                        f"{'paged' if m.group(3) == '1' else 'dense'}")
            elif c:
                what = (f"combine {'f32' if c.group(1) == 'f' else 'bf16'} d "
                        f"{c.group(2)}")
            else:
                continue
            log(f"[build] decode_attention {what}: {line.strip()}")


def log_kernel_parts(label: str, fn, key: str, calls: int = 20) -> None:
    """Device time a launch, and the launches, of each kernel ``fn``
    launches whose name the regex ``key`` finds (a split and its combine;
    the SSD route's kernels), named by the match and the rest of its word,
    from torch.profiler over ``calls`` calls."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        m = re.search(f"(?:{key})\\w*", e.key)
        if m and t > 0:
            kind = m.group(0)
            parts.append(f"{kind} {t / max(e.count, 1) / 1e3:.4f} ms a "
                         f"launch x{e.count}")
    log(f"[kernels] {label} device time, {calls} calls profiled: "
        f"{', '.join(parts)}")


def decode_run(x, lengths, tbl):
    """Both decode kernels on the dense and paged copies of one cache."""
    from repro_torch.kernels.decode_attention import decode_attention as DA
    return (DA.decode_attention(x["q"], x["k"], x["v"], lengths),
            DA.paged_decode_attention(x["q"], x["pk"], x["pv"], lengths, tbl))


def decode_check(label, x, lengths, outs, tol) -> float:
    """Both decode kernels' outputs against the f32 plain version (rows of
    length 0 give zeros, as from the Pallas kernels) and paged against
    dense bit for bit; returns the largest error."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention as DA
    ref = DA.decode_attention_ref(x["q"].float(), x["k"].float(),
                                  x["v"].float(), lengths)
    ref[lengths == 0] = 0
    worst = 0.0
    for name, out in zip(("decode_attention", "paged_decode_attention"),
                         outs):
        err = (out.float() - ref).abs()
        bad = err > tol + tol * ref.abs()
        worst = max(worst, float(err.max()))
        if not torch.isfinite(out).all() or bool(bad.any()):
            fail(f"{name} ({label}): kernel disagrees with its plain "
                 f"version (max abs err {float(err.max()):.3e}, "
                 f"{int(bad.sum())} elements past atol=rtol={tol})")
    if not torch.equal(outs[0], outs[1]):
        fail(f"paged_decode_attention ({label}): not bit-identical to "
             f"the dense kernel on the same logical cache "
             f"({int((outs[0] != outs[1]).sum())} elements)")
    return worst


def phase_kernels(cfg, moe_cfg, sm_cfg, vl_cfg):
    """decode_attention and paged_decode_attention against their plain
    versions. First ragged lengths 0, 1, kChunk - 1, kChunk, kChunk + 1 and
    S at the four served shapes — minitron-8b (Hkv 8, g 4, D 128),
    qwen3-moe-30b-a3b (Hkv 4, g 8, D 128), seamless-m4t-medium's decoder
    (Hkv 16, g 1, D 64) and qwen2-vl-72b (Hkv 8, g 8, D 128) — in bf16
    (against the f32 plain version, atol = rtol = 1e-2) and f32 (1e-5),
    paged through page 48 (off kChunk, pps * page != S); a row of length
    0 gives zeros, as from the Pallas kernels (the plain version gives the
    mean of V there). Then the splits'
    combine order, pinned exactly by a cancellation in f32. Then the
    first three served shapes at the engines' lengths (1 ... 2048, page
    128), timed by ``time_decode`` (qwen2-vl-72b's are timed on its path,
    at the batches it serves). Paged output must equal dense output bit
    for bit in every case."""
    import numpy as np
    import torch

    log_decode_build()
    S = 2048
    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(1234)
    kc = decode_kv_chunk()
    shapes = [(cfg.name, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
               cfg.head_dim),
              (moe_cfg.name, moe_cfg.num_kv_heads,
               moe_cfg.num_heads // moe_cfg.num_kv_heads, moe_cfg.head_dim),
              (f"{sm_cfg.name} decoder", sm_cfg.num_kv_heads,
               sm_cfg.num_heads // sm_cfg.num_kv_heads, sm_cfg.head_dim),
              (vl_cfg.name, vl_cfg.num_kv_heads,
               vl_cfg.num_heads // vl_cfg.num_kv_heads, vl_cfg.head_dim)]

    ragged = np.array([0, 1, kc - 1, kc, kc + 1, S], np.int32)
    tables, P = decode_table(ragged, S, 48, seed=11)
    lengths = torch.from_numpy(ragged).to(dev)
    tbl = torch.from_numpy(tables).to(dev)
    for label, Hkv, g, D in shapes:
        for dtype, tol in ((bf16, ATOL), (f32, F32_TOL)):
            x = decode_inputs(gen, len(ragged), Hkv, g, D, S, dtype, tables,
                              P, 48)
            torch.cuda.synchronize()
            decode_check(f"{label} ragged {dtype}", x, lengths,
                         decode_run(x, lengths, tbl), tol)
    torch.cuda.synchronize()
    log(f"[kernels] decode attention agrees with its plain version at "
        f"lengths {ragged.tolist()} (kChunk {kc}) at the four served "
        f"shapes in bf16 (atol=rtol={ATOL}) and f32 ({F32_TOL}); paged "
        f"(page 48, pps * page {tables.shape[1] * 48} != S {S}) == dense "
        f"bit for bit")

    # the splits are combined in split order: V rows of 2^16 in split 0, a
    # single 1 in split 1, -2^16 in split 2, all scores 0. In f32,
    # (2^24 + 1) - 2^24 = 0, while any other order gives 1/(3 kChunk)
    one = np.array([3 * kc], np.int32)
    ot, oP = decode_table(one, 3 * kc, 48, seed=12)
    x = decode_inputs(gen, 1, 1, 2, 64, 3 * kc, f32, ot, oP, 48)
    x["q"].fill_(1.0)
    for key in ("k", "v", "pk", "pv"):
        x[key].zero_()
    x["v"][0, 0, :kc] = 2.0 ** 16
    x["v"][0, 0, kc] = 1.0
    x["v"][0, 0, 2 * kc:] = -2.0 ** 16
    for b, j in zip(*np.nonzero(ot)):
        x["pv"][ot[b, j], :, 0] = x["v"][b, 0, j * 48:(j + 1) * 48]
    outs = decode_run(x, torch.from_numpy(one).to(dev),
                      torch.from_numpy(ot).to(dev))
    torch.cuda.synchronize()
    for name, out in zip(("decode_attention", "paged_decode_attention"),
                         outs):
        if bool(out.any()):
            fail(f"{name}: the splits were not combined in split order "
                 f"(max {float(out.abs().max()):.3e}, expected exactly 0)")
    log("[kernels] decode attention combines its splits in split order "
        "(an f32 cancellation across three splits gives exactly 0)")

    # the served shapes at the engines' lengths, timed
    lens_host = np.array([1, S - 1, S, 517, 1024, 1500, 129, 64], np.int32)
    rows = {}
    for label, Hkv, g, D in shapes[:3]:
        time_decode(rows, gen, label, Hkv, g, D, lens_host, S)
    return rows


def time_decode(rows, gen, label, Hkv, g, D, lens_host, S: int) -> None:
    """Both decode kernels at one served shape — rows of ``lens_host``
    lengths in a cache of S (paged: pages of 128) — checked against the
    plain version, then timed beside the plain version and SDPA by eager
    calls (``ms``, host side included, as every kernel row) and by
    CUDA-graph replay (``device_ms``), with the least time the card could
    take; the kernel's parts by device time. Appends a shape to each
    kernel's JSON row in ``rows`` (made by the first shape). Inputs of the
    timed launches rotate over 4 sets."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention as DA
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    lens_host = np.asarray(lens_host, np.int32)
    B, page = len(lens_host), 128
    tables, P = decode_table(lens_host, S, page, seed=7)
    lengths = torch.from_numpy(lens_host).to(dev)
    tbl = torch.from_numpy(tables).to(dev)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]            # [B, 1, 1, S]
    valid_rows = int(lens_host.sum())
    Hq = Hkv * g
    # timed launches rotate over input sets larger than the 50 MB L2
    # together, so each launch reads its K/V from device memory, as a
    # decode step does after the other layers have passed through L2
    sets = [decode_inputs(gen, B, Hkv, g, D, S, bf16, tables, P, page)
            for _ in range(4)]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]

    def sdpa(x):
        return F.scaled_dot_product_attention(
            x["q"][:, :, None], x["k"], x["v"], attn_mask=mask,
            enable_gqa=True)

    err = decode_check(f"{label} B {B} S {S}", sets[0], lengths,
                       decode_run(sets[0], lengths, tbl), ATOL)
    kv_bytes = 2 * valid_rows * Hkv * D * 2
    qo_bytes = 2 * B * Hq * D * 2 + B * 4
    flops = 4 * valid_rows * Hq * D
    shape = (f"{label} B {B} Hq {Hq} Hkv {Hkv} D {D} S {S} lengths "
             f"{lens_host.tolist() if B <= 4 else '1 ... ' + str(S)} bf16")
    for name, kern, plain, nbytes in (
            ("decode_attention",
             lambda x: DA.decode_attention(x["q"], x["k"], x["v"], lengths),
             lambda x: DA.decode_attention_ref(x["q"], x["k"], x["v"],
                                               lengths),
             kv_bytes + qo_bytes),
            ("paged_decode_attention",
             lambda x: DA.paged_decode_attention(x["q"], x["pk"], x["pv"],
                                                 lengths, tbl),
             lambda x: DA.paged_decode_attention_ref(
                 x["q"], x["pk"], x["pv"], lengths, tbl),
             kv_bytes + qo_bytes + B * tables.shape[1] * 4)):
        # ms: eager calls back to back, as every kernel row is timed
        # (host-bound here: a call's host side outlasts its kernels);
        # device_ms: the same calls replayed from a CUDA graph, which has
        # no host side
        ms = time_ms(lambda: kern(nxt()))
        device_ms = graph_ms(lambda: kern(nxt()))
        plain_ms = time_ms(lambda: plain(nxt()), iters=10)
        # the library call on the linear [B, Hkv, S, D] view (for the
        # paged row too: PyTorch has no single call that reads a block
        # table), timed both ways
        library_ms = time_ms(lambda: sdpa(nxt()))
        library_device_ms = graph_ms(lambda: sdpa(nxt()))
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        log(f"[kernels] {name} ({shape}): max_abs_err {err:.3e} "
            f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{library_ms:.4f} bound_ms {bound_ms:.4f} (bytes; "
            f"{nbytes / 1e6:.1f} MB moved at least) x library "
            f"{ms / library_ms:.2f}; by graph replay: kernel "
            f"{device_ms:.4f}, library {library_device_ms:.4f}, x "
            f"library {device_ms / library_device_ms:.2f}, "
            f"{bound_ms / device_ms:.1%} of bound")
        log_kernel_parts(f"{name} ({label} B {B})", lambda: kern(nxt()),
                         "decode_attn")
        if name not in rows:              # the JSON row: the first shape
            rows[name] = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/decode_attention/"
                          "csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention/"
                            "decode_attention.py:"
                            + ("88" if name == "decode_attention" else "205"),
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "library_ms": library_ms,
                "device_ms": device_ms,
                "library_device_ms": library_device_ms, "shapes": []}
        rows[name]["shapes"].append({
            "shape": shape, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "ratio": ms / library_ms,
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "device_ratio": device_ms / library_device_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "max_abs_err": err})
    log(f"[kernels] library_ms: decode attention ({label} B {B}) — "
        f"torch.nn.functional.scaled_dot_product_attention (boolean length "
        f"mask, enable_gqa) on the linear [B, Hkv, S, D] views; paged "
        f"output bit-identical to dense output")
    del sets
    torch.cuda.empty_cache()


def phase_moe_kernels(moe_cfg, d_adapter: int):
    """The grouped GEMMs against their plain versions: qwen3-moe's expert
    FFN at decode (C 8) and prefill (C 160) capacities, bf16, and the
    adapter route's two f32 products (9 table rows incl. the null row, 8
    slots, d 4096, rank 8). Inputs rotate over 4 sets; the expert weights
    of one set are 2 GB, so each launch reads them from device memory. The
    adapter tables (1.2 MB a set) fit in the 50 MB L2 together."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm as MG

    E, D, Fd = moe_cfg.num_experts, moe_cfg.d_model, moe_cfg.moe_d_ff
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def weights():
        wg, wu = randn((E, D, Fd), D ** -0.5, dt), randn((E, D, Fd),
                                                         D ** -0.5, dt)
        return {"wg": wg, "wu": wu, "wcat": torch.cat([wg, wu], dim=-1),
                "wd": randn((E, Fd, D), Fd ** -0.5, dt),
                "A": randn((9, d_adapter, 8), d_adapter ** -0.5,
                           torch.float32),
                "B": randn((9, 8, d_adapter), 8 ** -0.5, torch.float32)}

    sets = [weights() for _ in range(4)]
    for w in sets:
        for C in (8, 160):
            w[f"x{C}"] = randn((E, C, D), 1.0, dt)
            w[f"a{C}"] = randn((E, C, Fd), 1.0, dt)
        w["h"] = randn((9, 8, d_adapter), 1.0, torch.float32)
        w["t"] = randn((9, 8, 8), 1.0, torch.float32)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]

    def f32(*ts):
        return [t.float() for t in ts]

    def ffn_case(C):
        return ("moe_ffn_fused", f"E {E} C {C} D {D} F {Fd} bf16",
                lambda w: MG.moe_ffn_fused(w[f"x{C}"], w["wg"], w["wu"]),
                lambda w: MG.moe_ffn_fused_ref(w[f"x{C}"], w["wg"], w["wu"]),
                lambda w: MG.moe_ffn_fused_ref(*f32(w[f"x{C}"], w["wg"],
                                                    w["wu"])),
                lambda w: torch.bmm(w[f"x{C}"], w["wcat"]),
                2 * (E * C * D + 2 * E * D * Fd + E * C * Fd),
                4 * E * C * D * Fd, BF16_FLOPS, ATOL)

    def down_case(C):
        return ("moe_gemm", f"w_down E {E} C {C} D {Fd} F {D} bf16",
                lambda w: MG.moe_gemm(w[f"a{C}"], w["wd"]),
                lambda w: MG.moe_gemm_ref(w[f"a{C}"], w["wd"]),
                lambda w: MG.moe_gemm_ref(*f32(w[f"a{C}"], w["wd"])),
                lambda w: torch.bmm(w[f"a{C}"], w["wd"]),
                2 * (E * C * Fd + E * Fd * D + E * C * D),
                2 * E * C * Fd * D, BF16_FLOPS, ATOL)

    def adapter_case(x, w, label, C, Din, Fo):
        return ("moe_gemm", f"adapter {label} E 9 C {C} D {Din} F {Fo} f32",
                lambda s: MG.moe_gemm(s[x], s[w]),
                lambda s: MG.moe_gemm_ref(s[x], s[w]),
                lambda s: MG.moe_gemm_ref(s[x], s[w]),
                lambda s: torch.bmm(s[x], s[w]),
                4 * (9 * C * Din + 9 * Din * Fo + 9 * C * Fo),
                2 * 9 * C * Din * Fo, F32_FLOPS, F32_TOL)

    # ragged edges first: C, D, F off every tile size, strided x (rows 3..
    # of a [E, C + 3, D] buffer), an empty expert (row 0). f32, and bf16
    # with D or F off 8, run the CUDA-core template; the other bf16 cases
    # the tensor-core variant at its edges: C 1, 9 (a partial n8 tile), 40,
    # 161 and 300 (two chunks each, past the 160-row cap); F 8, 72, 136; D
    # 16, 48 and 2048
    for (Eo, Co, Do, Fo), dtype in (((3, 5, 37, 19), torch.float32),
                                    ((2, 70, 8, 130), torch.bfloat16),
                                    ((4, 1, 200, 8), torch.float32),
                                    ((5, 9, 64, 72), torch.bfloat16),
                                    ((3, 1, 48, 136), torch.bfloat16),
                                    ((4, 9, 16, 8), torch.bfloat16),
                                    ((3, 161, 48, 72), torch.bfloat16),
                                    ((2, 300, 16, 136), torch.bfloat16),
                                    ((5, 40, 2048, 768), torch.bfloat16)):
        xo = randn((Eo, Co + 3, Do), 1.0, dtype)[:, 3:]   # row stride Do
        xo[0] = 0
        wgo, wuo = randn((Eo, Do, Fo), 0.3, dtype), randn((Eo, Do, Fo), 0.3,
                                                          dtype)
        tol = ATOL if dtype == torch.bfloat16 else F32_TOL
        tc = dtype == torch.bfloat16 and Do % 8 == 0 and Fo % 8 == 0
        if MG.uses_tensor_cores(xo, wgo, wuo) != tc:
            fail(f"E {Eo} C {Co} D {Do} F {Fo} {dtype}: the rule sends it "
                 f"to the {'CUDA-core' if tc else 'tensor-core'} variant")
        for name, got, ref in (
                ("moe_gemm", MG.moe_gemm(xo, wgo),
                 MG.moe_gemm_ref(xo.float(), wgo.float())),
                ("moe_ffn_fused", MG.moe_ffn_fused(xo, wgo, wuo),
                 MG.moe_ffn_fused_ref(xo.float(), wgo.float(),
                                      wuo.float()))):
            err = (got.float() - ref).abs()
            if bool((err > tol + tol * ref.abs()).any()) \
                    or not torch.isfinite(got).all():
                fail(f"{name} at E {Eo} C {Co} D {Do} F {Fo} {dtype}: max "
                     f"abs err {float(err.max()):.3e} past {tol}")
    log("[kernels] grouped GEMMs agree with their plain versions at ragged "
        "shapes (C 1-300, D 8-2048, F 8-768, strided x, zero rows; all "
        "three variants)")

    # the narrow variant (f32 moe_gemm, D or F rank-sized): ranks 4-16 as D
    # or F, D off a 128-row split, C 1-72, strided x, an empty group; then
    # a row's bits at C 1, 8 and 72, at any position, in another expert
    for Eo, Co, Do, Fo in ((9, 8, 4096, 8), (9, 8, 8, 4096), (3, 4, 256, 4),
                           (3, 4, 4, 256), (2, 72, 300, 12), (2, 1, 12, 264),
                           (5, 9, 4100, 16), (2, 70, 16, 4096)):
        xo = randn((Eo, Co + 3, Do), 1.0, torch.float32)[:, 3:]
        xo[0] = 0
        wo = randn((Eo, Do, Fo), Do ** -0.5, torch.float32)
        if not MG.uses_narrow(xo, wo):
            fail(f"E {Eo} C {Co} D {Do} F {Fo} f32: not the narrow variant")
        got, ref = MG.moe_gemm(xo, wo), MG.moe_gemm_ref(xo, wo)
        err = (got - ref).abs()
        if bool((err > F32_TOL + F32_TOL * ref.abs()).any()) \
                or not torch.isfinite(got).all() or bool(got[0].any()):
            fail(f"moe_gemm narrow at E {Eo} C {Co} D {Do} F {Fo}: max abs "
                 f"err {float(err.max()):.3e} past {F32_TOL}")
    for Do, Fo in ((d_adapter, 8), (8, d_adapter), (256, 4), (4, 256)):
        wo = randn((1, Do, Fo), Do ** -0.5, torch.float32).expand(2, -1, -1)
        row = randn((Do,), 1.0, torch.float32)
        outs = []
        for Co, pos, e in ((1, 0, 0), (8, 0, 0), (8, 5, 1), (72, 71, 0),
                           (72, 37, 1)):
            xo = randn((2, Co, Do), 1.0, torch.float32)
            xo[e, pos] = row
            outs.append(MG.moe_gemm(xo, wo.contiguous())[e, pos])
        if not all(torch.equal(o, outs[0]) for o in outs):
            fail(f"moe_gemm narrow D {Do} F {Fo}: a row's output depends on "
                 f"C or its position")
    log("[kernels] narrow variant agrees with its plain version (ranks 4-16 "
        "as D or F, D off a split, C 1-72, strided x, an empty group); a "
        "row's bits equal at C 1, 8, 72, any position, either expert")

    # the main path's four shapes take the tensor-core variant, and a row's
    # bits depend on D alone: rows 0-7 at C 160 (the prefill block shape,
    # 16 warps) equal the C 8 output (the decode shape, 8 warps) bit for bit
    w = sets[0]
    for x, ws in ((w["x8"], (w["wg"], w["wu"])), (w["x160"], (w["wg"],
                                                              w["wu"])),
                  (w["a8"], (w["wd"],)), (w["a160"], (w["wd"],))):
        if not MG.uses_tensor_cores(x, *ws):
            fail(f"x {tuple(x.shape)}: a main-path shape does not take the "
                 f"tensor-core variant")
    for name, wide, narrow in (
            ("moe_ffn_fused", MG.moe_ffn_fused(w["x160"], w["wg"], w["wu"]),
             MG.moe_ffn_fused(w["x160"][:, :8], w["wg"], w["wu"])),
            ("moe_gemm", MG.moe_gemm(w["a160"], w["wd"]),
             MG.moe_gemm(w["a160"][:, :8], w["wd"]))):
        if not torch.equal(wide[:, :8], narrow):
            fail(f"{name}: rows 0-7 at C 160 differ from the C 8 output "
                 f"({int((wide[:, :8] != narrow).sum())} elements)")
    log("[kernels] main-path shapes take the tensor-core variant; rows 0-7 "
        "at C 160 equal C 8 bit for bit (both kernels)")

    for x, w in (("h", "A"), ("t", "B")):
        if not MG.uses_narrow(sets[0][x], sets[0][w]):
            fail(f"adapter {x}@{w}: does not take the narrow variant")
    cases = [ffn_case(8), ffn_case(160), down_case(8), down_case(160),
             adapter_case("h", "A", "h@A", 8, d_adapter, 8),
             adapter_case("t", "B", "t@B", 8, 8, d_adapter)]
    rows = {}
    for (name, shape, kern, plain, plain_f32, library, nbytes, flops, peak,
         tol) in cases:
        out = kern(sets[0])
        torch.cuda.synchronize()
        ref = plain_f32(sets[0])
        err = (out.float() - ref.float()).abs()
        bad = err > tol + tol * ref.float().abs()
        if not torch.isfinite(out).all() or bool(bad.any()):
            fail(f"{name} ({shape}): kernel disagrees with its plain version "
                 f"(max abs err {float(err.max()):.3e}, {int(bad.sum())} "
                 f"elements past atol=rtol={tol})")
        # ms: eager calls back to back (host side included); device_ms:
        # the same calls replayed from a CUDA graph (no host side)
        ms = time_ms(lambda: kern(nxt()))
        device_ms = graph_ms(lambda: kern(nxt()))
        plain_ms = time_ms(lambda: plain(nxt()), iters=10)
        library_ms = time_ms(lambda: library(nxt()))
        library_device_ms = graph_ms(lambda: library(nxt()))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernels] {name} ({shape}): max_abs_err "
            f"{float(err.max()):.3e} kernel_ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
            f"{bound_ms:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP) x library {ms / library_ms:.2f}; by "
            f"graph replay: kernel {device_ms:.4f}, library "
            f"{library_device_ms:.4f}, x library "
            f"{device_ms / library_device_ms:.2f}, "
            f"{bound_ms / device_ms:.1%} of bound")
        if shape.startswith("adapter"):   # eager here is the host side
            log(f"[kernels] {name} ({shape}): host µs a call, kernel "
                f"{host_us(lambda: kern(nxt())):.2f}, library "
                f"{host_us(lambda: library(nxt())):.2f}")
        if name not in rows:            # the JSON row: the MoE decode shape
            rows[name] = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu",
                "replaces": "src/repro/kernels/moe_gemm/moe_gemm.py:"
                            + ("90" if name == "moe_ffn_fused" else "65"),
                "launches": 0, "max_abs_err": float(err.max()), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "device_ms": device_ms,
                "library_device_ms": library_device_ms, "shapes": []}
        # every measured shape (decode C 8, prefill C 160, the adapter
        # products) in the row, with its ratio to the library call
        rows[name]["shapes"].append({
            "shape": shape, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "ratio": ms / library_ms,
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "device_ratio": device_ms / library_device_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": float(err.max())})
    log("[kernels] library_ms: torch.bmm (f32 products in full f32, no "
        "TF32); for moe_ffn_fused, torch.bmm on the [E, D, 2F] concatenation "
        "of w_gate and w_up (the yardstick: no single call computes the "
        "fused function)")
    del sets
    torch.cuda.empty_cache()
    return rows


def phase_moe_bwd_kernels(moe_cfg):
    """The expert kernels' backward against its plain versions: K1
    ``moe_ffn_fused_bwd`` (dg, du; its check output, the forward from the
    recomputed gate and up, equal to ``moe_ffn_fused``'s bit for bit), K2
    ``moe_gemm_dx`` (one pair and two) and K3 ``moe_gemm_dw`` (one output
    and two). Ragged shapes first (C 1-200, D and F off every tile, C off 8
    for K3; bf16 on the tensor cores and on the CUDA cores, f32), then
    qwen3-moe's smoke shapes in f32, then the training path's (E 128, C
    160, D 2048, F 768; the tensor-core route asserted), each timed eager
    and by graph replay beside ``torch.bmm`` on the same products. bf16
    is held row by row within BWD_ROW of each row's norm, f32 within
    F32_TOL. First K1's, K2's and K3's build lines and the bit probe
    (their wgmma shapes and layouts against mma.sync); at the train shapes
    also bit for bit: K1, K2 and K3 by graph replay == eager, K1's and
    K2's rows 0-7 of the C 160 call == a C 8 call, K1's and K3's expert 0
    of the E 128 call == that expert alone at E 1."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.moe_gemm import moe_gemm as MG

    log_grad_build()
    i8_probe_line()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2718)

    def randn(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def held(what, got, want):
        if got.shape != want.shape or got.dtype != want.dtype \
                or not torch.isfinite(got).all():
            fail(f"{what}: {tuple(got.shape)} {got.dtype} against "
                 f"{tuple(want.shape)} {want.dtype}, or not finite")
        if got.dtype == torch.bfloat16:
            err = float(row_err(got, want).max())
            if err > BWD_ROW:
                fail(f"{what}: a row is {err:.3e} of its norm off the plain "
                     f"version (> {BWD_ROW})")
            return err
        err = (got - want).abs()
        if bool((err > F32_TOL + F32_TOL * want.abs()).any()):
            fail(f"{what}: max abs err {float(err.max()):.3e} past "
                 f"{F32_TOL}")
        return float(err.max())

    def inputs(E, C, D, Fo, dtype):
        return {"x": randn((E, C, D), 1.0, dtype),
                "wg": randn((E, D, Fo), D ** -0.5, dtype),
                "wu": randn((E, D, Fo), D ** -0.5, dtype),
                "wd": randn((E, Fo, D), Fo ** -0.5, dtype),
                "dout": randn((E, C, Fo), 1.0, dtype),
                "act": randn((E, C, Fo), 1.0, dtype),
                "dy": randn((E, C, D), 1.0, dtype)}

    def check(E, C, D, Fo, dtype, tc, w=None):
        """Every kernel at one shape against its plain version; returns
        the worst error and the inputs with the kernels' dg and du."""
        w = w or inputs(E, C, D, Fo, dtype)
        label = f"E {E} C {C} D {D} F {Fo} {str(dtype)[6:]}"
        before = dict(MG.BWD_TENSOR_CORE_LAUNCHES)
        y = torch.empty((E, C, Fo), dtype=dtype, device=dev)
        dg, du = MG.moe_ffn_fused_bwd(w["x"], w["wg"], w["wu"], w["dout"],
                                      y=y)
        pg, pu = MG.moe_ffn_fused_bwd_ref(w["x"], w["wg"], w["wu"],
                                          w["dout"])
        with torch.no_grad():
            fwd = MG.moe_ffn_fused(w["x"], w["wg"], w["wu"])
        if not torch.equal(y, fwd):
            fail(f"moe_ffn_fused_bwd ({label}): the forward from its "
                 f"recomputed gate and up differs from moe_ffn_fused's in "
                 f"{int((y != fwd).sum())} elements")
        w["dg"], w["du"] = dg, du
        errs = [held(f"moe_ffn_fused_bwd dg ({label})", dg, pg),
                held(f"moe_ffn_fused_bwd du ({label})", du, pu)]
        for what, got, want in (
                ("moe_gemm_dx down", [MG.moe_gemm_dx((w["dy"],),
                                                     (w["wd"],))],
                 [MG.moe_gemm_dx_ref((w["dy"],), (w["wd"],))]),
                ("moe_gemm_dx gate/up", [MG.moe_gemm_dx((dg, du),
                                                        (w["wg"], w["wu"]))],
                 [MG.moe_gemm_dx_ref((dg, du), (w["wg"], w["wu"]))]),
                ("moe_gemm_dw down", MG.moe_gemm_dw(w["act"], (w["dy"],)),
                 MG.moe_gemm_dw_ref(w["act"], (w["dy"],))),
                ("moe_gemm_dw gate/up", MG.moe_gemm_dw(w["x"], (dg, du)),
                 MG.moe_gemm_dw_ref(w["x"], (dg, du)))):
            errs += [held(f"{what} ({label})", g, r)
                     for g, r in zip(got, want)]
        took = {k: MG.BWD_TENSOR_CORE_LAUNCHES[k] - before[k]
                for k in before}
        if took != ({"moe_ffn_fused_bwd": 1, "moe_gemm_dx": 2,
                     "moe_gemm_dw": 2} if tc else dict.fromkeys(took, 0)):
            fail(f"backward kernels at {label}: tensor-core launches "
                 f"{took}, expected {'all' if tc else 'none'}")
        return max(errs), w

    worst = 0.0
    for (E, C, D, Fo), dtype, tc in (
            ((3, 1, 16, 8), torch.bfloat16, True),
            ((2, 9, 48, 72), torch.bfloat16, True),
            ((4, 37, 40, 136), torch.bfloat16, True),
            ((2, 161, 64, 24), torch.bfloat16, True),
            ((2, 200, 264, 40), torch.bfloat16, True),
            ((3, 70, 2056, 16), torch.bfloat16, True),
            ((2, 9, 36, 20), torch.bfloat16, False),
            ((3, 70, 8, 130), torch.bfloat16, False),
            ((3, 5, 37, 19), torch.float32, False),
            ((2, 161, 72, 40), torch.float32, False)):
        worst = max(worst, check(E, C, D, Fo, dtype, tc)[0])
    log(f"[kernels] moe_*_bwd agree with their plain versions at ragged "
        f"shapes (C 1-200, D 8-2056, F 8-136, C off 8 for K3; bf16 on the "
        f"tensor and CUDA cores, f32): worst {worst:.3e}; K1's forward from "
        f"its recompute == moe_ffn_fused bit for bit")
    sm = dataclasses.replace(get_smoke_config(moe_cfg.name),
                             dtype="float32")
    E, D, Fo = sm.num_experts, sm.d_model, sm.moe_d_ff
    for C in (8, 64):
        err = check(E, C, D, Fo, torch.float32, False)[0]
        log(f"[kernels] moe_*_bwd at {sm.name} (smoke) E {E} C {C} D {D} F "
            f"{Fo} f32 (CUDA cores): max abs err {err:.3e}")

    # the training path's shapes: a 2048-token chunk's capacity, C 160
    E, D, Fo = moe_cfg.num_experts, moe_cfg.d_model, moe_cfg.moe_d_ff
    C, dt = 160, torch.bfloat16
    sets = []
    for i in range(2):
        err, w = check(E, C, D, Fo, dt, True)
        log(f"[kernels] moe_*_bwd at the train shapes E {E} C {C} D {D} F "
            f"{Fo} bf16, set {i}: worst row {err:.3e} of its norm (tensor "
            f"cores; K1's forward == moe_ffn_fused bit for bit)")
        w["wcat"] = torch.cat([w["wg"], w["wu"]], dim=-1)
        w["dcat"] = torch.cat([w["dg"], w["du"]], dim=-1)
        sets.append(w)
    check_grad_bits(sets[0])
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]

    ecd, edf, ecf = E * C * D, E * D * Fo, E * C * Fo
    cases = [
        ("moe_ffn_fused_bwd", "K1 gate/up",
         lambda w: MG.moe_ffn_fused_bwd(w["x"], w["wg"], w["wu"], w["dout"]),
         lambda w: MG.moe_ffn_fused_bwd_ref(w["x"], w["wg"], w["wu"],
                                            w["dout"]),
         lambda w: torch.bmm(w["x"], w["wcat"]),
         2 * (ecd + 2 * edf + 3 * ecf), 4 * E * C * D * Fo),
        ("moe_gemm_dx", "K2 down (one pair)",
         lambda w: MG.moe_gemm_dx((w["dy"],), (w["wd"],)),
         lambda w: MG.moe_gemm_dx_ref((w["dy"],), (w["wd"],)),
         lambda w: torch.bmm(w["dy"], w["wd"].transpose(1, 2)),
         2 * (ecd + edf + ecf), 2 * E * C * D * Fo),
        ("moe_gemm_dx", "K2 gate/up (two pairs)",
         lambda w: MG.moe_gemm_dx((w["dg"], w["du"]), (w["wg"], w["wu"])),
         lambda w: MG.moe_gemm_dx_ref((w["dg"], w["du"]),
                                      (w["wg"], w["wu"])),
         lambda w: torch.bmm(w["dcat"], w["wcat"].transpose(1, 2)),
         2 * (2 * ecf + 2 * edf + ecd), 4 * E * C * D * Fo),
        ("moe_gemm_dw", "K3 down (one output)",
         lambda w: MG.moe_gemm_dw(w["act"], (w["dy"],)),
         lambda w: MG.moe_gemm_dw_ref(w["act"], (w["dy"],)),
         lambda w: torch.bmm(w["act"].transpose(1, 2), w["dy"]),
         2 * (ecf + ecd + edf), 2 * E * C * D * Fo),
        ("moe_gemm_dw", "K3 gate/up (two outputs)",
         lambda w: MG.moe_gemm_dw(w["x"], (w["dg"], w["du"])),
         lambda w: MG.moe_gemm_dw_ref(w["x"], (w["dg"], w["du"])),
         lambda w: torch.bmm(w["x"].transpose(1, 2), w["dcat"]),
         2 * (ecd + 2 * ecf + 2 * edf), 4 * E * C * D * Fo)]
    rows = {}
    for name, what, kern, plain, library, nbytes, flops in cases:
        out = kern(sets[0])
        out = out if isinstance(out, (list, tuple)) else [out]
        ref = plain(sets[0])
        ref = ref if isinstance(ref, (list, tuple)) else [ref]
        err = max(float(row_err(o, r).max()) for o, r in zip(out, ref))
        ms = time_ms(lambda: kern(nxt()), iters=20)
        device_ms = graph_ms(lambda: kern(nxt()), iters=10, reps=3)
        plain_ms = time_ms(lambda: plain(nxt()), iters=3, warmup=1)
        library_ms = time_ms(lambda: library(nxt()), iters=20)
        library_device_ms = graph_ms(lambda: library(nxt()), iters=10,
                                     reps=3)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        shape = f"{what} E {E} C {C} D {D} F {Fo} bf16"
        log(f"[kernels] {name} ({shape}): worst row {err:.3e} of its norm; "
            f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{library_ms:.4f} bound_ms {bound_ms:.4f} (by {bound_by}: "
            f"{nbytes / 1e6:.1f} MB in {t_bytes * 1e3:.4f} ms, "
            f"{flops / 1e9:.2f} GFLOP in {t_ops * 1e3:.4f} ms) x library "
            f"{ms / library_ms:.2f}; by graph replay: kernel "
            f"{device_ms:.4f}, library {library_device_ms:.4f}, x library "
            f"{device_ms / library_device_ms:.2f}, "
            f"{bound_ms / device_ms:.1%} of bound; {card()}")
        if name not in rows:            # the JSON row: the first case
            rows[name] = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu",
                "replaces": "src/repro/kernels/moe_gemm/moe_gemm.py:"
                            + ("90" if name == "moe_ffn_fused_bwd"
                               else "65") + " (its backward)",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "device_ms": device_ms,
                "library_device_ms": library_device_ms, "shapes": []}
        rows[name]["shapes"].append({
            "shape": shape, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "ratio": ms / library_ms,
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "device_ratio": device_ms / library_device_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err})
    log("[kernels] moe_*_bwd: max_abs_err is the worst row's "
        "||kernel - plain|| / ||plain||; library_ms: one torch.bmm on the "
        "same products (K1: x @ [w_gate | w_up]; K2 gate/up: [dg | du] @ "
        "[w_gate | w_up]^T; K3 gate/up: x^T @ [dg | du])")
    del sets
    torch.cuda.empty_cache()
    return rows


def check_grad_bits(w) -> None:
    """K1, K2 and K3 at the train shapes (``w``: a set of
    ``phase_moe_bwd_kernels``' inputs with the kernels' dg and du), bit for
    bit: a CUDA-graph replay == the eager call; K1's and K2's rows 0-7 of
    the C 160 call == a C 8 call (a row's bits do not depend on C); K1's
    and K3's expert 0 of the E 128 call == that expert alone at E 1."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm as MG

    def k1(x, wg, wu, dout):
        return list(MG.moe_ffn_fused_bwd(x, wg, wu, dout))
    args = (w["x"], w["wg"], w["wu"], w["dout"])
    eager, replay = k1(*args), graph_out(lambda: k1(*args))
    if not all(torch.equal(x, y) for x, y in zip(eager, replay)):
        fail("moe_ffn_fused_bwd: graph replay differs from the eager call")
    rows8 = k1(w["x"][:, :8], w["wg"], w["wu"], w["dout"][:, :8])
    alone = k1(*(t[:1] for t in args))
    for what, full, part, one in zip(("dg", "du"), eager, rows8, alone):
        if not torch.equal(full[:, :8], part):
            fail(f"moe_ffn_fused_bwd {what}: rows 0-7 of the C "
                 f"{full.shape[1]} call differ from a C 8 call in "
                 f"{int((full[:, :8] != part).sum())} elements")
        if not torch.equal(full[:1], one):
            fail(f"moe_ffn_fused_bwd {what}: expert 0 of the E "
                 f"{full.shape[0]} call differs from that expert alone at "
                 f"E 1")
    pairs = {"down": ((w["dy"],), (w["wd"],), w["act"]),
             "gate/up": ((w["dg"], w["du"]), (w["wg"], w["wu"]), w["x"])}
    for what, (dys, ws, a) in pairs.items():
        calls = {"moe_gemm_dx": lambda: [MG.moe_gemm_dx(dys, ws)],
                 "moe_gemm_dw": lambda: MG.moe_gemm_dw(a, dys)}
        for name, fn in calls.items():
            eager, replay = fn(), graph_out(fn)
            if not all(torch.equal(x, y) for x, y in zip(eager, replay)):
                fail(f"{name} {what}: graph replay differs from the eager "
                     f"call")
        full = MG.moe_gemm_dx(dys, ws)
        rows8 = MG.moe_gemm_dx([d[:, :8] for d in dys], ws)
        if not torch.equal(full[:, :8], rows8):
            fail(f"moe_gemm_dx {what}: rows 0-7 of the C {full.shape[1]} "
                 f"call differ from a C 8 call in "
                 f"{int((full[:, :8] != rows8).sum())} elements")
        full = MG.moe_gemm_dw(a, dys)
        alone = MG.moe_gemm_dw(a[:1], [d[:1] for d in dys])
        if not all(torch.equal(f[:1], o) for f, o in zip(full, alone)):
            fail(f"moe_gemm_dw {what}: expert 0 of the E {a.shape[0]} call "
                 f"differs from that expert alone at E 1")
    log("[kernels] moe_ffn_fused_bwd / moe_gemm_dx / moe_gemm_dw at the "
        "train shapes, bit for bit: graph replay == eager; K1's and K2's "
        "rows 0-7 at C 160 == a C 8 call; K1's and K3's expert 0 at E 128 "
        "== that expert alone at E 1 (K2, K3: down and gate/up)")


def check_refusals() -> None:
    """Under autograd on the card, the kernels with no backward raise
    (``build.refuse_autograd``) instead of returning an output with no
    ``grad_fn``: the expert kernels' int8-weight variant and narrow
    variant and both decode kernels (``rglru_scan`` and ``ssd_chunk`` have
    a backward: ``phase_recurrent_bwd_kernels``)."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention as DA
    from repro_torch.kernels.moe_gemm import moe_gemm as MG

    def t(*shape, dtype=torch.float32, grad=False):
        return torch.ones(shape, dtype=dtype,
                          device="cuda").requires_grad_(grad)

    def q8(E, D, F):
        return {"q": torch.ones((E, D, F), dtype=torch.int8, device="cuda"),
                "s": t(E, 1, F)}

    x8 = t(2, 8, 64, dtype=torch.bfloat16, grad=True)
    calls = {
        "moe_gemm (int8)": lambda: MG.moe_gemm(x8, q8(2, 64, 16)),
        "moe_ffn_fused (int8)": lambda: MG.moe_ffn_fused(x8, q8(2, 64, 16),
                                                         q8(2, 64, 16)),
        "moe_gemm (narrow)": lambda: MG.moe_gemm(t(2, 8, 64, grad=True),
                                                 t(2, 64, 8)),
        "decode_attention": lambda: DA.decode_attention(
            t(1, 4, 16, grad=True), t(1, 2, 8, 16), t(1, 2, 8, 16),
            t(1, dtype=torch.int32)),
        "paged_decode_attention": lambda: DA.paged_decode_attention(
            t(1, 4, 16, grad=True), t(2, 8, 2, 16), t(2, 8, 2, 16),
            t(1, dtype=torch.int32), t(1, 1, dtype=torch.int32))}
    if not MG.uses_narrow(torch.ones(2, 8, 64, device="cuda"),
                          torch.ones(2, 64, 8, device="cuda")):
        fail("check_refusals: the narrow case does not take the narrow "
             "variant")
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "has no backward kernel" in str(e):
                continue
            fail(f"{name} under autograd on the card: {e}")
        fail(f"{name} ran under autograd on the card without a backward")
    log(f"[kernels] under autograd on the card these refuse (no backward "
        f"kernel): {', '.join(calls)}")


def log_i8_build() -> None:
    """ptxas registers, spills and notes of the int8 variant's kernels
    (``i8::kernel<...>``, one per block shape) and the HGMMA (wgmma)
    instructions ``cuobjdump -sass`` finds in each: fails on a spill, a
    C7512 line (wgmma serialized) or a kernel with no HGMMA."""
    import re
    from repro_torch.kernels import build
    name = re.compile(r"2i86kernelI\w+?EEv")
    entry, seen = "", set()
    for line in build.build_log("moe_gemm").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        m = name.search(entry)
        if "C7512" in line or (m and "spill" in line
                               and " 0 bytes spill stores" not in line):
            fail(f"moe_gemm int8 variant: {line.strip()[:200]}")
        if m and ("registers" in line or "spill" in line or "C75" in line):
            seen.add(m.group(0))
            log(f"[build] moe_gemm i8::kernel<{m.group(0)[11:-4]}>: "
                f"{line.strip()[:150]}")
    counts = hgmma_counts("moe_gemm", name)
    log("[build] moe_gemm int8 HGMMA instructions (cuobjdump -sass): "
        + ", ".join(f"<{k[11:-4]}> {v}" for k, v in sorted(counts.items()))
        + " (ptxas reports the 168 registers a thread has at launch; "
        "setmaxnreg then gives the consumers 232)")
    if not counts or set(counts) != seen or not all(counts.values()):
        fail(f"moe_gemm int8 variant: HGMMA instructions expected in every "
             f"kernel {sorted(seen)}, found {counts}")


def i8_probe_line(steps: int = 4096) -> None:
    """The bit probe: one chain of ``steps`` k16 products in increasing k
    as ``mma.sync.m16n8k16`` (the mma.sync kernels' instruction) and as
    each ``wgmma`` shape and operand layout the wgmma kernels use
    (``MG.PROBE_WAYS``: the int8 variant's A in registers and MN-major,
    K2's n160 with A and B K-major, K3's n128 and n256 with A and B
    MN-major, K1's n160 with A MN-major and B K-major), on bf16 operands
    whose rows span 2^-8 .. 2^8. Fails unless every way equals
    ``mma.sync`` bit for bit: the int8 variant is held to the tensor-core
    variant's bits on ``as_weight(w)``, K1 to the fused forward's
    accumulators, and K2 and K3 to their mma.sync design's."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    gen = torch.Generator(device="cuda").manual_seed(26)
    a = (torch.randn((steps, 64, 16), generator=gen, device="cuda")
         * torch.exp2(torch.randint(-8, 9, (steps, 64, 1), generator=gen,
                                    device="cuda").float())).bfloat16()
    b = torch.randn((steps, 256, 16), generator=gen, device="cuda").bfloat16()
    out = MG.i8_probe(a, b)
    torch.cuda.synchronize()
    differ = MG.probe_differ(out)
    log(f"[kernels] moe_gemm bit probe ({steps} k16 steps, 64 rows): "
        + "; ".join(f"{what} differs from mma.sync.m16n8k16 in {d} of "
                    f"{64 * n}" for (what, n), d in zip(MG.PROBE_WAYS,
                                                        differ)))
    if any(differ) or bool(out[0].isnan().any()):
        fail("wgmma and mma.sync round differently: the int8 variant cannot "
             "equal the tensor-core variant, nor K1 the fused forward, nor "
             "K2 and K3 their mma.sync design, bit for bit")


def log_grad_build() -> None:
    """ptxas registers, spills and notes of K1's, K2's and K3's kernels
    (``wgrad::dgu_kernel<...>`` / ``dx_kernel<...>`` / ``dw_kernel<...>``,
    one per instantiation) and the HGMMA (wgmma) instructions ``cuobjdump
    -sass`` finds in each: fails on a spill, a C75xx note that wgmma is
    serialized (C7512, C7515) or a kernel with no HGMMA."""
    import re
    from repro_torch.kernels import build
    name = re.compile(r"5wgrad\d+(d[xw]|dgu)_kernelI(\w+?)EEv")
    entry, seen = "", set()
    for line in build.build_log("moe_gemm").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        # a C75xx note names its kernel in the line
        m = name.search(line if "C75" in line else entry)
        if not m:
            continue
        label = f"{m.group(1)}_kernel<{m.group(2)}>"
        if "serialized" in line or ("spill" in line
                                    and " 0 bytes spill stores" not in line):
            fail(f"moe_gemm {label}: {line.strip()[:200]}")
        if "registers" in line or "spill" in line or "C75" in line:
            seen.add(label)
            log(f"[build] moe_gemm wgrad::{label}: {line.strip()[:150]}")
    counts = {f"{m.group(1)}_kernel<{m.group(2)}>": v
              for k, v in hgmma_counts("moe_gemm", name).items()
              for m in [name.search(k)]}
    log("[build] moe_gemm K1 / K2 / K3 HGMMA instructions (cuobjdump -sass): "
        + ", ".join(f"{k} {v}" for k, v in sorted(counts.items()))
        + " (ptxas reports the 168 registers a thread has at launch; "
        "setmaxnreg then gives the consumers 232)")
    if len(seen) != 5 or set(counts) != seen or not all(counts.values()):
        fail(f"moe_gemm K1 / K2 / K3: five wgmma kernels with HGMMA "
             f"instructions expected, built {sorted(seen)}, found {counts}")


def graph_out(fn):
    """The output of one ``fn()`` captured in a CUDA graph and replayed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    del graph
    return out


def phase_int8_kernels(mx_cfg):
    """The int8-weight variant of the grouped GEMMs (``{q, s}`` weights as
    ``models.quant`` makes them, bf16 x): its build lines (the bit probe
    ran in ``phase_moe_bwd_kernels``), then ragged edges (C 1, 9, 40,
    161, 300; F 16, 80, 144; an empty expert, strided x, a zero weight
    column), then mixtral-8x7b's
    expert shapes (gate/up E 8 D 4096 F 14336, down D 14336 F 4096; decode
    C 8 and a 2048-token prefill chunk's C 640). Every output equals the
    tensor-core variant's on ``as_weight(w)`` bit for bit, a CUDA-graph
    replay equals the eager call, and it agrees with the plain version
    (f32 products of the dequantised weights) within atol = rtol = 1e-2;
    at mixtral's shapes rows 0-7 of the C 640 call equal a C 8 call; an
    int8 weight the variant does not take (F 8, 72, 136, q's row stride
    off 16) raises. Timed eager and by CUDA-graph replay beside
    ``as_weight`` + the bf16 kernel, ``as_weight`` + ``torch.bmm``
    (``library_ms``) and ``torch.bmm`` on weights already in bf16, with
    the wrapper's host µs a call at C 8. One weight set: each matrix
    (470 MB of int8) is far past the 50 MB L2, so every launch streams it
    from device memory."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    from repro_torch.models.quant import as_weight, quantize_weight

    log_i8_build()

    E, D, Fd = mx_cfg.num_experts, mx_cfg.d_model, mx_cfg.moe_d_ff
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2468)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def q8(shape):
        w = randn(shape, shape[1] ** -0.5)
        w[:, :, 1] = 0                    # a zero column: scale 1e-12
        return quantize_weight(w)

    def launch(name, x, *ws):
        fn = MG.moe_ffn_fused if name == "moe_ffn_fused" else MG.moe_gemm
        return fn(x, *ws)

    def plain_f32(name, x, *ws):
        ref = MG.moe_ffn_fused_ref if name == "moe_ffn_fused" \
            else MG.moe_gemm_ref
        return ref(x.float(), *(as_weight(w).float() for w in ws))

    def check(name, label, x, ws):
        """The int8 variant vs the tensor-core one on as_weight(w) (bits)
        and the plain version (tolerance); returns the max abs error."""
        deq = [as_weight(w) for w in ws]
        if not MG.uses_int8(x, *ws) or not MG.uses_tensor_cores(x, *deq):
            fail(f"{name} {label}: not the int8 / tensor-core variants")
        n8 = MG.INT8_LAUNCHES[name]
        got = launch(name, x, *ws)
        bits = launch(name, x, *deq)
        torch.cuda.synchronize()
        if MG.INT8_LAUNCHES[name] != n8 + 1:
            fail(f"{name} {label}: the int8 variant was not launched")
        if not torch.equal(got, bits):
            fail(f"{name} {label}: int8 variant differs from the tensor-core "
                 f"variant on as_weight(w) in {int((got != bits).sum())} "
                 f"elements")
        replayed = graph_out(lambda: launch(name, x, *ws))
        if not torch.equal(replayed, got):
            fail(f"{name} {label}: a CUDA-graph replay differs from the "
                 f"eager call in {int((replayed != got).sum())} elements")
        ref = plain_f32(name, x, *ws)
        err = (got.float() - ref).abs()
        if bool((err > ATOL + RTOL * ref.abs()).any()) \
                or not torch.isfinite(got).all():
            fail(f"{name} {label}: max abs err {float(err.max()):.3e} past "
                 f"{ATOL}")
        return float(err.max())

    for Eo, Co, Do, Fo in ((3, 1, 48, 144), (5, 9, 64, 80), (4, 9, 16, 16),
                           (3, 161, 48, 80), (2, 300, 16, 144),
                           (5, 40, 2048, 768), (2, 70, 24, 16)):
        xo = randn((Eo, Co + 3, Do))[:, 3:]       # row stride Do, base + 3
        xo[0] = 0                                  # an empty expert
        wg, wu = q8((Eo, Do, Fo)), q8((Eo, Do, Fo))
        label = f"E {Eo} C {Co} D {Do} F {Fo}"
        check("moe_ffn_fused", label, xo, (wg, wu))
        check("moe_gemm", label, xo, (wg,))
        if bool(launch("moe_gemm", xo, wg)[0].any()):
            fail(f"moe_gemm int8 {label}: the empty expert is not zero")

    def strided_q(shape, pitch):
        w = q8((shape[0], shape[1], pitch))
        return {"q": w["q"][:, :, :shape[2]],
                "s": w["s"][:, :, :shape[2]].contiguous()}

    for bad, why in ((lambda: MG.moe_gemm(randn((2, 8, 16)).float(),
                                          q8((2, 16, 32))), "f32 x"),
                     (lambda: MG.moe_gemm(randn((2, 8, 16)),
                                          q8((2, 16, 20))), "F off 8"),
                     (lambda: MG.moe_gemm(randn((3, 1, 48)),
                                          q8((3, 48, 136))), "F 136"),
                     (lambda: MG.moe_ffn_fused(randn((5, 9, 64)),
                                               q8((5, 64, 72)),
                                               q8((5, 64, 72))), "F 72"),
                     (lambda: MG.moe_gemm(randn((4, 9, 16)),
                                          q8((4, 16, 8))), "F 8"),
                     (lambda: MG.moe_gemm(randn((2, 8, 16)),
                                          strided_q((2, 16, 32), 40)),
                      "q's row stride 40")):
        try:
            bad()
        except ValueError:
            continue
        fail(f"an int8 weight with {why} did not raise on the card")
    log("[kernels] int8 variant == tensor-core variant on as_weight(w) bit "
        "for bit, a graph replay == the eager call, and it agrees with its "
        "plain version at ragged shapes (C 1-300, D 16-2048, F 16-768, "
        "strided x, empty expert, zero column); int8 weights it does not "
        "take (F 8, 20, 72, 136, q's row stride 40) raise")

    wg, wu, wd = q8((E, D, Fd)), q8((E, D, Fd)), q8((E, Fd, D))
    deq = {k: as_weight(w) for k, w in (("g", wg), ("u", wu), ("d", wd))}
    wcat = torch.cat([deq["g"], deq["u"]], dim=-1)
    qcat = {k: torch.cat([wg[k], wu[k]], dim=-1) for k in ("q", "s")}
    rows = {}
    for name, C in (("moe_ffn_fused", 8), ("moe_ffn_fused", 640),
                    ("moe_gemm", 8), ("moe_gemm", 640)):
        fused = name == "moe_ffn_fused"
        Din, Fo = (D, Fd) if fused else (Fd, D)
        x = randn((E, C, Din))
        ws = (wg, wu) if fused else (wd,)
        bf = (deq["g"], deq["u"]) if fused else (deq["d"],)
        label = f"E {E} C {C} D {Din} F {Fo}"
        err = check(name, label, x, ws)
        if C > 8:                       # a row's bits depend on D alone
            head = launch(name, x[:, :8], *ws)
            if not torch.equal(launch(name, x, *ws)[:, :8], head):
                fail(f"{name} {label}: rows 0-7 differ from a C 8 call")
            log(f"[kernels] {name} int8 ({label}): rows 0-7 == a C 8 call "
                f"bit for bit")
        if fused:
            lib = lambda: torch.bmm(x, as_weight(qcat))       # noqa: E731
            lib_bf16 = lambda: torch.bmm(x, wcat)             # noqa: E731
        else:
            lib = lambda: torch.bmm(x, as_weight(wd))         # noqa: E731
            lib_bf16 = lambda: torch.bmm(x, deq["d"])         # noqa: E731
        kern = lambda: launch(name, x, *ws)                   # noqa: E731
        deq_tc = lambda: launch(name, x, *(as_weight(w)        # noqa: E731
                                           for w in ws))
        ref = MG.moe_ffn_fused_ref if fused else MG.moe_gemm_ref
        plain = lambda: ref(x, *(as_weight(w) for w in ws))   # noqa: E731
        t = {"ms": time_ms(kern), "device_ms": graph_ms(kern),
             "host_us": host_us(kern) if C == 8 else None,
             "dequant_tc_ms": time_ms(deq_tc),
             "dequant_tc_device_ms": graph_ms(deq_tc),
             "plain_ms": time_ms(plain, iters=5, warmup=1),
             "library_ms": time_ms(lib),
             "library_device_ms": graph_ms(lib),
             "library_bf16_ms": time_ms(lib_bf16),
             "library_bf16_device_ms": graph_ms(lib_bf16)}
        nbytes = (2 * E * C * Din + len(ws) * (E * Din * Fo + 4 * E * Fo)
                  + 2 * E * C * Fo)
        flops = 2 * len(ws) * E * C * Din * Fo
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernels] {name} int8 ({label}): max_abs_err {err:.3e} "
            f"kernel_ms {t['ms']:.4f} (replay {t['device_ms']:.4f}) "
            f"as_weight+bf16 kernel {t['dequant_tc_ms']:.4f} (replay "
            f"{t['dequant_tc_device_ms']:.4f}) plain_ms {t['plain_ms']:.4f} "
            f"library as_weight+bmm {t['library_ms']:.4f} (replay "
            f"{t['library_device_ms']:.4f}) bmm on bf16 "
            f"{t['library_bf16_ms']:.4f} (replay "
            f"{t['library_bf16_device_ms']:.4f}) bound_ms {bound_ms:.4f} "
            f"({bound_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), "
            f"{bound_ms / t['device_ms']:.1%} of bound by replay"
            + (f"; wrapper host {t['host_us']:.2f} us a call"
               if t["host_us"] is not None else ""))
        key = f"{name} (int8)"
        if key not in rows:             # the JSON row: the decode shape
            rows[key] = {
                "name": key, "route": "cuda",
                "source": "src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu",
                "replaces": "src/repro/kernels/moe_gemm/moe_gemm.py:"
                            + ("90" if fused else "65"),
                "launches": 0, "max_abs_err": err, "bound_ms": bound_ms,
                "bound_by": bound_by, **t, "shapes": []}
        rows[key]["shapes"].append({"shape": label, "max_abs_err": err,
                                    "bound_ms": bound_ms,
                                    "bound_by": bound_by, **t})
    log("[kernels] int8 rows: library_ms is as_weight + torch.bmm (for "
        "moe_ffn_fused on the [E, D, 2F] concatenation of w_gate and w_up), "
        "library_bf16_ms torch.bmm on the weights already in bf16")
    del wg, wu, wd, deq, wcat, qcat
    torch.cuda.empty_cache()
    return rows


MODEL_AXIS = 16                 # the production mesh's model axis
SPLIT_BC_TOL = 1e-2             # the SSD backward's dB and dC: the sum of
#                                 the 16 rank launches (bf16 outputs, each
#                                 rounded once) vs the whole launch's, of
#                                 its largest magnitude


def phase_split_kernels(moe_cfg, mx_cfg, rg_cfg, mb_cfg, sm_cfg):
    """The expert kernels at the local shapes a 16-way model axis gives
    the MoE layer under a mesh (``models.moe``, ``kernels.sharded.
    expert_layout``), against the whole launch:

    * qwen3-moe's expert parallelism: 8 of its 128 experts a rank (D 2048,
      F 768, bf16, C 16 and 160): ``moe_ffn_fused`` and ``moe_gemm`` on
      the rank's 8 experts, and K1, K2 and K3 on them, equal bit for bit
      to those experts' rows of the whole launch;
    * mixtral's expert-TP fallback (8 experts on 16 ranks): the rank's
      F / 16 = 896 columns of w_gate and w_up (D 4096, C 8 and 640, bf16
      and int8): the fused gate/up columns equal bit for bit to the whole
      launch's; w_down's 896 rows' partial product held to its plain
      version (ATOL); the sum of the 16 partials to the whole product
      within ATOL of its largest magnitude; K1 at F 896 (bf16: its NR
      tile is 160, 896 = 5 x 160 + 96) against the whole K1's columns
      (bits printed) and its plain version (BWD_ROW of each row's
      norm);
    * the scans (``split_scans``);
    * the flash kernels at seamless-m4t-medium's (``split_flash``)."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    from repro_torch.models.quant import quantize_weight

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1618)
    bf16 = torch.bfloat16

    def randn(shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def same(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            n = int((got != want).sum())
            fail(f"[kernels] split shapes, {what}: {n} of {want.numel()} "
                 f"elements differ from the whole launch's")

    # qwen3-moe: experts [e0, e0 + 8) of 128 on model rank 5
    E, D, Fd = moe_cfg.num_experts, moe_cfg.d_model, moe_cfg.moe_d_ff
    El = E // MODEL_AXIS
    e0 = 5 * El
    ex = slice(e0, e0 + El)
    wg, wu = randn((E, D, Fd), D ** -0.5), randn((E, D, Fd), D ** -0.5)
    wd = randn((E, Fd, D), Fd ** -0.5)
    lw = [t[ex].clone() for t in (wg, wu, wd)]
    for C in (16, 160):
        x, a = randn((E, C, D)), randn((E, C, Fd))
        dout, dy = randn((E, C, Fd)), randn((E, C, D))
        xl, al, dl, dyl = (t[ex].clone() for t in (x, a, dout, dy))
        same(f"qwen3-moe EP moe_ffn_fused C {C}",
             MG.moe_ffn_fused(xl, lw[0], lw[1]),
             MG.moe_ffn_fused(x, wg, wu)[ex])
        same(f"qwen3-moe EP moe_gemm C {C}", MG.moe_gemm(al, lw[2]),
             MG.moe_gemm(a, wd)[ex])
        dg, du = MG.moe_ffn_fused_bwd(x, wg, wu, dout)
        dgl, dul = MG.moe_ffn_fused_bwd(xl, lw[0], lw[1], dl)
        same(f"qwen3-moe EP K1 dg C {C}", dgl, dg[ex])
        same(f"qwen3-moe EP K1 du C {C}", dul, du[ex])
        same(f"qwen3-moe EP K2 C {C}",
             MG.moe_gemm_dx((dgl, dul), (lw[0], lw[1])),
             MG.moe_gemm_dx((dg, du), (wg, wu))[ex])
        same(f"qwen3-moe EP K2 w_down C {C}",
             MG.moe_gemm_dx((dyl,), (lw[2],)),
             MG.moe_gemm_dx((dy,), (wd,))[ex])
        for got, want in zip(MG.moe_gemm_dw(xl, (dgl, dul)),
                             MG.moe_gemm_dw(x, (dg, du))):
            same(f"qwen3-moe EP K3 C {C}", got, want[ex])
    log(f"[kernels] split shapes, qwen3-moe expert parallel (experts "
        f"{e0}-{e0 + El - 1} of {E} on model rank 5 of {MODEL_AXIS}; D {D} "
        f"F {Fd} bf16, C 16 and 160): moe_ffn_fused, moe_gemm, K1 "
        f"moe_ffn_fused_bwd, K2 moe_gemm_dx (both pairs; w_down's pair), "
        f"K3 moe_gemm_dw on the rank's experts bit for bit those experts' "
        f"rows of the whole launch")
    del wg, wu, wd, lw

    # mixtral: f columns [f0, f0 + 896) of 14336 on model rank 3
    E, D, Fd = mx_cfg.num_experts, mx_cfg.d_model, mx_cfg.moe_d_ff
    Fl = Fd // MODEL_AXIS
    f0 = 3 * Fl
    fs = slice(f0, f0 + Fl)
    wg, wu = randn((E, D, Fd), D ** -0.5), randn((E, D, Fd), D ** -0.5)
    wd = randn((E, Fd, D), Fd ** -0.5)
    q8 = {k: quantize_weight(w) for k, w in (("g", wg), ("u", wu),
                                             ("d", wd))}

    def cols(w):                 # a [E, d, f] weight's rank columns
        if isinstance(w, dict):
            return {"q": w["q"][:, :, fs].contiguous(),
                    "s": w["s"][:, :, fs].contiguous()}
        return w[:, :, fs].contiguous()

    def rows(w):                 # w_down [E, f, d]: the rank's f rows
        if isinstance(w, dict):
            return {"q": w["q"][:, fs].contiguous(), "s": w["s"]}
        return w[:, fs].contiguous()

    parts = {}
    for C in (8, 640):
        x = randn((E, C, D))
        for kind, g, u, d in (("bf16", wg, wu, wd),
                              ("int8", q8["g"], q8["u"], q8["d"])):
            whole = MG.moe_ffn_fused(x, g, u)
            local = MG.moe_ffn_fused(x, cols(g), cols(u))
            same(f"mixtral expert-TP moe_ffn_fused {kind} C {C}", local,
                 whole[:, :, fs])
            part = MG.moe_gemm(local, rows(d))
            ref = MG.moe_gemm_ref(local.float(),
                                  MG._plain(rows(d)).float())
            err = float((part.float() - ref).abs().max())
            if err > ATOL + ATOL * float(ref.abs().max()):
                fail(f"[kernels] mixtral w_down partial {kind} C {C}: "
                     f"{err:.3e} from its plain version")
            total = torch.zeros((E, C, D), device=dev)
            for r in range(MODEL_AXIS):
                sl = slice(r * Fl, (r + 1) * Fl)
                rd = {"q": d["q"][:, sl].contiguous(), "s": d["s"]} \
                    if kind == "int8" else d[:, sl].contiguous()
                total += MG.moe_gemm(whole[:, :, sl].contiguous(),
                                     rd).float()
            full = MG.moe_gemm(whole, d).float()
            rel = float((total - full).abs().max()
                        / full.abs().max().clamp(min=1e-30))
            if rel > ATOL:
                fail(f"[kernels] mixtral sum of {MODEL_AXIS} w_down "
                     f"partials {kind} C {C}: {rel:.3e} of the whole "
                     f"product's largest")
            parts[(kind, C)] = (err, rel)
    x = randn((E, 640, D))
    dout = randn((E, 640, Fd))
    dg, du = MG.moe_ffn_fused_bwd(x, wg, wu, dout)
    dgl, dul = MG.moe_ffn_fused_bwd(x, cols(wg), cols(wu),
                                    dout[:, :, fs].contiguous())
    torch.cuda.synchronize()
    k1_bits = bool(torch.equal(dgl, dg[:, :, fs])
                   and torch.equal(dul, du[:, :, fs]))
    wdg, wdu = MG.moe_ffn_fused_bwd_ref(x.float(), cols(wg).float(),
                                        cols(wu).float(),
                                        dout[:, :, fs].float())
    k1_err = max(float(row_err(got, want).max())
                 for got, want in ((dgl, wdg), (dul, wdu)))
    if k1_err > BWD_ROW:
        fail(f"[kernels] mixtral K1 at F {Fl}: {k1_err:.3e} of a row's norm "
             f"from its plain version")
    log(f"[kernels] split shapes, mixtral expert-TP (f columns {f0}-"
        f"{f0 + Fl - 1} of {Fd} on model rank 3 of {MODEL_AXIS}; E {E} D "
        f"{D}): the fused gate/up columns bit for bit the whole launch's "
        f"at C 8 and 640, bf16 and int8; w_down's {Fl}-row partial vs its "
        f"plain version / the sum of {MODEL_AXIS} partials vs the whole "
        f"product (of its largest): " + ", ".join(
            f"{k} C {c} {e:.2e} / {r:.2e}" for (k, c), (e, r)
            in parts.items()) + f" (tolerance {ATOL}); K1 at F {Fl} (NR 160 "
        f"tiles: 5 whole, one of 96) {'bit for bit' if k1_bits else 'NOT bit for bit'} "
        f"the whole K1's columns, {k1_err:.2e} of a row's norm from its "
        f"plain version (tolerance {BWD_ROW})")
    del wg, wu, wd, q8
    split_scans(rg_cfg, mb_cfg)
    split_flash(sm_cfg)


def split_flash(sm_cfg):
    """flash_attention and its backward at the local shapes a 16-way model
    axis gives seamless-m4t-medium's attention under a mesh (its 16 query
    and 16 KV heads split over the axis: one of each a rank; d 64, b 1,
    bf16, no causal mask), against the whole launch: the encoder's self
    attention over its 1536 frames and the cross attention of a
    TRAIN_SEQ-token training microbatch over them. Model rank 5's launch
    (head 5 of q, k, v and dO) must give o, lse, dq, dk and dv bit for bit
    that head of the whole launch's."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as FA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2718)
    H, Hkv, d, src = (sm_cfg.num_heads, sm_cfg.num_kv_heads,
                      sm_cfg.head_dim, sm_cfg.source_len)
    hs = slice(5 * H // MODEL_AXIS, 6 * H // MODEL_AXIS)
    ks = slice(5 * Hkv // MODEL_AXIS, 6 * Hkv // MODEL_AXIS)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    shapes = []
    for label, sq in (("encoder", src), ("cross", TRAIN_SEQ)):
        q, do = randn(1, sq, H, d), randn(1, sq, H, d)
        k, v = randn(1, src, Hkv, d), randn(1, src, Hkv, d)
        qpos = torch.arange(sq, dtype=torch.int32, device=dev)
        kpos = torch.arange(src, dtype=torch.int32, device=dev)

        def run(q, k, v, do):
            o, lse = FA.flash_attention_lse(q, k, v, qpos, kpos,
                                            causal=False)
            return (o, lse) + FA.flash_attention_bwd(
                q, k, v, o, lse, do, qpos, kpos, causal=False)

        whole = run(q, k, v, do)
        local = run(*(t[:, :, sl].contiguous() for t, sl in (
            (q, hs), (k, ks), (v, ks), (do, hs))))
        torch.cuda.synchronize()
        for name, got, want in zip(
                ("o", "lse", "dq", "dk", "dv"), local,
                (whole[0][:, :, hs], whole[1][:, hs], whole[2][:, :, hs],
                 whole[3][:, :, ks], whole[4][:, :, ks])):
            if not torch.equal(got, want):
                n = int((got != want).sum())
                fail(f"[kernels] split shapes, seamless {label} "
                     f"flash_attention {name}: {n} of {want.numel()} "
                     f"elements differ from the whole launch's head")
        shapes.append(f"{label} sq {sq} skv {src}")
    log(f"[kernels] split shapes, seamless-m4t-medium attention (head "
        f"{hs.start} of {H}, KV head {ks.start} of {Hkv} on model rank 5 of "
        f"{MODEL_AXIS}; d {d}, b 1, bf16, no causal mask; "
        + "; ".join(shapes) + "): flash_attention's o and lse and "
        f"flash_attention_bwd's dq, dk, dv bit for bit that head of the "
        f"whole launch's")


def split_scans(rg_cfg, mb_cfg):
    """The scan kernels at the local shapes a 16-way model axis gives them
    under a mesh (``kernels.sharded.scan_layout``), against the whole
    launch, at the recurrent paths' prefill (2048 tokens) and training
    microbatch (TRAIN_SEQ) shapes, batch 1:

    * recurrentgemma-2b: ``rglru_scan`` and ``rglru_scan_bwd`` on the 160
      of 2560 columns of w of model rank 7, f32: bit for bit the whole
      launch's columns;
    * mamba2-1.3b (nh 64, hp 64, n 128, g 1, Q 128, bf16 x, B, C): the
      4 heads of each model rank with their one group: on rank 5,
      ``ssd_chunk``'s y and S_final, and ``ssd_chunk_bwd``'s (the
      forward's workspace kept, as in training) dx, ddt, dA and dS0 bit
      for bit the whole launch's heads; dB and dC, partial sums over the
      axis, summed over the 16 ranks' launches in rank order in f32
      against the whole launch's, within SPLIT_BC_TOL of its largest
      magnitude."""
    import torch
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1729)

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def same(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            n = int((got != want).sum())
            fail(f"[kernels] split shapes, {what}: {n} of {want.numel()} "
                 f"elements differ from the whole launch's")

    W = rg_cfg.lru_width
    Wl = W // MODEL_AXIS
    cs = slice(7 * Wl, 8 * Wl)
    for T in (2048, TRAIN_SEQ):
        a, b, h0 = rand((1, T, W), 0.9, 1.0), randn((1, T, W)) * 0.1, \
            randn((1, W))
        dh = randn((1, T, W))
        h = RS.rglru_scan(a, b, h0)
        loc = [t[..., cs].contiguous() for t in (a, b, h0, dh)]
        hl = RS.rglru_scan(*loc[:3])
        same(f"rglru_scan T {T}", hl, h[..., cs])
        for name, got, want in zip(
                ("da", "db", "dh0"),
                RS.rglru_scan_bwd(loc[0], hl, loc[2], loc[3]),
                RS.rglru_scan_bwd(a, h, h0, dh)):
            same(f"rglru_scan_bwd {name} T {T}", got, want[..., cs])
    log(f"[kernels] split shapes, recurrentgemma-2b (w columns "
        f"{cs.start}-{cs.stop - 1} of {W} on model rank 7 of {MODEL_AXIS}, "
        f"B 1, T 2048 and {TRAIN_SEQ}, f32): rglru_scan's h and "
        f"rglru_scan_bwd's da, db, dh0 on the rank's columns bit for bit "
        f"the whole launch's columns")

    nh, hp, n, g, Q = (mb_cfg.ssm_nheads, mb_cfg.ssm_headdim,
                       mb_cfg.ssm_state, mb_cfg.ssm_ngroups, mb_cfg.ssm_chunk)
    Hl = nh // MODEL_AXIS
    bf16 = torch.bfloat16
    errs = {}
    for l in (2048, TRAIN_SEQ):
        x = randn((1, l, nh, hp), bf16)
        B, C = randn((1, l, g, n), bf16), randn((1, l, g, n), bf16)
        dt = rand((1, l, nh), 1e-3, 0.1)
        A = -torch.arange(1, nh + 1, device=dev, dtype=torch.float32)
        S0, dS = randn((1, nh, hp, n)), randn((1, nh, hp, n))
        dy = randn((1, l, nh, hp))

        def run(hs):            # the forward and backward on heads hs
            xl, dtl, Al, S0l, dSl, dyl = (
                t.contiguous() for t in (x[:, :, hs], dt[:, :, hs], A[hs],
                                         S0[:, hs], dS[:, hs], dy[:, :, hs]))
            y, Sf, ws = SC._forward(xl, dtl, Al, B, C, S0l, Q)
            return (y, Sf) + SC.ssd_chunk_bwd(xl, dtl, Al, B, C, S0l, dyl,
                                               dSl, Q, ws=ws)

        whole = run(slice(0, nh))
        total = [torch.zeros(t.shape, device=dev) for t in whole[5:7]]
        for r in range(MODEL_AXIS):
            hs = slice(r * Hl, (r + 1) * Hl)
            got = run(hs)
            if r == 5:
                for name, i, dim in (("y", 0, 2), ("S_final", 1, 1),
                                     ("dx", 2, 2), ("ddt", 3, 2),
                                     ("dA", 4, 0), ("dS0", 7, 1)):
                    same(f"ssd_chunk {name} l {l}", got[i],
                         whole[i].narrow(dim, hs.start, Hl))
            total[0] += got[5].float()
            total[1] += got[6].float()
        for name, t, w in (("dB", total[0], whole[5]),
                           ("dC", total[1], whole[6])):
            w = w.float()
            errs[(name, l)] = float((t - w).abs().max()
                                    / w.abs().max().clamp(min=1e-30))
    bad = {k: v for k, v in errs.items() if v > SPLIT_BC_TOL}
    log(f"[kernels] split shapes, mamba2-1.3b (heads {5 * Hl}-{6 * Hl - 1} "
        f"of {nh} on model rank 5 of {MODEL_AXIS}, g {g}: each rank takes "
        f"group 0; b 1, l 2048 and {TRAIN_SEQ}, hp {hp} n {n} Q {Q}, bf16 "
        f"x, B, C, the forward's workspace kept): ssd_chunk's y, S_final "
        f"and ssd_chunk_bwd's dx, ddt, dA, dS0 bit for bit the whole "
        f"launch's heads; dB, dC summed over the {MODEL_AXIS} rank launches "
        f"(rank order, f32) vs the whole launch: " + ", ".join(
            f"{k} l {ll} {v:.2e}" for (k, ll), v in errs.items())
        + f" of its largest magnitude (tolerance {SPLIT_BC_TOL})")
    if bad:
        fail(f"[kernels] split shapes, mamba2 dB/dC sums past "
             f"{SPLIT_BC_TOL}: {bad}")


def ssd_flops(l: int, chunk: int, nh: int, hp: int, g: int, n: int,
              b: int = 1) -> int:
    """Operations the chunked SSD function needs (2 per multiply-add),
    counting each chunk's real rows q: the causal half of C·B^T once per
    group, then per head the causal half of the diagonal product (q(q+1)/2
    x hp), the carried-state product and the state update (q x n x hp
    each)."""
    Q = min(chunk, l)
    total = 0
    for c0 in range(0, l, Q):
        q = min(Q, l - c0)
        total += g * q * (q + 1) * n + nh * (q * (q + 1) * hp
                                             + 4 * q * n * hp)
    return b * total


def check_rglru_bits(inputs, kern, W: int) -> None:
    """rglru_scan's bits on the card: the same call made twice eagerly and
    replayed (twice) from a CUDA graph gives equal outputs; each row of a B
    3 call equals the B 1 call on that row; identity steps (a 1, b 0) after
    step 700 of 1000 keep h[:, -1] == h[:, 699]."""
    import torch
    s = inputs(1, 2048, W)
    first, second = kern(s), kern(s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern(s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = kern(s)
    for _ in range(2):
        replayed.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        if not (torch.equal(first, second) and torch.equal(first, replayed)):
            fail("rglru_scan: the same call gives other bits eagerly, again "
                 "or replayed from a CUDA graph")
    del graph
    s = inputs(3, 1000, W)
    three = kern(s)
    for r in range(3):
        if not torch.equal(three[r], kern({k: v[r:r + 1].contiguous()
                                           for k, v in s.items()})[0]):
            fail(f"rglru_scan: row {r} of a B 3 call differs from the same "
                 f"row alone")
    s = inputs(2, 1000, W)
    s["a"][:, 700:], s["b"][:, 700:] = 1.0, 0.0
    h = kern(s)
    if not torch.equal(h[:, -1], h[:, 699]):
        fail("rglru_scan: identity steps after step 700 changed the state")
    log(f"[kernels] rglru_scan bits (W {W}): eager == eager again == graph "
        f"replay (T 2048), each row of B 3 == that row alone (T 1000), "
        f"identity steps after 700 of 1000 keep h[:, -1] == h[:, 699]")


def phase_recurrent_kernels(rg_cfg, mb_cfg):
    """rglru_scan and ssd_chunk against their plain versions at the
    prefill shapes of the recurrent paths (a 2048-token bucket): the RG-LRU
    scan at (B 1, T 2048, W 2560) f32 with a non-zero h0; the SSD scan at
    mamba2-1.3b's (b 1, l 2048, nh 64, hp 64, n 128, g 1, Q 128) with bf16
    x/B/C and a non-zero S0, and at a ragged l. Smaller shapes first: T, W,
    l off every tile, two groups, and the smoke configs' widths (W 64; hp
    16, n 16, Q 16) in f32. Inputs in the model's ranges: a in (0.9, 1),
    dt in [1e-3, 0.1], A = -(1..nh)."""
    import torch
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2468)

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def rg_inputs(B, T, W):
        return {"a": rand((B, T, W), 0.9, 1.0), "b": randn((B, T, W), 0.1),
                "h0": randn((B, W))}

    def ssd_inputs(b, l, nh, hp, g, n, dtype):
        return {"x": randn((b, l, nh, hp), dtype=dtype),
                "dt": rand((b, l, nh), 1e-3, 0.1),
                "A": -torch.arange(1, nh + 1, device=dev,
                                   dtype=torch.float32),
                "B": randn((b, l, g, n), dtype=dtype),
                "C": randn((b, l, g, n), dtype=dtype),
                "S0": randn((b, nh, hp, n))}

    def rg_kern(s):
        return RS.rglru_scan(s["a"], s["b"], s["h0"])

    def rg_plain(s):
        return RS.rglru_scan_ref(s["a"], s["b"], s["h0"])

    def ssd_run(fn, chunk):
        return lambda s: fn(s["x"], s["dt"], s["A"], s["B"], s["C"],
                            s["S0"], chunk)

    def check(name, shape, got, want, tol):
        worst = 0.0
        for g_, w_ in zip(got, want):
            err = (g_.float() - w_.float()).abs()
            bad = err > tol + tol * w_.float().abs()
            worst = max(worst, float(err.max()))
            if not torch.isfinite(g_).all() or bool(bad.any()):
                fail(f"{name} ({shape}): kernel disagrees with its plain "
                     f"version (max abs err {float(err.max()):.3e}, "
                     f"{int(bad.sum())} elements past atol=rtol={tol})")
        return worst

    # T 1, below one chunk, off the chunk and the warp split, past 64
    # chunks (two words of done bits); W 1, 3 (off float4: the scalar
    # path), 64, 100, 130 (off the 128-channel tile)
    for B, T, W in ((3, 37, 100), (2, 300, 64), (1, 1, 2560), (1, 1000, 130),
                    (3, 300, 3), (2, 37, 1), (1, 5, 64), (3, 1000, 2560),
                    (2, 4200, 100)):
        s = rg_inputs(B, T, W)
        check("rglru_scan", f"B {B} T {T} W {W}", (rg_kern(s),),
              (rg_plain(s),), RG_TOL)
    # rows off 16 bytes (W a multiple of 4): the scalar path again
    s, n = rg_inputs(2, 300, 64), 2 * 300 * 64
    buf = torch.empty(2 * n + 1, device=dev)
    for i, k in enumerate(("a", "b")):
        s[k] = buf[1 + i * n:1 + (i + 1) * n].view(2, 300, 64).copy_(s[k])
    check("rglru_scan", "B 2 T 300 W 64, rows off 16 bytes", (rg_kern(s),),
          (rg_plain(s),), RG_TOL)
    check_rglru_bits(rg_inputs, rg_kern, rg_cfg.lru_width)
    for (b, l, nh, hp, g, n, Q), dt in (
            ((2, 37, 8, 16, 1, 16, 16), torch.float32),    # mamba2 smoke
            ((1, 150, 4, 40, 2, 24, 64), torch.float32),   # hp, n off tiles
            ((1, 1, 4, 16, 1, 16, 128), torch.float32),    # l 1
            ((2, 37, 8, 16, 1, 16, 16), torch.bfloat16),   # smoke widths
            ((2, 10, 4, 8, 2, 8, 128), torch.bfloat16),    # l below a chunk
            ((1, 1, 4, 16, 1, 16, 128), torch.bfloat16),   # l 1
            ((1, 150, 4, 40, 2, 24, 64), torch.bfloat16),  # hp, n off 16
            ((1, 70, 2, 12, 1, 20, 32), torch.bfloat16),   # off 8: scalar
            ((1, 200, 2, 72, 1, 128, 128), torch.bfloat16),  # 2 hp tiles
            ((1, 300, 4, 64, 1, 128, 128), torch.bfloat16)):
        s = ssd_inputs(b, l, nh, hp, g, n, dt)
        check("ssd_chunk", f"b {b} l {l} nh {nh} hp {hp} g {g} n {n} Q {Q} "
              f"{'bf16' if dt == torch.bfloat16 else 'f32'}",
              ssd_run(SC.ssd_chunk, Q)(s), ssd_run(SC.ssd_chunk_ref, Q)(s),
              SSD_TOL)
    # the model's layout: x, B and C strided views of one [b, l, di + 2 g n]
    # buffer (mamba2-1.3b's widths), a ragged last chunk; then dt = 0 on
    # padded steps carries the state exactly to the true length
    b, l, nh, hp, g, n, Q = 2, 1000, mb_cfg.ssm_nheads, mb_cfg.ssm_headdim, \
        mb_cfg.ssm_ngroups, mb_cfg.ssm_state, mb_cfg.ssm_chunk
    di = nh * hp
    xbc = randn((b, l, di + 2 * g * n), dtype=torch.bfloat16)
    s = {"x": xbc[..., :di].reshape(b, l, nh, hp),
         "B": xbc[..., di:di + g * n].reshape(b, l, g, n),
         "C": xbc[..., di + g * n:].reshape(b, l, g, n),
         "dt": rand((b, l, nh), 1e-3, 0.1),
         "A": -torch.arange(1, nh + 1, device=dev, dtype=torch.float32),
         "S0": randn((b, nh, hp, n))}
    check("ssd_chunk", f"strided views of xbc b {b} l {l} nh {nh} hp {hp} "
          f"g {g} n {n} Q {Q} bf16", ssd_run(SC.ssd_chunk, Q)(s),
          ssd_run(SC.ssd_chunk_ref, Q)(s), SSD_TOL)
    short = dict(s, x=s["x"][:, :700], B=s["B"][:, :700], C=s["C"][:, :700],
                 dt=s["dt"][:, :700].contiguous())
    s["dt"][:, 700:] = 0
    _, S_pad = ssd_run(SC.ssd_chunk, Q)(s)
    _, S_short = ssd_run(SC.ssd_chunk, Q)(short)
    check("ssd_chunk", "dt = 0 past step 700 of 1000: S_final", (S_pad,),
          (S_short,), SSD_TOL)
    log("[kernels] rglru_scan and ssd_chunk agree with their plain versions "
        "at ragged shapes (T 1-4200, W 1-2560, B 1-3, rows off 16 bytes; "
        "l 1-1000, hp 8-72, n 8-128, "
        "g 1-2, Q 16-128, f32 and bf16, strided views of one buffer, "
        "strides off 8); zero-dt steps carry the state")

    T, W = 2048, rg_cfg.lru_width
    nh, hp, g, n, Q = (mb_cfg.ssm_nheads, mb_cfg.ssm_headdim,
                       mb_cfg.ssm_ngroups, mb_cfg.ssm_state, mb_cfg.ssm_chunk)
    bf16 = torch.bfloat16

    def ssd_bytes(l):
        return (l * nh * hp * 2 + l * nh * 4 + nh * 4 + 2 * l * g * n * 2
                + 2 * nh * hp * n * 4 + l * nh * hp * 4)

    # the bf16 route runs its products on the tensor cores: its least time
    # is max(bytes, operations at the bf16 rate); the f32 route's operations
    # at the f32 rate are logged beside it
    peaks = {"rglru_scan": F32_FLOPS, "ssd_chunk": BF16_FLOPS}

    cases = [
        ("rglru_scan", f"B 1 T {T} W {W} f32",
         [rg_inputs(1, T, W) for _ in range(2)], rg_kern, rg_plain,
         lambda s: torch.cumsum(s["a"], dim=1), RG_TOL,
         (3 * T * W + W) * 4, 2 * T * W, "rglru_scan/csrc/rglru_scan.cu",
         "src/repro/kernels/rglru_scan/rglru_scan.py:57"),
        ("ssd_chunk", f"b 1 l {T} nh {nh} hp {hp} g {g} n {n} Q {Q} bf16",
         [ssd_inputs(1, T, nh, hp, g, n, bf16) for _ in range(2)],
         ssd_run(SC.ssd_chunk, Q), ssd_run(SC.ssd_chunk_ref, Q), None,
         SSD_TOL, ssd_bytes(T), ssd_flops(T, Q, nh, hp, g, n),
         "ssd_chunk/csrc/ssd_chunk.cu",
         "src/repro/kernels/ssd_chunk/ssd_chunk.py:81"),
        ("ssd_chunk", f"b 1 l 1000 (last chunk 104) nh {nh} hp {hp} g {g} "
         f"n {n} Q {Q} bf16",
         [ssd_inputs(1, 1000, nh, hp, g, n, bf16) for _ in range(2)],
         ssd_run(SC.ssd_chunk, Q), ssd_run(SC.ssd_chunk_ref, Q), None,
         SSD_TOL, ssd_bytes(1000), ssd_flops(1000, Q, nh, hp, g, n), "", ""),
    ]
    rows = {}
    for (name, shape, sets, kern, plain, library, tol, nbytes, flops, src,
         replaces) in cases:
        got, want = kern(sets[0]), plain(sets[0])
        torch.cuda.synchronize()
        if name == "rglru_scan":
            got, want = (got,), (want,)
        err = check(name, shape, got, want, tol)
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(sets)
            return sets[it["i"]]

        # ms: eager calls back to back (host side included); device_ms:
        # the same calls replayed from a CUDA graph (no host side)
        ms = time_ms(lambda: kern(nxt()), iters=20)
        device_ms = graph_ms(lambda: kern(nxt()), iters=10)
        plain_ms = time_ms(lambda: plain(nxt()), iters=5, warmup=2)
        library_ms = (time_ms(lambda: library(nxt()), iters=20)
                      if library is not None else None)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peaks[name]
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernels] {name} ({shape}): max_abs_err {err:.3e} kernel_ms "
            f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{'-' if library_ms is None else f'{library_ms:.4f}'} bound_ms "
            f"{bound_ms:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP; f32 operations alone "
            f"{flops / F32_FLOPS * 1e3:.4f} ms); by graph replay: kernel "
            f"{device_ms:.4f}, {bound_ms / device_ms:.1%} of bound")
        if name == "rglru_scan":
            log_kernel_parts(f"{name} ({shape})", lambda: kern(nxt()),
                             "rglru")
            log_kernel_parts(f"{name} ({shape}) memset", lambda: kern(nxt()),
                             "Memset")
            small = rg_inputs(1, 64, 128)
            log(f"[kernels] rglru_scan wrapper host side: "
                f"{host_us(lambda: kern(small)):.1f} us a call (B 1 T 64 W "
                f"128, 200 calls without a sync)")
        if name == "ssd_chunk":
            log_kernel_parts(f"{name} ({shape})", lambda: kern(nxt()), "ssd_")
            occ = SC._library().ssd_chunk_occupancy
            log(f"[kernels] ssd_chunk bf16 route: resident blocks an SM, "
                f"ssd_states {occ(0)}, ssd_outputs {occ(1)}")
        if name not in rows:          # the JSON row: the 2048-token bucket
            rows[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/{src}",
                "replaces": replaces, "launches": 0, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "device_ms": device_ms}
        del sets
        torch.cuda.empty_cache()
    log("[kernels] library_ms: rglru_scan — torch.cumsum over T on the same "
        "[B, T, W] f32 tensor (same bytes, not the same function); "
        "ssd_chunk — none (no single PyTorch call computes it)")
    return rows


def ssd_bwd_flops(l: int, chunk: int, nh: int, hp: int, g: int, n: int,
                  b: int = 1) -> int:
    """Operations the SSD function's gradient needs from its inputs (2 per
    multiply-add), each chunk's real rows q: the states entering the
    chunks (q x hp x n a head, the forward's walk) and the states'
    gradient (dy^T C, the same); C·B^T's causal half once per group; per
    head the causal halves of dy·xdt^T, of the diagonal's dxdt (M^T dy)
    and of dC's and dB's diagonal products (W B, W^T C), and the
    carried-state terms of dxdt, dC and dB (q x hp x n each)."""
    Q = min(chunk, l)
    total = 0
    for c0 in range(0, l, Q):
        q = min(Q, l - c0)
        tri = q * (q + 1)                  # 2 x the causal half's pairs
        total += g * tri * n + nh * (tri * (2 * hp + 2 * n)
                                     + 2 * q * hp * n * 5)
    return b * total


def ssd_bwd_tc_flops(l: int, chunk: int, nh: int, hp: int, g: int, n: int,
                     b: int = 1) -> int:
    """``ssd_bwd_flops``' products as the tensor-core route must make them
    in bf16: an f32 operand split hi + lo doubles a product against an
    exact bf16 one (x, B, C) and triples one against another f32 operand
    (hi hi + lo hi + hi lo): C·B^T once; dy·x^T, W B, W^T C, the states'
    walks (x ∘ w, e ∘ dy) and dxdt's carried-state term twice; M^T dy and
    the carried-state terms of dC ((e ∘ dy) S_in) and dB ((w ∘ x) dS_out)
    three times."""
    Q = min(chunk, l)
    total = 0
    for c0 in range(0, l, Q):
        q = min(Q, l - c0)
        tri = q * (q + 1)
        total += g * tri * n + nh * (tri * (5 * hp + 4 * n)
                                     + 2 * q * hp * n * 12)
    return b * total


def log_ssd_bwd_build() -> None:
    """ptxas registers and spills of the backward's tensor-core route
    (``tc::states_bwd``, ``tc::chunk_bwd``) and the HMMA (mma.sync)
    instructions ``cuobjdump -sass`` finds in each: fails on a spill, a
    C7512 line (wgmma serialized) or a kernel with no HMMA."""
    import re
    from repro_torch.kernels import build
    name = re.compile(r"tc\d+(states_bwd|chunk_bwd)")
    entry, bad = "", []
    for line in build.build_log("ssd_chunk_bwd").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line or "C75" in line:
            m = name.search(entry)
            if m:
                log(f"[build] ssd_chunk_bwd tc::{m.group(1)}: "
                    f"{line.strip()[:160]}")
                spills = re.findall(r"(\d+) bytes spill", line)
                if "C7512" in line or any(int(v) for v in spills):
                    bad.append(line.strip())
    counts = {f"tc::{name.search(k).group(1)}": v for k, v in
              hgmma_counts("ssd_chunk_bwd", name, op="HMMA").items()}
    log(f"[build] ssd_chunk_bwd HMMA instructions (cuobjdump -sass): "
        + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())))
    if bad or set(counts) != {"tc::states_bwd", "tc::chunk_bwd"} \
            or not all(counts.values()):
        fail(f"ssd_chunk_bwd tensor-core route: spills or serialized "
             f"wgmma {bad}, or a kernel without HMMA instructions {counts}")


def ssd_bwd_bytes(l: int, nh: int, hp: int, g: int, n: int, elem: int,
                  b: int = 1) -> int:
    """Bytes the SSD gradient must move: x, B, C (``elem`` bytes each), dt,
    dy, A, S0 and dS_final read once; dx, dB, dC (``elem``), ddt, dA and
    dS0 written once."""
    return b * (2 * l * nh * hp * elem + 4 * l * g * n * elem
                + l * nh * hp * 4 + 2 * l * nh * 4 + 4 * nh * hp * n * 4) \
        + 2 * nh * 4


def grad_rel(got, want):
    """Each gradient's max |got - want| over its largest magnitude."""
    return [float((x.float() - w.float()).abs().max()
                  / w.float().abs().max().clamp(min=1e-30))
            for x, w in zip(got, want)]


def check_grads(name: str, shape: str, got, want, tols) -> float:
    """Every gradient finite and within its tolerance (of its largest
    magnitude) of the plain backward's; returns the worst max abs error."""
    import torch
    rel = grad_rel(got, want)
    bad = [i for i, (x, r, t) in enumerate(zip(got, rel, tols))
           if not bool(torch.isfinite(x).all()) or r > t]
    if bad:
        fail(f"{name} ({shape}): gradients {bad} disagree with the plain "
             f"backward (each's err / max {[f'{r:.2e}' for r in rel]}, "
             f"tolerances {tols})")
    return max(float((x.float() - w.float()).abs().max())
               for x, w in zip(got, want))


def check_bits(name: str, fn) -> None:
    """The same call twice eagerly and replayed from a CUDA graph: every
    output equal bit for bit."""
    import torch
    first, second = fn(), fn()
    replayed = graph_out(fn)
    torch.cuda.synchronize()
    for a, b_, c in zip(first, second, replayed):
        if not (torch.equal(a, b_) and torch.equal(a, c)):
            fail(f"{name}: the same call gives other bits eagerly, again or "
                 f"replayed from a CUDA graph")


def phase_recurrent_bwd_kernels(rg_cfg, mb_cfg):
    """The recurrent kernels' backward against their plain backward on the
    card: ``rglru_scan_bwd`` (the scan run in reverse) at ragged shapes (T
    1-4200, W off multiples of 4 and 128, B 1-3) and at recurrentgemma-2b's
    training microbatch (B 1, T 4096, W 2560); ``ssd_chunk_bwd`` (three
    kernels; its tensor-core route's ptxas lines and HMMA counts first) at
    ragged shapes (l 1-1000 off the chunk, g 1-2, hp and n off 16, both
    dtypes and both bf16 routes, the bf16 route with the forward's
    workspace and without), at the probe's decay span (dt 0.7, A -1 ..
    -64 over chunks of 128: every gradient finite, held to the plain
    backward in f64) and
    at mamba2-1.3b's training microbatch (b 1, l 4096, nh 64, hp 64, n
    128, g 1, Q 128) in bf16 and f32; always a nonzero h0 / S0 and the
    final state's cotangent. Eager and graph replay agree bit for bit, as
    do two runs, and a row's bits do not depend on B."""
    import torch
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1357)

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rg_inputs(B, T, W):
        a, b, h0 = rand((B, T, W), 0.9, 1.0), randn((B, T, W)) * 0.1, \
            randn((B, W))
        return {"a": a, "h": RS.rglru_scan(a, b, h0), "h0": h0,
                "dh": randn((B, T, W))}

    def rg_kern(s):
        return RS.rglru_scan_bwd(s["a"], s["h"], s["h0"], s["dh"])

    def rg_plain(s):
        return RS.rglru_scan_bwd_ref(s["a"], s["h"], s["h0"], s["dh"])

    for B, T, W in ((1, 1, 8), (2, 37, 3), (3, 300, 100), (1, 1000, 130),
                    (2, 37, 1), (1, 5, 64), (3, 1000, 2560),
                    (2, 4200, 100)):
        s = rg_inputs(B, T, W)
        check_grads("rglru_scan_bwd", f"B {B} T {T} W {W}", rg_kern(s),
                    rg_plain(s), [RG_BWD_TOL] * 3)
    T, W = TRAIN_SEQ, rg_cfg.lru_width
    check_bits(f"rglru_scan_bwd (B 1 T {T} W {W})",
               lambda s=rg_inputs(1, T, W): rg_kern(s))
    s = rg_inputs(3, 1000, W)
    three = rg_kern(s)
    for r in range(3):
        alone = rg_kern({k: v[r:r + 1].contiguous() for k, v in s.items()})
        if not all(torch.equal(x[r:r + 1], y) for x, y in zip(three, alone)):
            fail(f"rglru_scan_bwd: row {r} of a B 3 call differs from the "
                 f"same row alone")
    log(f"[kernels] rglru_scan_bwd agrees with its plain backward within "
        f"{RG_BWD_TOL} of each gradient's largest magnitude (T 1-4200, W "
        f"1-2560, B 1-3, nonzero h0); eager == eager again == graph replay "
        f"(B 1 T {T} W {W}), each row of B 3 == that row alone (T 1000)")

    log_ssd_bwd_build()

    def ssd_inputs(b, l, nh, hp, g, n, dtype, span=False):
        s = {"x": randn((b, l, nh, hp), dtype),
             "dt": (torch.full((b, l, nh), SPAN_DT, device=dev) if span
                    else rand((b, l, nh), 1e-3, 0.1)),
             "A": -(torch.arange(1, nh + 1, device=dev, dtype=torch.float32)
                    * (SPAN_A / nh if span else 1.0)),
             "B": randn((b, l, g, n), dtype), "C": randn((b, l, g, n), dtype),
             "S0": randn((b, nh, hp, n)), "dy": randn((b, l, nh, hp)),
             "dS": randn((b, nh, hp, n))}
        return s

    def fwd_args(s):
        return s["x"], s["dt"], s["A"], s["B"], s["C"], s["S0"]

    def ssd_kern(Q, with_ws=True):
        def run(s):
            ws = SC._forward(*fwd_args(s), Q)[2] if with_ws else None
            return SC.ssd_chunk_bwd(*fwd_args(s), s["dy"], s["dS"], Q, ws=ws)
        return run

    def ssd_plain(Q, dtype=torch.float32):
        def run(s):
            return SC.ssd_chunk_bwd_ref(
                *(t.to(dtype) for t in fwd_args(s)), s["dy"].to(dtype),
                s["dS"].to(dtype), Q)
        return run

    def tols(dtype):
        low = SSD_BWD_BF16 if dtype == torch.bfloat16 else SSD_BWD_TOL
        return [low, SSD_BWD_TOL, SSD_BWD_DA, low, low, SSD_BWD_TOL]

    for (b, l, nh, hp, g, n, Q), dt in (
            ((2, 37, 8, 16, 1, 16, 16), torch.float32),    # mamba2 smoke
            ((1, 150, 4, 40, 2, 24, 64), torch.float32),   # hp, n off 16
            ((1, 1, 4, 16, 1, 16, 128), torch.float32),    # l 1
            ((2, 1000, 4, 72, 2, 20, 128), torch.float32),  # hp 72, g 2
            ((2, 37, 8, 16, 1, 16, 16), torch.bfloat16),
            ((2, 10, 4, 8, 2, 8, 128), torch.bfloat16),    # l below a chunk
            ((1, 1, 4, 16, 1, 16, 128), torch.bfloat16),   # l 1
            ((1, 150, 4, 40, 2, 24, 64), torch.bfloat16),  # off 8: scalar
            ((1, 300, 4, 72, 2, 20, 128), torch.bfloat16),  # hp 72: the
            #                                   CUDA-core route's bf16
            ((1, 1000, 4, 64, 1, 128, 128), torch.bfloat16)):
        s = ssd_inputs(b, l, nh, hp, g, n, dt)
        shape = (f"b {b} l {l} nh {nh} hp {hp} g {g} n {n} Q {Q} "
                 f"{'bf16' if dt == torch.bfloat16 else 'f32'}")
        want = ssd_plain(Q)(s)
        check_grads("ssd_chunk_bwd", shape, ssd_kern(Q)(s), want, tols(dt))
        if dt == torch.bfloat16:
            check_grads("ssd_chunk_bwd", shape + ", states recomputed",
                        ssd_kern(Q, False)(s), want, tols(dt))
    nh, hp, g, n, Q = (mb_cfg.ssm_nheads, mb_cfg.ssm_headdim,
                       mb_cfg.ssm_ngroups, mb_cfg.ssm_state, mb_cfg.ssm_chunk)
    for dt in (torch.float32, torch.bfloat16):
        s = ssd_inputs(1, 256, nh, hp, g, n, dt, span=True)
        got = ssd_kern(Q)(s)
        check_grads("ssd_chunk_bwd", f"the probe's span: dt {SPAN_DT}, A "
                    f"-{SPAN_A / nh:g} .. -{SPAN_A:g}, b 1 l 256 nh {nh} "
                    f"{dt}", got, ssd_plain(Q, torch.float64)(s), tols(dt))
    s = ssd_inputs(3, 300, 4, 64, 2, 32, torch.bfloat16)
    three = ssd_kern(Q)(s)
    for r in range(3):
        alone = ssd_kern(Q)({k: v[r:r + 1].contiguous() if k not in ("A",)
                             else v for k, v in s.items()})
        if not all(torch.equal(x[r:r + 1], y)
                   for i, (x, y) in enumerate(zip(three, alone)) if i != 2):
            fail(f"ssd_chunk_bwd: row {r} of a b 3 call differs from the "
                 f"same row alone")
    log(f"[kernels] ssd_chunk_bwd agrees with its plain backward (l 1-1000, "
        f"hp 8-72, n 8-128, g 1-2, Q 16-128, f32 and bf16, the bf16 route "
        f"with the forward's states and recomputing them, nonzero S0 and "
        f"dS_final; f32 gradients within {SSD_BWD_TOL} of their largest "
        f"magnitude, dA {SSD_BWD_DA}, bf16 ones {SSD_BWD_BF16}); at the "
        f"probe's span every gradient finite and within those of the plain "
        f"backward in f64; each row of b 3 == that row alone (dA aside)")

    rows = {}
    l = TRAIN_SEQ
    cases = [
        ("rglru_scan_bwd", f"B 1 T {l} W {W} f32",
         [rg_inputs(1, l, W) for _ in range(2)], rg_kern, rg_plain,
         lambda s: torch.cumsum(s["dh"], dim=1), [RG_BWD_TOL] * 3,
         5 * l * W * 4 + 2 * W * 4, 3 * l * W, F32_FLOPS,
         "rglru_scan/csrc/rglru_scan.cu",
         "src/repro/kernels/rglru_scan/rglru_scan.py:57"),
    ]
    for dt, elem in ((torch.bfloat16, 2), (torch.float32, 4)):
        cases.append((
            "ssd_chunk_bwd", f"b 1 l {l} nh {nh} hp {hp} g {g} n {n} Q {Q} "
            f"{'bf16, the forward states kept' if elem == 2 else 'f32, states recomputed'}",
            [ssd_inputs(1, l, nh, hp, g, n, dt) for _ in range(2)],
            None, ssd_plain(Q), None, tols(dt),
            ssd_bwd_bytes(l, nh, hp, g, n, elem),
            ssd_bwd_flops(l, Q, nh, hp, g, n), F32_FLOPS,
            "ssd_chunk/csrc/ssd_chunk_bwd.cu",
            "src/repro/kernels/ssd_chunk/ssd_chunk.py:81"))
    for (name, shape, sets, kern, plain, library, tl, nbytes, flops, peak,
         src, replaces) in cases:
        if name == "ssd_chunk_bwd":
            for st in sets:            # the forward's workspace, kept
                st["ws"] = SC._forward(*fwd_args(st), Q)[2]

            def kern(st):
                return SC.ssd_chunk_bwd(*fwd_args(st), st["dy"], st["dS"],
                                        Q, ws=st["ws"])
        err = check_grads(name, shape, kern(sets[0]), plain(sets[0]), tl)
        check_bits(f"{name} ({shape})", lambda: kern(sets[0]))
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(sets)
            return sets[it["i"]]

        ms = time_ms(lambda: kern(nxt()), iters=10)
        device_ms = graph_ms(lambda: kern(nxt()), iters=5, reps=3)
        plain_ms = time_ms(lambda: plain(nxt()), iters=2, warmup=1)
        library_ms = (time_ms(lambda: library(nxt()), iters=20)
                      if library is not None else None)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernels] {name} ({shape}): max_abs_err {err:.3e} kernel_ms "
            f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{'-' if library_ms is None else f'{library_ms:.4f}'} bound_ms "
            f"{bound_ms:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP at the f32 rate; at the bf16 rate "
            f"{flops / BF16_FLOPS * 1e3:.4f} ms); by graph replay: kernel "
            f"{device_ms:.4f}, {bound_ms / device_ms:.1%} of bound; "
            f"{card()}")
        log_kernel_parts(f"{name} ({shape})", lambda: kern(nxt()),
                         "rglru" if name == "rglru_scan_bwd"
                         else r"tc::\w+_bwd|ssd_", calls=5)
        if name == "ssd_chunk_bwd" and "bf16" in shape:
            tc_flops = ssd_bwd_tc_flops(l, Q, nh, hp, g, n)
            tc_bound = max(t_bytes, tc_flops / BF16_FLOPS) * 1e3
            occ = SC._bwd_library().ssd_chunk_bwd_occupancy
            log(f"[kernels] {name} ({shape}): the tensor-core route's "
                f"bound, the split's products counted ({tc_flops / 1e9:.2f}"
                f" GFLOP at the bf16 rate): {tc_bound:.4f} ms, "
                f"{tc_bound / device_ms:.1%} of it by replay; at the f32 "
                f"rate {bound_ms:.4f} ms; resident blocks an SM: "
                f"states_bwd {occ(0)}, chunk_bwd {occ(1)} "
                f"({SC._bwd_shares(0, nh, hp, g)} shares of dB, dC)")
        if name not in rows:          # the JSON row: the training shape
            rows[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/{src}",
                "replaces": replaces, "launches": 0, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "device_ms": device_ms}
            if name == "ssd_chunk_bwd":
                rows[name]["bound_tc_ms"] = tc_bound
        del sets
        torch.cuda.empty_cache()
    log("[kernels] library_ms: rglru_scan_bwd — torch.cumsum over T on dh "
        "(same bytes in, not the same function); ssd_chunk_bwd — none (no "
        "single PyTorch call computes it); rglru_scan_bwd replaces the "
        "gradient of the function of src/repro/kernels/rglru_scan/"
        "rglru_scan.py:57, ssd_chunk_bwd that of :81 of ssd_chunk.py (JAX "
        "differentiates the reference by autodiff; neither Pallas kernel "
        "has a backward)")
    return rows


def attention_pairs(qpos, kpos, causal: bool):
    """[sq, skv] bool: the (query, key) pairs the attention function
    computes — keys at a position >= 0 and, when causal, not after the
    query's position."""
    ok = (kpos[None, :] >= 0).expand(qpos.shape[0], -1)
    return ok & (kpos[None, :] <= qpos[:, None]) if causal else ok


def phase_flash_kernels(cfg, sm_cfg, vl_cfg):
    """flash_attention against its plain version (the blocked loop, on the
    same inputs in the same dtype) on the rows that have a valid key — a
    row with none is garbage in the plain loop and zeros from the kernel,
    and the model never reads it. Ragged shapes first (head dims 16-128 in
    f32 and bf16, sq != skv and off the 64-row q-tile, -1 key positions,
    a first kv-tile with no valid key for some rows, reversed key
    positions, queries starting past 0, the seamless smoke config's
    encoder and cross shapes, every engine bucket at minitron-8b's and
    qwen2-vl-72b's widths, qwen2-vl-72b's vision prompt with its image's
    tokens all at stream-0 position 0),
    then the six full-width shapes with times:
    minitron-8b's 2048-token causal prefill (32 q / 8 KV heads of 128),
    seamless-m4t-medium's encoder (1536 frames, 16 heads of 64), its
    cross attention (1024 x 1536) and its training microbatch's decoder
    self attention (TRAIN_SEQ, causal) and cross attention (TRAIN_SEQ x
    1536), and qwen2-vl-72b's 2048-token causal
    prefill (64 q / 8 KV heads of 128), bf16. Inputs rotate over 4 sets.
    Library: SDPA on the [b, h, s, d] transposed views. The JSON row is
    minitron's, with every shape in its ``shapes``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.serving.engine import prefill_buckets

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1357)
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(b, sq, skv, hq, hkv, d, dtype, holes=False, q_off=0):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        x = {"q": randn(b, sq, hq, d), "k": randn(b, skv, hkv, d),
             "v": randn(b, skv, hkv, d),
             "qpos": torch.arange(sq, dtype=torch.int32, device=dev) + q_off,
             "kpos": torch.arange(skv, dtype=torch.int32, device=dev)}
        if holes == "first64":           # the first kv-tile all -1
            x["kpos"][:64] = -1
        elif holes == "reversed":        # tile 0 holds the latest keys
            x["kpos"] = x["kpos"].flip(0).contiguous()
        elif holes == "tied":            # an image's patches share t 0
            nv = vl_cfg.num_frontend_tokens
            t = torch.from_numpy(vision_positions(
                1, sq, nv, int(round(nv ** 0.5)), repeat_t=True)[0, 0])
            x["qpos"] = x["kpos"] = t.to(dev)
        elif holes:
            x["kpos"][skv // 3:skv // 3 + 70] = -1
            x["kpos"][-5:] = -1
        return x

    def kern(x, causal):
        return FA.flash_attention(x["q"], x["k"], x["v"], x["qpos"],
                                  x["kpos"], causal=causal)

    def plain(x, causal, blocks):
        return FA.blocked_attention(x["q"], x["k"], x["v"], x["qpos"],
                                    x["kpos"], causal=causal, window=0,
                                    block_q=blocks[0], block_kv=blocks[1])

    def check(label, x, causal, blocks):
        got = kern(x, causal)
        torch.cuda.synchronize()
        want = plain(x, causal, blocks).float()
        rows = attention_pairs(x["qpos"], x["kpos"], causal).any(1)
        tol = ATOL if x["q"].dtype == bf16 else F32_TOL
        err = (got.float() - want)[:, rows].abs()
        bad = err > tol + tol * want[:, rows].abs()
        if not torch.isfinite(got[:, rows]).all() or bool(bad.any()):
            fail(f"flash_attention ({label}): kernel disagrees with its "
                 f"plain version (max abs err {float(err.max()):.3e}, "
                 f"{int(bad.sum())} elements past atol=rtol={tol})")
        return float(err.max())

    small = (16, 32)
    for (b, sq, skv, hq, hkv, d, causal, dtype, holes, q_off) in (
            (1, 257, 257, 4, 2, 16, True, f32, False, 0),
            (2, 24, 24, 4, 4, 32, False, f32, False, 0),   # seamless smoke
            (2, 40, 24, 4, 4, 32, False, f32, False, 0),   # its cross
            (2, 100, 300, 4, 1, 64, False, bf16, True, 0),
            (1, 70, 150, 4, 2, 48, True, f32, True, 40),
            (1, 130, 130, 8, 8, 128, True, bf16, False, 0),
            (2, 33, 33, 6, 2, 80, True, bf16, False, 0),
            (1, 65, 200, 2, 1, 96, False, bf16, True, 0),
            (1, 50, 50, 2, 2, 112, True, f32, False, 0),
            (1, 1, 1, 2, 1, 64, True, bf16, False, 0),
            # the bf16 route at the head dims above that run only in f32,
            # and at sq off its 64-row q-tile
            (1, 257, 257, 4, 2, 16, True, bf16, False, 0),
            (2, 40, 24, 4, 4, 32, False, bf16, False, 0),
            (1, 70, 150, 4, 2, 48, True, bf16, True, 40),
            (1, 50, 50, 2, 2, 112, True, bf16, False, 0),
            (2, 200, 200, 8, 2, 128, True, bf16, False, 0),
            # rows whose first kv-tile has no valid key: the first 64 keys
            # -1 (queries at 30-129: rows 0-33 see no key at all, beside
            # rows that do), and reversed key positions under causal
            (1, 100, 180, 4, 1, 64, True, bf16, "first64", 30),
            (1, 130, 130, 4, 1, 128, True, bf16, "reversed", 0)):
        check(f"b {b} sq {sq} skv {skv} hq {hq} hkv {hkv} d {d} causal "
              f"{causal} {dtype}", inputs(b, sq, skv, hq, hkv, d, dtype,
                                          holes, q_off), causal, small)
    blocks = (cfg.attn_block_q, cfg.attn_block_kv)
    for s in prefill_buckets(2048):
        check(f"minitron bucket {s}", inputs(1, s, s, cfg.num_heads,
                                             cfg.num_kv_heads,
                                             cfg.head_dim, bf16),
              True, blocks)
    vl_blocks = (vl_cfg.attn_block_q, vl_cfg.attn_block_kv)
    vl_heads = (vl_cfg.num_heads, vl_cfg.num_kv_heads, vl_cfg.head_dim)
    for s in prefill_buckets(QWEN2VL_MAX_LEN):
        check(f"qwen2-vl bucket {s}", inputs(1, s, s, *vl_heads, bf16),
              True, vl_blocks)
    n = QWEN2VL_VISION_TOKENS
    check(f"qwen2-vl vision prompt {n}, stream 0 tied over the image",
          inputs(1, n, n, *vl_heads, bf16, holes="tied"), True, vl_blocks)
    log("[kernels] flash_attention agrees with its plain version at ragged "
        "shapes (d 16-128 in f32 and bf16, sq 1-257, skv 1-300, -1 keys, "
        "a first kv-tile with no valid key, reversed key positions), at "
        f"every engine bucket {prefill_buckets(2048)} at minitron-8b's and "
        f"qwen2-vl-72b's widths, and at qwen2-vl-72b's {n}-token vision "
        f"prompt whose {vl_cfg.num_frontend_tokens} image tokens share "
        f"stream-0 position 0, on the rows with a valid key")
    from repro_torch.kernels import build
    entry = ""
    for line in build.build_log("flash_attention").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            for d in (64, 128):
                if f"flash_tc_kernelILi{d}E" in entry:
                    log(f"[build] flash_attention bf16 d {d}: "
                        f"{line.strip()}")

    sm_blocks = (sm_cfg.attn_block_q, sm_cfg.attn_block_kv)
    hs, ds = sm_cfg.num_heads, sm_cfg.head_dim
    src = sm_cfg.source_len
    shapes = [
        (f"{cfg.name} prefill b 1 s 2048 hq {cfg.num_heads} hkv "
         f"{cfg.num_kv_heads} d {cfg.head_dim} causal",
         (1, 2048, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
         True, blocks),
        (f"{sm_cfg.name} encoder b 1 s {src} h {hs} d {ds}",
         (1, src, src, hs, hs, ds), False, sm_blocks),
        (f"{sm_cfg.name} cross b 1 sq 1024 skv {src} h {hs} d {ds}",
         (1, 1024, src, hs, hs, ds), False, sm_blocks),
        (f"{sm_cfg.name} decoder train microbatch b 1 s {TRAIN_SEQ} h {hs} "
         f"d {ds} causal", (1, TRAIN_SEQ, TRAIN_SEQ, hs, hs, ds), True,
         sm_blocks),
        (f"{sm_cfg.name} cross train microbatch b 1 sq {TRAIN_SEQ} skv "
         f"{src} h {hs} d {ds}", (1, TRAIN_SEQ, src, hs, hs, ds), False,
         sm_blocks),
        (f"{vl_cfg.name} prefill b 1 s 2048 hq {vl_cfg.num_heads} hkv "
         f"{vl_cfg.num_kv_heads} d {vl_cfg.head_dim} causal",
         (1, 2048, 2048, vl_cfg.num_heads, vl_cfg.num_kv_heads,
          vl_cfg.head_dim), True, (vl_cfg.attn_block_q, vl_cfg.attn_block_kv)),
    ]
    rows = {}
    for label, (b, sq, skv, hq, hkv, d), causal, blk in shapes:
        sets = [inputs(b, sq, skv, hq, hkv, d, bf16) for _ in range(4)]
        err = check(label, sets[0], causal, blk)
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(sets)
            return sets[it["i"]]

        def sdpa(x):
            return F.scaled_dot_product_attention(
                x["q"].transpose(1, 2), x["k"].transpose(1, 2),
                x["v"].transpose(1, 2), is_causal=causal, enable_gqa=True)

        ms = time_ms(lambda: kern(nxt(), causal), iters=20)
        plain_ms = time_ms(lambda: plain(nxt(), causal, blk), iters=3,
                           warmup=1)
        library_ms = time_ms(lambda: sdpa(nxt()), iters=20)
        pairs = int(attention_pairs(sets[0]["qpos"], sets[0]["kpos"],
                                    causal).sum())
        flops = 4 * b * hq * d * pairs
        nbytes = 2 * (2 * b * sq * hq * d + 2 * b * skv * hkv * d) \
            + 4 * (sq + skv)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernels] flash_attention ({label}): max_abs_err {err:.3e} "
            f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; kernel "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of bound, "
            f"x library {ms / library_ms:.2f})")
        if not rows:                     # the JSON row: minitron's prefill
            rows["flash_attention"] = {
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/"
                            "flash_attention.py:98",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "shapes": []}
        rows["flash_attention"]["shapes"].append({
            "shape": label, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "ratio": ms / library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err})
        del sets
        torch.cuda.empty_cache()
    log("[kernels] library_ms: flash_attention — "
        "torch.nn.functional.scaled_dot_product_attention (is_causal, "
        "enable_gqa) on the transposed [b, h, s, d] views")
    return rows


def hgmma_counts(lib: str, name, op: str = "HGMMA") -> dict:
    """HGMMA (wgmma) instructions, or those of opcode ``op`` (HMMA:
    mma.sync), ``cuobjdump -sass`` finds in each kernel of library ``lib``
    whose mangled name matches the regex ``name``, by the matched text."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build._target(lib))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr.strip()[:500]}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            m = name.search(line)
            fn = m.group(0) if m else None
            if fn:
                counts[fn] = 0
        elif fn and op in line:
            counts[fn] += 1
    return counts


def log_bwd_build() -> None:
    """ptxas registers and spills of the backward's wgmma kernels at each
    padded head dim, and the HGMMA (wgmma) instructions ``cuobjdump -sass``
    finds in each: fails where one has none."""
    import re
    from repro_torch.kernels import build
    name = re.compile(f"({'|'.join(BWD_KERNELS)})ILi(\\d+)E")
    entry = ""
    for line in build.build_log("flash_attention_bwd").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line or "C75" in line:
            m = name.search(line if "C75" in line else entry)
            if m:
                log(f"[build] flash_attention_bwd {m.group(1)}<{m.group(2)}>"
                    f": {line.strip()[:160]}")
    counts = {}
    for k, v in hgmma_counts("flash_attention_bwd", name).items():
        m = name.search(k)
        counts[f"{m.group(1)}<{m.group(2)}>"] = v
    log(f"[build] flash_attention_bwd HGMMA instructions (cuobjdump -sass): "
        + ", ".join(f"{k} {v}" for k, v in sorted(counts.items()))
        + " (ptxas reports the registers a thread has at launch; "
        "setmaxnreg then moves them from the producer warpgroup to the "
        "consumers)")
    want = {f"{k}<{dp}>" for k in BWD_KERNELS for dp in (64, 128)}
    if set(counts) != want or not all(counts.values()):
        fail(f"flash_attention_bwd: wgmma kernels {want} with HGMMA "
             f"instructions expected, found {counts}")


def phase_flash_bwd_kernels(cfg, sm_cfg):
    """flash_attention's backward kernels (csrc/flash_attention_bwd.cu)
    against their plain version (``flash_attention_bwd_ref``) on the same
    inputs: q, k, v, dO, and the output and lse of the forward kernel.
    Both compute zero gradients for a row with no valid key, so every row
    is compared. Ragged shapes in f32 (within atol = rtol = 1e-5) and bf16
    (each row of dq, dk, dv within BWD_ROW of its norm: bf16 inputs and
    outputs, P and dS rounded to bf16 before their products),
    then six full-width bf16 shapes with times: the training path's
    4096-token causal microbatch of minitron-8b, minitron-8b's 2048-token
    prefill, seamless-m4t-medium's encoder and cross attention, and the
    two that its training step adds (the decoder's causal self attention
    and the cross attention of a TRAIN_SEQ-token microbatch). At the
    first, three planted faults made from the kernel's own outputs must
    fail that check: dq without one key tile's share for the later half
    of the queries, dk and dv without one query tile's share, dv of the
    last 256 keys zeroed. At each:
    the forward with lse gives the output of the forward without it bit
    for bit, and a CUDA-graph replay of the backward gives the eager call's
    bits. Before them: the wgmma kernels' build (``log_bwd_build``), and
    row b 1 of a b-2 call equal bit for bit to the same row alone. Times:
    eager (``ms``) and by replay (``device_ms``); library: SDPA's backward
    through autograd on the [b, h, s, d] views, eager and its kernels'
    device time (``library_device_ms``, the profiler's sum over its
    kernels; it is not timed by replay). Bounds:
    the five products the function needs (``bound_ms``) and the seven the
    kernels do (``bound_7_products_ms``: dQ's kernel takes S and dP
    again)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as FA

    log_bwd_build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2468)
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(b, sq, skv, hq, hkv, d, dtype, holes=False, q_off=0):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        x = {"q": randn(b, sq, hq, d), "k": randn(b, skv, hkv, d),
             "v": randn(b, skv, hkv, d), "do": randn(b, sq, hq, d),
             "qpos": torch.arange(sq, dtype=torch.int32, device=dev) + q_off,
             "kpos": torch.arange(skv, dtype=torch.int32, device=dev)}
        if holes == "first64":
            x["kpos"][:64] = -1
        elif holes == "reversed":
            x["kpos"] = x["kpos"].flip(0).contiguous()
        elif holes:
            x["kpos"][skv // 3:skv // 3 + 70] = -1
            x["kpos"][-5:] = -1
        return x

    def fwd(x, causal):
        return FA.flash_attention_lse(x["q"], x["k"], x["v"], x["qpos"],
                                      x["kpos"], causal=causal)

    def bwd(x, causal):
        return FA.flash_attention_bwd(x["q"], x["k"], x["v"], x["o"],
                                      x["lse"], x["do"], x["qpos"],
                                      x["kpos"], causal=causal)

    def plain(x, causal):
        return FA.flash_attention_bwd_ref(
            x["q"], x["k"], x["v"], x["o"], x["lse"], x["do"], x["qpos"],
            x["kpos"], causal=causal, block_q=256, block_kv=1024)

    def row_errs(got, want):
        return [float(row_err(g, w).max()) for g, w in zip(got, want)]

    def check(label, x, causal):
        """(max abs err, each gradient's worst row error)."""
        x["o"], x["lse"] = fwd(x, causal)
        plain_o = FA.flash_attention(x["q"], x["k"], x["v"], x["qpos"],
                                     x["kpos"], causal=causal)
        if not torch.equal(x["o"], plain_o):
            fail(f"flash_attention ({label}): the forward with lse differs "
                 f"from the forward without it")
        got = bwd(x, causal)
        torch.cuda.synchronize()
        want = plain(x, causal)
        errs, rerrs = [], row_errs(got, want)
        for name, g, w, rerr in zip(("dq", "dk", "dv"), got, want, rerrs):
            g, w = g.float(), w.float()
            err = (g - w).abs()
            if x["q"].dtype == f32:
                bad = bool((err > F32_TOL + F32_TOL * w.abs()).any())
            else:
                bad = rerr > BWD_ROW
            if bad or not torch.isfinite(g).all():
                fail(f"flash_attention_bwd ({label}): {name} disagrees with "
                     f"the plain version (max abs err {float(err.max()):.3e}, "
                     f"worst row {rerr:.3e} of its norm)")
            errs.append(float(err.max()))
        return max(errs), rerrs

    def planted(label, x, causal):
        """Faults made from the kernel's outputs, each of which the bf16
        check must reject."""
        sq = x["q"].shape[1]
        want = plain(x, causal)
        dq, dk, dv = bwd(x, causal)
        holed = dict(x, kpos=x["kpos"].clone())
        holed["kpos"][FAULT_TILE] = -1
        dq_holed = bwd(holed, causal)[0]
        quiet = dict(x, do=x["do"].clone())
        quiet["do"][:, 3 * sq // 4:3 * sq // 4 + 64] = 0
        _, dk_quiet, dv_quiet = bwd(quiet, causal)
        dv_cut = dv.clone()
        dv_cut[:, -256:] = 0
        faults = (
            (f"dq without keys {FAULT_TILE.start}-{FAULT_TILE.stop - 1} for "
             f"queries {sq // 2}-", (torch.cat(
                 [dq[:, :sq // 2], dq_holed[:, sq // 2:]], 1), dk, dv)),
            (f"dk, dv without queries {3 * sq // 4}-{3 * sq // 4 + 63}",
             (dq, dk_quiet, dv_quiet)),
            ("dv of the last 256 keys zeroed", (dq, dk, dv_cut)))
        for name, got in faults:
            rerrs = row_errs(got, want)
            log(f"[kernels] flash_attention_bwd ({label}): planted fault "
                f"'{name}': worst row error dq/dk/dv "
                + " / ".join(f"{e:.3e}" for e in rerrs)
                + f" (bound {BWD_ROW})")
            if max(rerrs) <= BWD_ROW:
                fail(f"flash_attention_bwd ({label}): the check passes the "
                     f"planted fault '{name}'")

    worst = 0.0
    for (b, sq, skv, hq, hkv, d, causal, holes, q_off) in (
            (1, 257, 257, 4, 2, 16, True, False, 0),
            (2, 40, 24, 4, 4, 32, False, False, 0),
            (2, 100, 300, 4, 1, 64, False, True, 0),
            (1, 70, 150, 4, 2, 48, True, True, 40),
            (1, 130, 130, 8, 8, 128, True, False, 0),
            (2, 33, 33, 6, 2, 80, True, False, 0),
            (1, 65, 200, 2, 1, 96, False, True, 0),
            (1, 50, 50, 2, 2, 112, True, False, 0),
            (1, 1, 1, 2, 1, 64, True, False, 0),
            (1, 100, 180, 4, 1, 64, True, "first64", 30),
            (1, 130, 130, 4, 1, 128, True, "reversed", 0)):
        for dtype in (f32, bf16):
            _, rerrs = check(
                f"b {b} sq {sq} skv {skv} hq {hq} hkv {hkv} d {d} causal "
                f"{causal} {holes or ''} {dtype}",
                inputs(b, sq, skv, hq, hkv, d, dtype, holes, q_off), causal)
            if dtype == bf16:
                worst = max([worst] + rerrs)
    log(f"[kernels] flash_attention_bwd agrees with its plain version at "
        f"ragged shapes in f32 (1e-5) and bf16 (worst row error {worst:.3e}"
        f" of the row's norm; d 16-128, sq 1-257, skv 1-300, -1 keys, a "
        f"first kv-tile with no valid key, reversed key positions); the "
        f"forward with lse equals the forward without it; every route the "
        f"launcher dispatches to ran: bf16 on dkdv/dq_wgmma_kernel<64> (d "
        f"16-64) and <128> (d 80-128), f32 on the CUDA cores (d 16-128)")
    for b2, sq, skv, hq, hkv, d, causal in ((2, 300, 300, 8, 2, 128, True),
                                            (3, 200, 260, 4, 4, 64, False)):
        x = inputs(b2, sq, skv, hq, hkv, d, bf16)
        x["o"], x["lse"] = fwd(x, causal)
        whole = bwd(x, causal)
        alone = bwd({k: t[1:2].contiguous() if k in ("q", "k", "v", "do",
                                                       "o", "lse") else t
                     for k, t in x.items()}, causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a[1:2], r) for a, r in zip(whole, alone)):
            fail(f"flash_attention_bwd: row b 1 of a b-{b2} call (sq {sq} "
                 f"skv {skv} hq {hq} hkv {hkv} d {d}) differs from the same "
                 f"row alone")
    log("[kernels] flash_attention_bwd: row b 1 of a b-2 (d 128, causal, "
        "GQA 4) and a b-3 (d 64, full) call equals the same row alone, bit "
        "for bit")

    hs, ds, src = sm_cfg.num_heads, sm_cfg.head_dim, sm_cfg.source_len
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    shapes = [
        (f"{cfg.name} train microbatch b 1 s {TRAIN_SEQ} hq {heads[0]} hkv "
         f"{heads[1]} d {heads[2]} causal", (1, TRAIN_SEQ, TRAIN_SEQ) + heads,
         True),
        (f"{cfg.name} prefill b 1 s 2048 causal", (1, 2048, 2048) + heads,
         True),
        (f"{sm_cfg.name} encoder b 1 s {src} h {hs} d {ds}",
         (1, src, src, hs, hs, ds), False),
        (f"{sm_cfg.name} cross b 1 sq 1024 skv {src} h {hs} d {ds}",
         (1, 1024, src, hs, hs, ds), False),
        (f"{sm_cfg.name} decoder train microbatch b 1 s {TRAIN_SEQ} h {hs} "
         f"d {ds} causal", (1, TRAIN_SEQ, TRAIN_SEQ, hs, hs, ds), True),
        (f"{sm_cfg.name} cross train microbatch b 1 sq {TRAIN_SEQ} skv "
         f"{src} h {hs} d {ds}", (1, TRAIN_SEQ, src, hs, hs, ds), False),
    ]
    rows = {}
    for label, (b, sq, skv, hq, hkv, d), causal in shapes:
        sets = [inputs(b, sq, skv, hq, hkv, d, bf16) for _ in range(4)]
        err, rerrs = check(label, sets[0], causal)
        log(f"[kernels] flash_attention_bwd ({label}): worst row error "
            f"dq/dk/dv " + " / ".join(f"{e:.3e}" for e in rerrs)
            + f" of the row's norm (bound {BWD_ROW})")
        if not rows:
            planted(label, sets[0], causal)
        for x in sets[1:]:
            x["o"], x["lse"] = fwd(x, causal)
        eager = bwd(sets[0], causal)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bwd(sets[0], causal)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            replayed = bwd(sets[0], causal)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, r) for a, r in zip(eager, replayed)):
            fail(f"flash_attention_bwd ({label}): graph replay differs from "
                 f"the eager call")
        del graph, replayed
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(sets)
            return sets[it["i"]]

        lib = []
        for x in sets:
            qs, ks, vs = (x[n].transpose(1, 2).detach().requires_grad_(True)
                          for n in ("q", "k", "v"))
            out = F.scaled_dot_product_attention(qs, ks, vs,
                                                 is_causal=causal,
                                                 enable_gqa=True)
            lib.append((out, (qs, ks, vs), x["do"].transpose(1, 2)))
        il = {"i": 0}

        def sdpa_bwd():
            il["i"] = (il["i"] + 1) % len(lib)
            out, ins, do = lib[il["i"]]
            return torch.autograd.grad(out, ins, do, retain_graph=True)

        ms = time_ms(lambda: bwd(nxt(), causal), iters=10)
        device_ms = graph_ms(lambda: bwd(nxt(), causal), iters=4, reps=3)
        plain_ms = time_ms(lambda: (lambda x: FA.flash_attention_bwd_ref(
            x["q"], x["k"], x["v"], x["o"], x["lse"], x["do"], x["qpos"],
            x["kpos"], causal=causal, block_q=256, block_kv=1024))(nxt()),
            iters=2, warmup=1)
        library_ms = time_ms(sdpa_bwd, iters=10)
        library_device_ms, lib_kernels = profiled_ms(sdpa_bwd)
        pairs = int(attention_pairs(sets[0]["qpos"], sets[0]["kpos"],
                                    causal).sum())
        flops = 10 * b * hq * d * pairs          # S, dP, dV, dK, dQ
        nbytes = 2 * (3 * b * sq * hq * d + 2 * b * skv * hkv * d) \
            + 4 * b * hq * sq + 4 * (sq + skv) \
            + 2 * (b * sq * hq * d + 2 * b * skv * hkv * d)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        bound7_ms = max(t_bytes, 1.4 * t_ops) * 1e3   # + S, dP in dQ's
        log(f"[kernels] flash_attention_bwd ({label}): max_abs_err "
            f"{err:.3e} kernel_ms {ms:.4f} device_ms {device_ms:.4f} "
            f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} / "
            f"{library_device_ms:.4f} by its kernels (SDPA backward) "
            f"bound_ms {bound_ms:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.1f} GFLOP), {bound7_ms:.4f} for the 7 products "
            f"done; kernel {flops / device_ms / 1e9:.1f} TFLOP/s of the 5 "
            f"by replay, {bound_ms / device_ms:.1%} of bound, x library "
            f"{ms / library_ms:.2f} eager, "
            f"{device_ms / library_device_ms:.2f} on the device); eager == "
            f"replay bitwise")
        log(f"[kernels] flash_attention_bwd ({label}): SDPA backward's "
            f"kernels, device ms a call: " + "; ".join(
                f"{t:.4f} {n[:70]}" for n, t in lib_kernels))
        if not rows:                     # the JSON row: the train shape
            rows["flash_attention_bwd"] = {
                "name": "flash_attention_bwd", "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention_bwd.cu",
                "replaces": "src/repro/kernels/flash_attention/"
                            "flash_attention.py:98",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "device_ms": device_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_7_products_ms": bound7_ms,
                "library_ms": library_ms,
                "library_device_ms": library_device_ms, "shapes": []}
        rows["flash_attention_bwd"]["shapes"].append({
            "shape": label, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "ratio": ms / library_ms, "bound_ms": bound_ms,
            "bound_7_products_ms": bound7_ms, "bound_by": bound_by,
            "max_abs_err": err})
        del sets, lib, eager
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path at full width
# ---------------------------------------------------------------------------

def phase_serve(model: str, params):
    from repro_torch.launch.serve import serve
    t0 = time.perf_counter()
    served, reports = serve(model, sessions=4, requests=8, slots=8,
                            max_len=2048, gen_tokens=16, params=params,
                            device="cuda", quiet=True)
    log(f"[serve] {model}: served {served}/8 in "
        f"{time.perf_counter() - t0:.2f} s")
    if served != 8:
        fail(f"serve() served {served}/8 requests of {model}")
    for sid, rep in reports.items():
        log(f"[serve] {model} {sid}: n={rep.n} "
            f"ttft_ms={rep.z.get('t_ff_ms')} q99_ms={rep.z.get('q99_ms')}")


def run_engine(cfg, params, prompts, *, paged: bool, steps: int, chunk: int,
               profile: bool = True, max_len: int = 2048):
    import torch
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, params=params, slots=len(prompts),
                          max_len=max_len, paged=paged, device="cuda")
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
    if profile:
        profile_round(eng, f"{cfg.name} {'paged' if paged else 'dense'}")
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
    log_profile(prof, name, wall_us, steps, "step")


def profile_prefill(cfg, params, n: int = 1500, width: int = 2048) -> None:
    """Where a prefill's time goes: one prompt of ``n`` tokens in the
    ``width`` bucket (with the encoder's frames for encdec) through
    ``LM.prefill`` under torch.profiler, after the path's launch window."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.frontends import fake_audio_frames
    from repro_torch.models.transformer import LM
    tokens = np.zeros((1, width), np.int32)
    tokens[0, :n] = np.random.default_rng(5).integers(0, cfg.vocab_size, n)
    batch = {"tokens": torch.from_numpy(tokens).cuda(), "length": n}
    if cfg.family == "encdec":
        batch["frames"] = fake_audio_frames(
            cfg, torch.Generator(device="cuda").manual_seed(5), 1)
    lm = LM(cfg)
    with torch.no_grad():
        lm.prefill(params, batch, width)          # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lm.prefill(params, batch, width)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    log_profile(prof, f"{cfg.name} prefill {n} tokens (bucket {width})",
                wall_us, 1, "prefill")


def log_profile(prof, name: str, wall_us: float, steps: int,
                unit: str) -> None:
    """Device-busy share of the wall time, the kernels that take the most
    device time and the host ops that take the most host time, per
    ``unit`` (``steps`` of them in the profile)."""

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: host ops (aten::mm, ...) also report the device time of
    # the kernels they launched, which would count it twice
    avgs = prof.key_averages()
    events = [e for e in avgs
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events)
    log(f"[profile] {name}: {steps} {unit}s wall "
        f"{wall_us / steps / 1e3:.2f} ms/{unit} (profiled), device busy "
        f"{busy / steps / 1e3:.2f} ms/{unit} = {100 * busy / wall_us:.1f}% "
        f"of wall")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        log(f"[profile] {name}:   {dev_us(e) / steps / 1e3:8.3f} ms/{unit} "
            f"x{e.count // steps:<4d} {e.key[:90]}")
    # int8 weights: as_weight's int8 -> f32 copy, scale product and bf16
    # cast (with the path's other copies and f32 products, which are
    # activation-sized), beside the cuBLAS GEMMs on its output
    for label, keys in (("flash_attention", ("flash_tc_kernel",)),
                        ("flash_attention_bwd", BWD_KERNELS
                         + ("::dot_kernel<",)),
                        ("decode attention", ("decode_attn",)),
                        ("ssd_chunk", ("tc::ssd_", "ssd_chunk_kernel(")),
                        ("ssd_chunk_bwd", ("ssd_states_bwd<",
                                           "ssd_chunk_bwd<",
                                           "tc::states_bwd(",
                                           "tc::chunk_bwd(",
                                           "ssd_bc_reduce<")),
                        ("rglru_scan", ("rglru_scan_kernel<true, false>",
                                        "rglru_scan_kernel<false, false>")),
                        ("rglru_scan_bwd", ("rglru_scan_kernel<true, true>",
                                            "rglru_scan_kernel<false, true>")),
                        ("expert kernels", ("tc::tc_kernel<",
                                            "i8::kernel<")),
                        ("expert backward K1", ("wgrad::dgu_kernel<",)),
                        ("expert backward products (K2, K3)", (
                            "wgrad::dx_kernel<", "wgrad::dw_kernel<",
                            "cc::gemm_kernel<")),
                        ("copies, casts and f32 products", (
                            "direct_copy_kernel_cuda",
                            "bfloat16_copy_kernel_cuda", "MulFunctor<float>")),
                        ("cuBLAS GEMMs", ("nvjet", "gemm_", "cutlass"))):
        mine = [e for e in events if any(k in e.key for k in keys)]
        if mine:
            t = sum(dev_us(e) for e in mine)
            log(f"[profile] {name}: {label} {t / steps / 1e3:.3f} "
                f"ms/{unit} ({100 * t / busy:.1f}% of device busy) in "
                f"{sum(e.count for e in mine) // steps} kernels/{unit}")
    host = [e for e in avgs if str(e.device_type).endswith("CPU")]
    log(f"[profile] {name}: host ops "
        f"{sum(e.count for e in host) // steps} per {unit}; by self CPU "
        f"time:")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"[profile] {name}:   {e.self_cpu_time_total / steps / 1e3:8.3f}"
            f" ms/{unit} x{e.count // steps:<5d} {e.key[:60]}")


def engine_prompts(cfg):
    """8 prompts of 512-1536 tokens from a fixed seed."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(512, 1537, size=8)
    return lens, [rng.integers(0, cfg.vocab_size, size=int(n)).astype(
        np.int32) for n in lens]


def phase_engine(cfg, params, layouts=(False, True)):
    """The engine on each layout in ``layouts`` (paged or not); with both,
    their streams must be token-identical. Returns {layout: tokens}."""
    lens, prompts = engine_prompts(cfg)
    out = {}
    for paged in layouts:
        toks, ttft, tps = run_engine(cfg, params, prompts, paged=paged,
                                     steps=64, chunk=16)
        name = "paged" if paged else "dense"
        out[name] = toks
        log(f"[engine] {cfg.name} {name}: prompts {lens.tolist()} ttft_ms "
            f"{[round(t, 2) for t in ttft]} decode {tps:.1f} tok/s "
            f"(8 slots x 64 steps, chunks of 16)")
        for sid, a in toks.items():
            if len(a) != 64 or not all(0 <= t < cfg.vocab_size for t in a):
                fail(f"{sid}: {len(a)} tokens, expected 64 in range")
    if len(out) == 2:
        check_same_streams(cfg, out["dense"], out["paged"], "dense and paged "
                           "engines")
    return out


def check_same_streams(cfg, a_toks, b_toks, what: str) -> None:
    for sid in a_toks:
        a, b = a_toks[sid], b_toks[sid]
        if a != b:
            i = next(j for j in range(len(a)) if a[j] != b[j])
            fail(f"{cfg.name}: {what} diverge for {sid} at step {i}: "
                 f"{a[i]} vs {b[i]}")
    log(f"[engine] {cfg.name}: {what} give identical token streams "
        f"({len(a_toks)} x {len(next(iter(a_toks.values())))} tokens)")


def drive_model(cfg, params, layouts=(False, True)):
    """One model's main path: serve() through the gateway, then the
    engines (dense and paged by default). Returns the engines' streams."""
    phase_serve(cfg.name, params)
    release_memory()                # the serve() fleet's caches
    return phase_engine(cfg, params, layouts)


class PrefillCount:
    """Counts ``LM.prefill`` calls inside a ``with`` block, and
    ``LM.decode_step`` calls by cache layout ("dense" or "paged") in
    ``steps`` (an instrumentation of this script, to relate a path's
    launches to its prefills and decode steps)."""

    def __enter__(self):
        from collections import Counter
        from repro_torch.models.transformer import LM
        self.n, self.by_model, self.steps = 0, Counter(), Counter()
        self._orig = LM.prefill, LM.decode_step

        def counted(lm, *args, **kw):
            self.n += 1
            self.by_model[lm.cfg.name] += 1
            return self._orig[0](lm, *args, **kw)

        def stepped(lm, params, cache, *args, **kw):
            self.steps["paged" if "block" in cache else "dense"] += 1
            return self._orig[1](lm, params, cache, *args, **kw)

        LM.prefill, LM.decode_step = counted, stepped
        return self

    def __exit__(self, *exc):
        from repro_torch.models.transformer import LM
        LM.prefill, LM.decode_step = self._orig


def check_paged_keeps_dense(cfg, params, dense_toks, prompts=None,
                            max_len: int = 2048) -> None:
    """``paged=True`` on a family that does not page keeps the dense slot
    layout (``eng.paged`` is False) and gives the dense engine's tokens
    (on ``prompts``, by default ``engine_prompts``)."""
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, params=params, slots=1, max_len=64,
                          paged=True, device="cuda")
    if eng.paged:
        fail(f"{cfg.name}: paged=True built a paged engine")
    del eng
    if prompts is None:
        _, prompts = engine_prompts(cfg)
    steps = len(next(iter(dense_toks.values())))
    toks, _, _ = run_engine(cfg, params, prompts, paged=True, steps=steps,
                            chunk=16, max_len=max_len)
    check_same_streams(cfg, dense_toks, toks, "dense and paged=True (dense "
                       "layout) engines")


def check_state_transfer(cfg, params, max_len: int = 2048,
                         lens=(700, 300, 1100), slots: int = 8) -> None:
    """A session exported mid-stream (its payload exactly
    ``kvcache.cache_bytes`` of one slot) and imported into a fresh engine
    keeps its fingerprint and continues token-identically. The exported
    session is the first of ``lens``; both engines have ``slots`` slots
    (at least ``len(lens)``)."""
    import numpy as np
    from repro_torch.models import kvcache as KV
    from repro_torch.serving import state_transfer
    from repro_torch.serving.engine import InferenceEngine
    rng = np.random.default_rng(21)
    src = InferenceEngine(cfg, params=params, slots=slots, max_len=max_len,
                          device="cuda")
    for i, n in enumerate(lens):
        src.prefill_session(f"m{i}", rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32))
    src.decode_round(steps=8)
    payload = src.export_slot("m0")
    nbytes = state_transfer.payload_bytes(payload)
    want = KV.cache_bytes(cfg, 1, max_len)
    if nbytes != want:
        fail(f"{cfg.name}: payload of {nbytes} bytes, cache_bytes says "
             f"{want}")
    dst = InferenceEngine(cfg, params=params, slots=slots, max_len=max_len,
                          device="cuda")
    dst.import_slot("m0", payload)
    fp = state_transfer.fingerprint(payload)
    if state_transfer.fingerprint(dst.export_slot("m0")) != fp:
        fail(f"{cfg.name}: imported state does not fingerprint as exported")
    a = src.decode_round(steps=16)["m0"]
    b = dst.decode_round(steps=16)["m0"]
    if a != b:
        fail(f"{cfg.name}: the imported session diverges from its source: "
             f"{a} vs {b}")
    log(f"[state] {cfg.name}: mid-stream export ({nbytes / 1e6:.2f} MB = "
        f"cache_bytes of one slot, fingerprint {fp}) -> import into a fresh "
        f"engine continues token-identically (16 tokens)")


def drive_recurrent(cfg, params, kernel: str, per_prefill: int,
                    counters) -> int:
    """The main path of a recurrent family: serve() and the dense engine,
    inside the launch window; ``kernel`` must be launched ``per_prefill``
    times per prefill of the path and the decode-attention kernels and
    flash_attention not at all (the hybrid's ring decode is plain, as in
    the reference, and its windowed prefill is banded). The checks run
    after the counters are read. Returns the path's launches."""
    with PrefillCount() as pc:
        launches, out = drive_path(cfg.name, counters, (kernel,), drive_model,
                                   cfg, params, (False,))
    if launches[kernel] != per_prefill * pc.n:
        fail(f"{cfg.name}: {kernel} launched {launches[kernel]} times in "
             f"{pc.n} prefills, expected {per_prefill} per prefill")
    if launches["decode_attention"] or launches["paged_decode_attention"]:
        fail(f"{cfg.name}: the decode-attention kernels ran on a path with "
             f"no linear KV cache")
    log(f"[main path] {cfg.name}: {kernel} launched {launches[kernel]} = "
        f"{per_prefill} x {pc.n} prefills")
    check_flash(cfg.name, launches, 0, pc.n)
    check_paged_keeps_dense(cfg, params, out["dense"])
    check_state_transfer(cfg, params)
    check_logits(cfg, params)
    return launches


class EncodeTimer:
    """Times each ``LM._encode`` call on the device (CUDA events around
    it) inside a ``with`` block: an instrumentation of this script, to
    split an encdec TTFT into encoder and decoder."""

    def __enter__(self):
        import torch
        from repro_torch.models.transformer import LM
        self.events, self._orig = [], LM._encode

        def timed(lm, *args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._orig(lm, *args, **kw)
            end.record()
            self.events.append((start, end))
            return out

        LM._encode = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.models.transformer import LM
        LM._encode = self._orig

    def ms(self):
        return [start.elapsed_time(end) for start, end in self.events]


def drive_encdec(cfg, params, max_len: int = 2048) -> dict:
    """The encdec main path through the model's entry points (the engine
    serves no encdec model, in either package): 8 prompts of 64-1024
    tokens, each with 1536 frames from the audio frontend stub,
    right-padded to the engine's buckets and prefilled one at a time with
    ``LM.prefill``; their caches laid into one batch-8 cache; then
    ``ENCDEC_STEPS`` greedy ``LM.decode_step``s on it. Returns what the
    checks read: the first prefill's and the last step's logits, the
    cache, a copy of its cross K/V taken before decode, the tokens."""
    import numpy as np
    import torch
    from repro_torch.models import kvcache as KV
    from repro_torch.models.frontends import fake_audio_frames
    from repro_torch.models.transformer import LM
    from repro_torch.serving.engine import prefill_buckets

    lm = LM(cfg)
    rng = np.random.default_rng(13)
    lens = rng.integers(64, 1025, size=8)
    buckets = prefill_buckets(max_len)
    gen = torch.Generator(device="cuda").manual_seed(17)
    cache = KV.init_cache(cfg, len(lens), max_len, device="cuda")
    first, ttft, widths, out = [], [], [], {}
    with torch.no_grad(), EncodeTimer() as enc:
        for i, n in enumerate(lens):
            n = int(n)
            width = next(b for b in buckets if n <= b)
            tokens = np.zeros((1, width), np.int32)
            tokens[0, :n] = rng.integers(0, cfg.vocab_size, size=n)
            frames = fake_audio_frames(cfg, gen, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, one = lm.prefill(params, {
                "tokens": torch.from_numpy(tokens).cuda(), "length": n,
                "frames": frames}, max_len)
            first.append(logits.argmax(-1).to(torch.int32))
            torch.cuda.synchronize()
            ttft.append((time.perf_counter() - t0) * 1e3)
            widths.append(width)
            out.setdefault("prefill_logits", logits)
            for key in ("k", "v"):
                cache["layers"][key][:, i] = one["layers"][key][:, 0]
            for key in ("cross_k", "cross_v"):
                cache[key][:, i] = one[key][:, 0]
            cache["pos"][i] = n
            del one
        torch.cuda.synchronize()
        enc_ms = enc.ms()
        out["cross_before"] = {k: cache[k].clone()
                               for k in ("cross_k", "cross_v")}
        tok = torch.stack(first)                      # [8, 1]
        toks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ENCDEC_STEPS):
            logits, cache = lm.decode_step(params, cache, tok)
            tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    out.update(cache=cache, decode_logits=logits,
               tokens=torch.cat(toks, dim=1).cpu())
    log(f"[encdec] {cfg.name}: prompts {lens.tolist()} buckets {widths} "
        f"({cfg.source_len} frames each)")
    log(f"[encdec] {cfg.name}: ttft_ms {[round(t, 2) for t in ttft]}")
    log(f"[encdec] {cfg.name}: encoder_ms (device) "
        f"{[round(t, 2) for t in enc_ms]}; decoder_ms (ttft - encoder) "
        f"{[round(t - e, 2) for t, e in zip(ttft, enc_ms)]}")
    log(f"[encdec] {cfg.name}: decode {dt / ENCDEC_STEPS * 1e3:.2f} ms/step, "
        f"{len(lens) * ENCDEC_STEPS / dt:.1f} tok/s (8 rows x {ENCDEC_STEPS} "
        f"greedy steps)")
    return out


def check_encdec(cfg, out) -> None:
    """The encdec path's results: finite logits of the expected shapes,
    tokens in range, cross K/V bit-unchanged by decode."""
    import torch
    V = cfg.padded_vocab
    for name, shape in (("prefill_logits", (1, V)),
                        ("decode_logits", (8, 1, V))):
        lg = out[name]
        if tuple(lg.shape) != shape \
                or not torch.isfinite(lg[..., :cfg.vocab_size]).all():
            fail(f"{cfg.name}: {name} {tuple(lg.shape)} not finite of shape "
                 f"{shape}")
    toks = out["tokens"]
    if tuple(toks.shape) != (8, ENCDEC_STEPS) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        fail(f"{cfg.name}: decode tokens {tuple(toks.shape)} out of range")
    for key, before in out["cross_before"].items():
        if not torch.equal(out["cache"][key], before):
            fail(f"{cfg.name}: decode changed {key}")
    log(f"[encdec] {cfg.name}: prefill and decode logits finite; cross_k/"
        f"cross_v bit-unchanged by {ENCDEC_STEPS} decode steps")


def check_flash(name: str, launches, per_prefill: int, prefills: int):
    """flash_attention launched exactly once per full-attention layer of
    each prefill of the path."""
    got = launches["flash_attention"]
    if got != per_prefill * prefills:
        fail(f"{name}: flash_attention launched {got} times in {prefills} "
             f"prefills, expected {per_prefill} per prefill")
    log(f"[main path] {name}: flash_attention launched {got} = "
        f"{per_prefill} x {prefills} prefills")


def check_variant(name: str, launches, variant: str) -> None:
    """Every grouped-GEMM launch of the path just driven took ``variant``
    and none took another: "tensor" (the bf16 expert FFN), "narrow" (the
    adapter route's f32 rank-sized products, moe_gemm only) or "int8" (the
    expert FFN on int8 weights)."""
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    for counts, which in ((MG.TENSOR_CORE_LAUNCHES, "tensor"),
                          (MG.NARROW_LAUNCHES, "narrow"),
                          (MG.INT8_LAUNCHES, "int8")):
        for k, n in counts.items():
            if n != (launches[k] if which == variant else 0):
                fail(f"{name}: {n} of {launches[k]} {k} launches took the "
                     f"{which} variant, expected "
                     f"{'all' if which == variant else 'none'}")
    log(f"[main path] {name}: grouped GEMMs on the {variant} variant "
        f"(tensor {dict(MG.TENSOR_CORE_LAUNCHES)}, narrow "
        f"{dict(MG.NARROW_LAUNCHES)}, int8 {dict(MG.INT8_LAUNCHES)})")


def init_model(cfg):
    """Seeded random weights drawn on the card (for MoE, one [E, d, f]
    tensor at a time)."""
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.models.transformer import LM
    t0 = time.perf_counter()
    params = LM(cfg).init(0, "cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    log(f"[init] {cfg.name} {n / 1e9:.2f} B params ({nbytes / 1e9:.1f} GB) "
        f"in {time.perf_counter() - t0:.1f} s; device memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    return params


def release_memory() -> None:
    """Return the device memory of tensors no longer referenced, and
    cuBLAS's workspaces (32 MiB for each stream that ran a GEMM: left
    live, each pins the cached segment it was carved from, and a
    qwen2-vl-72b stack of 18 GiB then finds no room)."""
    import torch
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


ADAPTER_IDS = ("acme", "globex", "initech")
ADAPTER_GEN = 24


def adapter_setup(cfg):
    """Three adapters from the adapter catalog and 8 sessions (2 base, 2
    for each adapter): (catalog, [(session, adapter id, prompt)])."""
    import numpy as np
    from repro_torch.adapters import AdapterCatalog, AdapterSpec
    catalog = AdapterCatalog()
    for i, aid in enumerate(ADAPTER_IDS):
        # scale 10: a delta the size of the hidden state, so adapter
        # sessions visibly leave the base model's stream
        catalog.register(AdapterSpec(
            adapter_id=aid, version="1.0", base_model_id="minitron-8b",
            base_model_version="1.0", rank=8, scale=10.0, seed=i),
            d_model=cfg.d_model)
    rng = np.random.default_rng(11)
    bound = ("", "") + tuple(a for a in ADAPTER_IDS for _ in range(2))
    sessions = [(f"a{i}", bound[i], rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(64, 257))).astype(np.int32))
        for i in range(8)]
    return catalog, sessions


def adapter_engine(cfg, params, catalog, with_adapters: bool):
    from repro_torch.adapters import AdapterRuntime
    from repro_torch.serving.engine import InferenceEngine
    rt = None
    if with_adapters:
        rt = AdapterRuntime(cfg.d_model, max_adapters=8, rank=8,
                            device="cuda")
    eng = InferenceEngine(cfg, params=params, slots=8, max_len=512,
                          adapters=rt, device="cuda")
    for aid in ADAPTER_IDS if with_adapters else ():
        eng.load_adapter(aid, *catalog.weights(aid))
    return eng


def phase_adapters(cfg, params, catalog, sessions) -> dict:
    """The adapter main path at minitron-8b width: the 8 sessions through
    one ServingPlane over a RealEngineBackend on an engine with an
    AdapterRuntime (route grouped, the moe_gemm kernel). Returns each
    session's tokens."""
    from repro_torch.core.clock import Clock
    from repro_torch.serving.plane import RealEngineBackend, ServingPlane
    mux = adapter_engine(cfg, params, catalog, True)
    if mux.adapters.route != "grouped":
        fail(f"adapter route on the card is {mux.adapters.route!r}")
    clock = Clock()
    plane = ServingPlane(clock, RealEngineBackend(mux, clock), slots=8,
                         premium_reserved_frac=0.0, site_id="adapters")
    t0 = time.perf_counter()
    for sid, aid, prompt in sessions:
        plane.submit(session_id=sid, klass="assured",
                     prompt_tokens=len(prompt), gen_tokens=ADAPTER_GEN,
                     t_max_ms=1e9, prompt=prompt, adapter_id=aid)
    plane.drain()
    mixed = {r.session_id: r.token_ids for r in plane.pop_results()}
    log(f"[adapters] minitron-8b: 8 sessions (2 base, 2 x "
        f"{list(ADAPTER_IDS)}) through the plane in "
        f"{time.perf_counter() - t0:.2f} s")
    if sorted(mixed) != sorted(sid for sid, _, _ in sessions) \
            or any(len(t or []) != ADAPTER_GEN for t in mixed.values()):
        fail(f"adapter plane served "
             f"{ {k: len(v or []) for k, v in mixed.items()} }")
    return mixed


#: the mixtral-8x7b path: prompt lengths (two past the window of 4096; 4090
#: wraps the ring while it decodes), greedy tokens a session, context
MIXTRAL_LENS = (1000, 4090, 6000, 2500, 5200, 1800, 3300, 1400)
MIXTRAL_GEN = 64
MIXTRAL_MAX_LEN = 8192
MIXTRAL_LAYERS = 16             # the main path: 16 of its 32 layers (its
#                                 host-bound decode scales with depth; the
#                                 script's time limit; all 32 fit one card:
#                                 56.7 GB peak, PERF.md §5)


def mixtral_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(8)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in MIXTRAL_LENS]


def serve_plane(cfg, params, prompts, *, slots: int, max_len: int,
                gen: int, tag: str) -> dict:
    """``prompts`` as sessions s0, s1, ... through a ServingPlane over a
    RealEngineBackend on an InferenceEngine of ``slots`` slots at
    ``max_len``, ``gen`` greedy tokens each; the engine is freed before
    this returns. Returns each session's tokens (the prefill's first)."""
    from repro_torch.core.clock import Clock
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.plane import RealEngineBackend, ServingPlane
    eng = InferenceEngine(cfg, params=params, slots=slots, max_len=max_len,
                          device="cuda")
    clock = Clock()
    plane = ServingPlane(clock, RealEngineBackend(eng, clock), slots=slots,
                         premium_reserved_frac=0.0, site_id=tag)
    t0 = time.perf_counter()
    for i, prompt in enumerate(prompts):
        plane.submit(session_id=f"s{i}", klass="assured",
                     prompt_tokens=len(prompt), gen_tokens=gen,
                     t_max_ms=1e9, prompt=prompt)
    plane.drain()
    served = {r.session_id: r.token_ids for r in plane.pop_results()}
    log(f"[{tag}] {cfg.name} int8: {len(prompts)} sessions (prompts "
        f"{[len(p) for p in prompts]}) x {gen} tokens through the plane on "
        f"{slots} slots in {time.perf_counter() - t0:.2f} s")
    if sorted(served) != sorted(f"s{i}" for i in range(len(prompts))) \
            or any(len(t or []) != gen or not all(
                0 <= x < cfg.vocab_size for x in t)
                for t in served.values()):
        fail(f"{tag} plane served "
             f"{ {k: len(v or []) for k, v in served.items()} }")
    del plane, eng
    release_memory()
    return served


def drive_mixtral(cfg, params) -> dict:
    """The mixtral-8x7b main path on int8 weights: 8 sessions through a
    ServingPlane over a RealEngineBackend on an InferenceEngine of 8 slots
    at max_len 8192 (a ring of 4096 slots a layer), 64 greedy tokens each;
    then the same prompts on an engine of the same shape, driven directly:
    TTFT of each prompt, decode tok/s over 64 steps and a profiled decode
    round. Returns {"plane": tokens, "engine": tokens}."""
    prompts = mixtral_prompts(cfg)
    served = serve_plane(cfg, params, prompts, slots=8,
                         max_len=MIXTRAL_MAX_LEN, gen=MIXTRAL_GEN,
                         tag="mixtral")
    toks, ttft, tps = run_engine(cfg, params, prompts, paged=False,
                                 steps=MIXTRAL_GEN, chunk=16,
                                 max_len=MIXTRAL_MAX_LEN)
    log(f"[engine] {cfg.name} int8 dense: prompts {list(MIXTRAL_LENS)} "
        f"ttft_ms {[round(t, 2) for t in ttft]} decode {tps:.1f} tok/s "
        f"(8 slots x {MIXTRAL_GEN} steps, chunks of 16)")
    return {"plane": served, "engine": toks}


def check_mixtral(cfg, params, out) -> None:
    """After the mixtral path's launch window: the plane's streams are the
    direct engine's (one token later); paged=True keeps the dense layout and its tokens; a
    session whose ring has wrapped moves mid-stream into a fresh engine
    and continues; full-width prefill logits are finite."""
    # a plane result starts with the prefill's token, the engine's decode
    # tokens after it
    check_same_streams(cfg, {k: v[:-1] for k, v in out["engine"].items()},
                       {k: v[1:] for k, v in out["plane"].items()},
                       "plane and direct engines")
    check_paged_keeps_dense(cfg, params, out["engine"],
                            mixtral_prompts(cfg), MIXTRAL_MAX_LEN)
    check_state_transfer(cfg, params, MIXTRAL_MAX_LEN, (5000, 300, 4090))
    check_logits(cfg, params)


#: the qwen2-vl-72b path: prompt lengths, greedy tokens a session,
#: context; the vision prompt's tokens and its greedy decode steps
QWEN2VL_LENS = (500, 1900, 1210, 760, 1530, 980, 1750, 640)
QWEN2VL_GEN = 16                # greedy tokens a session (the script's
#                                 time limit: a decode step is
#                                 device-bound, ~0.65 s at 80 layers)
QWEN2VL_MAX_LEN = 2048
QWEN2VL_VISION_TOKENS = 1024
QWEN2VL_VISION_STEPS = 16
QWEN2VL_HEADROOM = 1.5e9        # bytes the predicted peak must leave free


def qwen2vl_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(9)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in QWEN2VL_LENS]


def vision_positions(b: int, s: int, nv: int, width: int,
                     repeat_t: bool = False):
    """[3, b, s] int32 M-RoPE positions of a prompt whose first nv tokens
    are an image's patches in rows of ``width``: stream 0 is ``arange(s)``
    (with ``repeat_t``, every image token at 0 as Qwen2-VL places one
    image, the text after it from 1); streams 1 and 2 are the patch's row
    and column over the image, then ``arange``. Row r adds r to streams
    1-2, so rows differ."""
    import numpy as np
    i = np.arange(s)
    img = i < nv
    t = np.where(img, 0, i - nv + 1) if repeat_t else i
    out = np.stack([t, np.where(img, i // width, i),
                    np.where(img, i % width, i)])[:, None].repeat(b, 1)
    out[1:] += np.arange(b)[None, :, None]
    return out.astype(np.int32)


def qwen2vl_slots(cfg, weights: int):
    """The engines' slots: 8 at ``QWEN2VL_MAX_LEN`` if the predicted peak
    leaves ``QWEN2VL_HEADROOM`` under the card's ``total_memory``, else 4.
    Predicted peak: the weights on the card, the engine's K/V, and a
    prefill's transients (its batch-1 cache, ``as_weight``'s two f32 copies
    and bf16 cast of the largest matrix, the MLP's f32 and bf16
    activations of a full bucket). Returns (slots, predicted peak, total)."""
    import torch
    from repro_torch.models import kvcache as KV
    total = torch.cuda.get_device_properties(0).total_memory
    n = QWEN2VL_MAX_LEN
    transient = (KV.cache_bytes(cfg, 1, n) + 10 * cfg.d_model * cfg.d_ff
                 + 16 * n * cfg.d_ff)
    for slots in (8, 4):
        peak = weights + KV.cache_bytes(cfg, slots, n) + transient
        log(f"[qwen2-vl] predicted peak at {slots} slots x max_len {n}: "
            f"{peak / 1e9:.2f} GB (weights {weights / 1e9:.2f}, K/V "
            f"{KV.cache_bytes(cfg, slots, n) / 1e9:.2f}, prefill transients "
            f"{transient / 1e9:.2f}) of total_memory {total / 1e9:.2f} GB")
        if peak + QWEN2VL_HEADROOM <= total:
            break
    return slots, peak, total


def time_qwen2vl_decode(rows, cfg, slots: int) -> None:
    """Both decode kernels at the batches the qwen2-vl path decodes, by
    ``time_decode``: ``slots`` rows at the first group's prompt lengths
    half way through their tokens in a cache of ``QWEN2VL_MAX_LEN``, and
    the vision prompt's one row half way through its steps."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4321)
    heads = (cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
             cfg.head_dim)
    n = QWEN2VL_VISION_TOKENS + QWEN2VL_VISION_STEPS
    for lens, S in (([m + QWEN2VL_GEN // 2 for m in QWEN2VL_LENS[:slots]],
                     QWEN2VL_MAX_LEN),
                    ([n - QWEN2VL_VISION_STEPS // 2], n)):
        time_decode(rows, gen, cfg.name, *heads, lens, S)


def drive_qwen2vl(cfg, params, slots: int) -> dict:
    """The qwen2-vl-72b main path on int8 weights: 8 text sessions through
    a ServingPlane over a RealEngineBackend on an InferenceEngine of
    ``slots`` slots at max_len 2048, ``QWEN2VL_GEN`` greedy tokens each;
    then the same prompts on direct engines of the same shape, dense
    (TTFT of each prompt, decode tok/s, a profiled round) and paged,
    ``slots`` prompts at a time; then a vision prompt through the model's
    entry points (the engine builds text batches only, in both packages):
    ``LM.prefill`` of ``QWEN2VL_VISION_TOKENS`` tokens with
    ``vision_embeds`` [1, 256, d_model] from the frontend stub over the
    first 256 and explicit [3, 1, s] positions (the image's 16 x 16 grid
    in streams 1-2), then ``QWEN2VL_VISION_STEPS`` greedy
    ``LM.decode_step``s. Returns what the checks read."""
    import numpy as np
    import torch
    from repro_torch.models.frontends import fake_vision_embeds
    from repro_torch.models.transformer import LM
    prompts = qwen2vl_prompts(cfg)
    out = {"plane": serve_plane(cfg, params, prompts, slots=slots,
                                max_len=QWEN2VL_MAX_LEN, gen=QWEN2VL_GEN,
                                tag="qwen2-vl")}
    for paged in (False, True):
        name = "paged" if paged else "dense"
        toks, ttfts, rates = {}, [], []
        for g in range(0, len(prompts), slots):
            t, ttft, tps = run_engine(
                cfg, params, prompts[g:g + slots], paged=paged,
                steps=QWEN2VL_GEN, chunk=16, max_len=QWEN2VL_MAX_LEN,
                profile=g == 0 and not paged)
            toks.update({f"s{g + int(k[1:])}": v for k, v in t.items()})
            ttfts += ttft
            rates.append(round(tps, 2))
            release_memory()
        out[name] = toks
        log(f"[engine] {cfg.name} int8 {name}: prompts "
            f"{list(QWEN2VL_LENS)} ttft_ms {[round(t, 2) for t in ttfts]} "
            f"decode {rates} tok/s ({slots} slots x {QWEN2VL_GEN} steps a "
            f"group of {slots} prompts, chunks of 16)")

    n, steps = QWEN2VL_VISION_TOKENS, QWEN2VL_VISION_STEPS
    lm = LM(cfg)
    gen = torch.Generator(device="cuda").manual_seed(29)
    embeds = fake_vision_embeds(cfg, gen, 1)
    nv = embeds.shape[1]
    side = int(round(nv ** 0.5))
    tokens = torch.from_numpy(np.random.default_rng(30).integers(
        0, cfg.vocab_size, size=(1, n)).astype(np.int32)).cuda()
    positions = torch.from_numpy(vision_positions(1, n, nv, side)).cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, {
            "tokens": tokens, "vision_embeds": embeds,
            "positions": positions}, n + steps)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        ttft = (time.perf_counter() - t0) * 1e3
        seen, step_logits = [tok], []
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, cache = lm.decode_step(params, cache, tok)
            tok = lg[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            seen.append(tok)
            step_logits.append(lg[:, 0])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    log(f"[qwen2-vl] vision prompt: {n} tokens, the first {nv} an image of "
        f"{side} x {side} patches (vision_embeds {tuple(embeds.shape)}, "
        f"positions {tuple(positions.shape)}): ttft {ttft:.2f} ms, then "
        f"{steps} greedy decode steps at {dt / steps * 1e3:.2f} ms/step")
    out["vision"] = {"tokens": tokens, "prefill_logits": logits,
                     "step_logits": torch.stack(step_logits),
                     "cache": cache, "seen": torch.cat(seen, 1).cpu()}
    return out


def check_qwen2vl_launches(cfg, launches, pc) -> None:
    """flash_attention once a layer a prefill, the decode kernels once a
    layer a step of their layout, and no grouped GEMM, scan or SSD
    kernel."""
    L = cfg.num_layers
    want = {"flash_attention": L * pc.n,
            "decode_attention": L * pc.steps["dense"],
            "paged_decode_attention": L * pc.steps["paged"]}
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail(f"{cfg.name}: {k} launched {n} times, expected "
                 f"{want.get(k, 0)} ({pc.n} prefills, "
                 f"{dict(pc.steps)} decode steps, {L} layers)")
    log(f"[main path] {cfg.name} int8: flash_attention "
        f"{want['flash_attention']} = {L} x {pc.n} prefills; "
        f"decode_attention {want['decode_attention']} = {L} x "
        f"{pc.steps['dense']} dense steps; paged_decode_attention "
        f"{want['paged_decode_attention']} = {L} x {pc.steps['paged']} "
        f"paged steps; no grouped GEMM, scan or SSD kernel")


def check_qwen2vl(cfg, params, out) -> None:
    """After the qwen2-vl path's launch window: the plane's streams are
    the direct engine's (one token later), the paged engine's the dense
    one's; a session moves mid-stream into a fresh engine and continues;
    full-width prefill logits are finite; the vision prompt's logits are
    finite and its cache is not a text-only prefill's of the same
    tokens."""
    import torch
    from repro_torch.models.transformer import LM
    check_same_streams(cfg, {k: v[:-1] for k, v in out["dense"].items()},
                       {k: v[1:] for k, v in out["plane"].items()},
                       "plane and direct engines")
    check_same_streams(cfg, out["dense"], out["paged"], "dense and paged "
                       "engines")
    check_state_transfer(cfg, params, QWEN2VL_MAX_LEN, (1500, 300),
                         slots=2)
    check_logits(cfg, params)
    vis = out["vision"]
    V = cfg.vocab_size
    for name, lg in (("prefill", vis["prefill_logits"]),
                     ("decode", vis["step_logits"])):
        if not torch.isfinite(lg[..., :V]).all():
            fail(f"{cfg.name}: vision {name} logits not finite")
    seen = vis["seen"]
    if int(seen.min()) < 0 or int(seen.max()) >= V:
        fail(f"{cfg.name}: vision decode tokens out of range")
    n = vis["tokens"].shape[1]
    with torch.no_grad():
        _, text = LM(cfg).prefill(params, {"tokens": vis["tokens"]}, n)
    diff = {key: float((vis["cache"]["layers"][key][:, :, :n].float()
                        - text["layers"][key].float()).abs().max())
            for key in ("k", "v")}
    if min(diff.values()) == 0.0:
        fail(f"{cfg.name}: the vision prompt's cache equals a text-only "
             f"prefill's ({diff})")
    log(f"[qwen2-vl] vision prompt: prefill and {seen.shape[1] - 1} decode "
        f"logits finite, tokens {seen[0, :8].tolist()}...; its cache "
        f"differs from a text-only prefill of the same tokens (max |diff| "
        f"k {diff['k']:.3e}, v {diff['v']:.3e})")


def check_adapters(cfg, params, catalog, sessions, mixed) -> None:
    """Each session served alone on an engine of the same shape (8 slots,
    so every product has the mixed run's shape) with the same adapters
    loaded, and each base session on an engine with no adapter runtime:
    both must give the mixed batch's tokens."""
    gen = ADAPTER_GEN
    solo = adapter_engine(cfg, params, catalog, True)
    bare = adapter_engine(cfg, params, catalog, False)
    changed = 0
    for sid, aid, prompt in sessions:
        alone = solo.serve(sid, len(prompt), gen, prompt=prompt,
                           adapter_id=aid)["tokens"]
        if alone != mixed[sid]:
            i = next(j for j in range(gen) if alone[j] != mixed[sid][j])
            fail(f"adapter session {sid} ({aid or 'base'}): mixed batch and "
                 f"alone diverge at token {i}")
        base = bare.serve(sid, len(prompt), gen, prompt=prompt)["tokens"]
        if not aid and base != mixed[sid]:
            fail(f"base session {sid} differs from the adapter-free engine")
        changed += bool(aid) and base != mixed[sid]
    if changed == 0:
        fail("no adapter session left the base model's stream: the adapter "
             "delta was not applied")
    log(f"[adapters] mixed batch == each session alone (8 x {gen} tokens); "
        f"base sessions == adapter-free engine; {changed}/6 adapter "
        f"sessions differ from the base model on the same prompt")


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
    log(f"[reference] {cfg.name} prefill logits finite, shape "
        f"{tuple(logits.shape)}")


# ---------------------------------------------------------------------------
# phase 5: small model on the card vs the CPU plain path
# ---------------------------------------------------------------------------

def card_vs_cpu(cfg, label: str, paged: bool,
                repeat_t: bool = False) -> float:
    """Prefill + 8 greedy decode steps of ``cfg`` (f32) on the CPU and on
    the card from the same weights and prompt (and, for encdec, frames;
    for the vision frontend, patch embeddings over the first tokens and
    distinct [3, b, s] M-RoPE streams, stream 0 tied over the image with
    ``repeat_t``); each side feeds back its own argmax. Fails on a token
    that differs; returns the largest logit difference."""
    import numpy as np
    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.models.transformer import LM

    lm = LM(cfg)
    cpu_params = lm.init(5, "cpu")
    gpu_params = tree_map(lambda t: t.cuda(), cpu_params)
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 40))
    frames = (rng.standard_normal((2, cfg.source_len, cfg.d_model))
              * 0.02).astype(np.float32)
    nv = cfg.num_frontend_tokens
    embeds = (rng.standard_normal((2, nv, cfg.d_model)) * 0.02).astype(
        np.float32)
    res, toks_seen = [], []
    with torch.no_grad():
        for params, dev in ((cpu_params, "cpu"), (gpu_params, "cuda")):
            batch = {"tokens": torch.from_numpy(prompt).to(dev)}
            if cfg.family == "encdec":
                batch["frames"] = torch.from_numpy(frames).to(dev)
            if cfg.frontend == "vision":
                batch["vision_embeds"] = torch.from_numpy(embeds).to(dev)
                batch["positions"] = torch.from_numpy(vision_positions(
                    2, prompt.shape[1], nv, 4, repeat_t)).to(dev)
            logits, cache = lm.prefill(params, batch, 64)
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
                cache = {"layers": layers, "block": ids, "pos": cache["pos"]}
            steps = [logits.cpu()]
            tok = logits.argmax(-1)
            seen = [tok.cpu()]
            for _ in range(8):
                lg, cache = lm.decode_step(params, cache, tok[:, None])
                steps.append(lg[:, 0].cpu())
                tok = lg[:, 0].argmax(-1)
                seen.append(tok.cpu())
            res.append(torch.stack(steps))
            toks_seen.append(torch.stack(seen))
    err = float((res[0] - res[1]).abs().max())
    log(f"[reference] {label} f32 {'paged' if paged else 'dense'}: card vs "
        f"CPU max |logit diff| {err:.3e} over prefill + 8 decode steps")
    if not torch.equal(toks_seen[0], toks_seen[1]):
        fail(f"{label}: card and CPU greedy tokens differ")
    return err


def adapters_card_vs_cpu(cfg) -> None:
    """edge-tiny (f32) with two adapters and a base session: the grouped
    route on the card (the moe_gemm kernel) against the gather route on
    the CPU, token for token."""
    import numpy as np
    from repro_torch.adapters import AdapterRuntime, AdapterSpec, \
        init_adapter_weights
    from repro_torch.bridge import tree_map
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    from repro_torch.models.transformer import LM
    from repro_torch.serving.engine import InferenceEngine

    cpu_params = LM(cfg).init(6, "cpu")
    streams = []
    launches0 = MG.LAUNCHES["moe_gemm"]
    narrow0 = MG.NARROW_LAUNCHES["moe_gemm"]
    for dev, params in (("cpu", cpu_params),
                        ("cuda", tree_map(lambda t: t.cuda(), cpu_params))):
        rt = AdapterRuntime(cfg.d_model, max_adapters=4, rank=4, device=dev)
        eng = InferenceEngine(cfg, params=params, slots=4, max_len=64,
                              adapters=rt, device=dev)
        for i, aid in enumerate(("acme", "globex")):
            eng.load_adapter(aid, *init_adapter_weights(AdapterSpec(
                aid, "1.0", cfg.name, "1.0", rank=4, scale=10.0, seed=i),
                cfg.d_model))
        rng = np.random.default_rng(12)
        for n, (sid, aid) in enumerate((("a", "acme"), ("b", "globex"),
                                        ("c", ""))):
            eng.prefill_session(sid, rng.integers(
                0, cfg.vocab_size, 17 + 5 * n).astype(np.int32),
                adapter_id=aid)
        out = {}
        for _ in range(2):
            for sid, block in eng.decode_round(steps=6).items():
                out.setdefault(sid, []).extend(block)
        streams.append((f"{dev}/{rt.route}", out))
    (ka, a), (kb, b) = streams
    if a != b:
        fail(f"edge-tiny adapters: {ka} and {kb} tokens differ: {a} vs {b}")
    if MG.NARROW_LAUNCHES["moe_gemm"] - narrow0 != \
            MG.LAUNCHES["moe_gemm"] - launches0 or \
            MG.LAUNCHES["moe_gemm"] == launches0:
        fail("edge-tiny adapters: the grouped route's products did not all "
             "take the narrow variant")
    log(f"[reference] edge-tiny f32 adapters (rank 4): {kb} (narrow "
        f"variant, {MG.LAUNCHES['moe_gemm'] - launches0} launches) == {ka}, "
        f"3 sessions x 12 tokens")


def phase_reference():
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_smoke_config

    # full f32 matmul products on the card (PyTorch's default, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = dataclasses.replace(get_config("edge-tiny"), dtype="float32")
    # the smoke config's head_dim 16 is below the decode kernel's smallest
    # (32): widen the heads, keep the MoE layer (4 experts, top-2)
    moe = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              dtype="float32", head_dim=32)
    encdec = dataclasses.replace(get_smoke_config("seamless-m4t-medium"),
                                 dtype="float32", head_dim=32)
    # int8 weights, window 16: the 40-token prompt wraps the ring
    mixtral = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                                  dtype="float32", serve_weight_dtype="int8")
    # head_dim 32 for the decode kernels, M-RoPE's sections widened with it
    vision = dataclasses.replace(get_smoke_config("qwen2-vl-72b"),
                                 dtype="float32", head_dim=32,
                                 mrope_sections=(8, 4, 4))
    worst = max(card_vs_cpu(tiny, "edge-tiny", False),
                card_vs_cpu(tiny, "edge-tiny", True),
                card_vs_cpu(moe, moe.name, False),
                recurrent_card_vs_cpu(),
                card_vs_cpu(encdec, encdec.name, False),
                card_vs_cpu(mixtral, f"{mixtral.name} int8", False),
                card_vs_cpu(vision, f"{vision.name} (vision, M-RoPE)",
                            False),
                card_vs_cpu(vision, f"{vision.name} (vision, M-RoPE, "
                            f"stream 0 tied over the image)", False,
                            repeat_t=True))
    if worst > REF_ATOL:
        fail(f"card and CPU logits differ by {worst:.3e} > {REF_ATOL}")
    adapters_card_vs_cpu(tiny)
    train_card_vs_cpu(dataclasses.replace(tiny, remat="full"))
    train_card_vs_cpu(dataclasses.replace(moe, remat="full"))
    train_card_vs_cpu(dataclasses.replace(encdec, remat="full"))
    for arch in ("recurrentgemma-2b", "mamba2-1.3b"):
        train_card_vs_cpu(dataclasses.replace(get_smoke_config(arch),
                                              dtype="float32", remat="full"))


def train_card_vs_cpu(cfg) -> None:
    """A small config in f32 with full remat (edge-tiny; qwen3-moe's,
    seamless-m4t-medium's (head_dim 32, 24 frames a row), recurrentgemma-
    2b's and mamba2-1.3b's smoke configs): a microbatch's loss and every
    gradient leaf on the card (the f32 routes of both flash kernels, for
    MoE of the expert kernels and K1-K3, for the recurrent families of
    rglru_scan or ssd_chunk and their backward kernels, each launched as
    ``train_kernels`` counts a microbatch) against the CPU (their plain
    versions), on the same weights; each leaf within REF_ATOL of its
    largest magnitude."""
    import torch
    from repro_torch.bridge import leaves, tree_map
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    from repro_torch.models.frontends import fake_audio_frames
    from repro_torch.models.transformer import LM
    from repro_torch.training.train_step import (accumulate_grads,
                                                 init_train_state)
    lm = LM(cfg)
    rng = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 96), generator=rng,
                         dtype=torch.int32)
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = fake_audio_frames(cfg, rng, 2)
    cpu = init_train_state(lm, 0, device="cpu").params
    mods = train_modules(cfg)
    want = {k: n // TRAIN_MICRO for k, n in train_kernels(cfg).items()}
    if cfg.family == "moe":             # this microbatch's groups
        g = cfg.num_layers * moe_groups(cfg, *toks.shape)
        want.update(moe_gemm=2 * g, moe_ffn_fused=2 * g,
                    moe_ffn_fused_bwd=g, moe_gemm_dx=2 * g,
                    moe_gemm_dw=2 * g)
    out = []
    for dev in ("cpu", "cuda"):
        params = tree_map(
            lambda p: p.detach().to(dev).requires_grad_(True), cpu)
        before = launch_counts(mods)
        tc0 = sum(MG.BWD_TENSOR_CORE_LAUNCHES.values())
        loss, _ = accumulate_grads(
            lm, params, {k: v.to(dev) for k, v in batch.items()},
            torch.float32)
        got = {k: n - before[k] for k, n in launch_counts(mods).items()}
        if dev == "cuda" and (got != want or
                              sum(MG.BWD_TENSOR_CORE_LAUNCHES.values())
                              != tc0):
            fail(f"train card vs CPU ({cfg.name}): launches {got}, "
                 f"expected {want}, every backward on the f32 route")
        out.append((loss.item(), [p.grad.cpu() for p in leaves(params)]))
    (lc, gc_), (lg, gg) = out
    rel = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
              for a, b in zip(gg, gc_))
    log(f"[reference] {cfg.name} f32 train microbatch (remat full), card vs "
        f"CPU: loss {lg:.6f} vs {lc:.6f}, worst gradient leaf {rel:.3e} of "
        f"its largest magnitude; kernels {want}")
    if abs(lg - lc) > REF_ATOL or rel > REF_ATOL:
        fail(f"train card vs CPU: loss {lg} vs {lc}, worst leaf {rel:.3e}")


def recurrent_card_vs_cpu() -> float:
    """The recurrentgemma-2b and mamba2-1.3b smoke configs in f32, card
    (rglru_scan W 64; ssd_chunk hp 16, n 16, Q 16, a ragged last chunk)
    against the CPU (the plain versions); the hybrid's 40-token prompt
    passes its window of 16."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return max(card_vs_cpu(dataclasses.replace(get_smoke_config(a),
                                               dtype="float32"), a, False)
               for a in ("recurrentgemma-2b", "mamba2-1.3b"))


# ---------------------------------------------------------------------------
# the split path: speculative decode over two anchors of one session

SPLIT_TOKENS = 16               # committed tokens of each arm (the
#                                 script's time limit)
SPLIT_GAMMA = 4                 # draft window
SPLIT_PROMPT = 1000             # prompt tokens


def split_session(draft_id: str, target_id: str):
    """A split session established through the port's control plane: an
    edge site hosting the draft model and two regional sites hosting the
    target (8 H100 cards each by the data sheet), a ``SplitManager``, and
    an ASP with ``split_policy="require"``. Returns (orchestrator,
    manager, session)."""
    import dataclasses
    from repro_torch.core import Orchestrator, default_asp
    from repro_torch.core.asp import QualityTier
    from repro_torch.core.catalog import Catalog, default_catalog
    from repro_torch.core.clock import VirtualClock
    from repro_torch.core.sites import ExecutionSite, SiteSpec
    from repro_torch.splitserve import SplitManager
    clock = VirtualClock()
    cat = Catalog()
    for model in (draft_id, target_id):
        cat.register(default_catalog().get(model))

    def site(sid, kind, rtt, slots, model):
        return ExecutionSite(SiteSpec(
            sid, kind, "eu", chips=8, hbm_bytes_total=8 * 80e9,
            peak_flops=8 * BF16_FLOPS, hbm_bw=8 * HBM_BYTES_PER_S,
            decode_slots=slots, rtt_ms={"zone-a": rtt},
            hosted_models=(f"{model}@1.0",), price_per_chip_s=2.0e-4),
            clock)

    orch = Orchestrator(clock=clock, catalog=cat, sites={
        "edge-a": site("edge-a", "edge", 2.0, 32, draft_id),
        "regional-1": site("regional-1", "regional", 12.0, 64, target_id),
        "regional-2": site("regional-2", "regional", 30.0, 64, target_id)})
    mgr = SplitManager(orch)
    asp = dataclasses.replace(default_asp(tier=QualityTier.STANDARD),
                              split_policy="require",
                              max_cost_per_1k_tokens=4.0)
    session = orch.establish(asp, invoker="chip-smoke", zone="zone-a")
    return orch, mgr, session


def phase_split(orch, mgr, session, draft_cfg, target_cfg, dparams,
                tparams) -> dict:
    """The split path's five arms on one card, each committing
    ``SPLIT_TOKENS`` tokens from one ``SPLIT_PROMPT``-token prompt, 8-slot
    engines of max_len 2048, γ ``SPLIT_GAMMA``: (1) target-only greedy on
    the verify anchor's engine, the oracle stream; (2) the real pair,
    engine-drafted; (3) oracle proposals, the target stream with ~30% of
    its tokens corrupted (the draft grades and accepts 0 < n < γ); (4) a
    twin draft, the target's params in a second engine; (5) the real pair
    with a mid-stream verify migration, in the control plane and into a
    fresh paged engine of the new verify site. The draft keeps the
    sessions of arms 2-3 for the state check. Returns what the checks and
    the launch counts read."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.splitserve import SpecDecoder

    def engine(cfg, params, site=None, paged=False):
        eng = InferenceEngine(cfg, params=params, slots=8, max_len=2048,
                              paged=paged, device="cuda")
        if site is not None:
            orch.sites[site].attach_engine(eng)
        return eng

    sid = session.session_id
    verify_site = mgr.states[sid].verify_binding.site_id
    draft = engine(draft_cfg, dparams, session.binding.site_id)
    verify = engine(target_cfg, tparams, verify_site)
    prompt = np.random.default_rng(41).integers(
        0, target_cfg.vocab_size, size=SPLIT_PROMPT).astype(np.int32)

    first = verify.prefill_session(f"{sid}/target", prompt)["first_token"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rest = verify.decode_round(steps=SPLIT_TOKENS - 1)[f"{sid}/target"]
    target_ms = (time.perf_counter() - t0) * 1e3 / (SPLIT_TOKENS - 1)
    verify.release_slot(f"{sid}/target")
    base = [first] + rest

    def start(name, d, v=verify):
        dec = SpecDecoder(d, v, gamma=SPLIT_GAMMA, session_id=f"{sid}/{name}")
        dec.start(prompt)
        return dec

    def steps(dec):
        return dec.stats.drafted + dec.stats.rounds     # Σ(γ_round + 1)

    rng = np.random.default_rng(3)
    proposals = [t if rng.random() >= 0.3 else (t + 1) % target_cfg.vocab_size
                 for t in base[1:]]
    arms = {}
    for name, props in (("pair", None), ("oracle", proposals)):
        arms[name] = start(name, draft)
        arms[name].decode(SPLIT_TOKENS - 1, proposals=props)
        verify.release_slot(arms[name].sid)  # the draft keeps its state
    arms["twin"] = start("twin", engine(target_cfg, tparams))
    arms["twin"].decode(SPLIT_TOKENS - 1)
    arms["twin"].close()
    arms["migrate"] = mig = start("migrate", draft)
    mig.decode(SPLIT_TOKENS // 2 - 1)
    dense_before = steps(mig)
    new_site = mgr.migrate_verify(session)
    mig.migrate_verify(engine(target_cfg, tparams, new_site, paged=True))
    mig.decode(max(SPLIT_TOKENS - len(mig.tokens), 1))
    mig.close()
    dense = (SPLIT_TOKENS - 1 + steps(arms["pair"]) + steps(arms["oracle"])
             + 2 * steps(arms["twin"]) + dense_before)
    for name, dec in arms.items():
        st = dec.stats
        log(f"[split] {name}: rounds {st.rounds} drafted {st.drafted} "
            f"accepted {st.accepted} committed {st.committed} acceptance "
            f"{st.acceptance:.4f} tokens/round {st.tokens_per_round:.4f}; "
            f"draft {st.draft_ms / st.rounds:.2f} ms/round, verify "
            f"{st.verify_ms / st.rounds:.2f} ms/round (host clock)")
    log(f"[split] target-only: {target_ms:.2f} ms/token (host clock, one "
        f"fused round of {SPLIT_TOKENS - 1} steps, 8 slots)")
    return {"base": base, "arms": arms, "prompt": prompt, "draft": draft,
            "sites": (session.binding.site_id, verify_site, new_site),
            "dense_steps": dense, "paged_steps": steps(mig) - dense_before}


def check_draft_state(cfg, params, prompt, dec) -> None:
    """The draft's state for ``dec``'s session, after rounds that were
    rolled back in place (RG-LRU states and ring buffers restored from
    per-step copies), fingerprints as the state of a plain engine, the
    session in the same slot, that consumed the same tokens one decode
    step at a time."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.state_transfer import fingerprint
    eng = InferenceEngine(cfg, params=params, slots=8, max_len=2048,
                          device="cuda")
    slot = dec.draft._slot_map[dec.sid]
    for i in range(slot):
        eng.prefill_session(f"pad{i}", prompt[:16])
    eng.prefill_session(dec.sid, prompt)
    for i in range(slot):
        eng.release_slot(f"pad{i}")
    for t in dec.tokens[:-1]:           # the newest is not consumed yet
        eng.override_last_token(dec.sid, t)
        eng.decode_round()
    want = fingerprint(eng.export_slot(dec.sid))
    got = fingerprint(dec.draft.export_slot(dec.sid))
    if got != want:
        fail(f"{cfg.name}: the draft's state for {dec.sid} after its "
             f"rounds fingerprints {got}, a plain decode of the same "
             f"{len(dec.tokens) - 1} tokens {want}")
    log(f"[split] draft state of {dec.sid.rsplit('/', 1)[-1]} == a plain "
        f"decode of the same {len(dec.tokens) - 1} tokens (fingerprint "
        f"{got})")


def check_split(orch, mgr, session, draft_cfg, target_cfg, dparams, launches,
                prefills, out) -> None:
    """Every arm's committed stream is bitwise the target-only stream; the
    oracle arm accepts strictly between 0 and 1, the twin arm everything
    (γ + 1 tokens a round); the launches match the prefills and decode
    steps of the path; the draft's states are exact; and releasing the
    session frees both anchors."""
    base, arms = out["base"], out["arms"]
    for name, dec in arms.items():
        got = dec.tokens[:SPLIT_TOKENS]
        if got != base:
            i = next(j for j in range(len(got)) if got[j] != base[j])
            fail(f"split arm {name} diverges from target-only greedy at "
                 f"token {i}: {got[i]} vs {base[i]}")
    log(f"[split] every arm's {SPLIT_TOKENS} committed tokens == the "
        f"target-only greedy stream ({target_cfg.dtype})")
    acc = arms["oracle"].stats.acceptance
    if not 0.0 < acc < 1.0:
        fail(f"oracle arm acceptance {acc}, expected strictly in (0, 1)")
    twin = arms["twin"].stats
    if twin.acceptance != 1.0 or twin.tokens_per_round != SPLIT_GAMMA + 1:
        fail(f"twin arm acceptance {twin.acceptance}, tokens/round "
             f"{twin.tokens_per_round}, expected 1.0 and {SPLIT_GAMMA + 1}")
    n_layers = target_cfg.num_layers
    want = {"flash_attention": n_layers * prefills[target_cfg.name],
            "rglru_scan": draft_cfg._pattern().count("rec")
            * prefills[draft_cfg.name],
            "decode_attention": n_layers * out["dense_steps"],
            "paged_decode_attention": n_layers * out["paged_steps"],
            "moe_gemm": 0, "moe_ffn_fused": 0, "ssd_chunk": 0}
    for k, n in want.items():
        if launches[k] != n:
            fail(f"split path: {k} launched {launches[k]} times, expected "
                 f"{n}")
    log(f"[main path] split: launches match {prefills[target_cfg.name]} "
        f"{target_cfg.name} and {prefills[draft_cfg.name]} "
        f"{draft_cfg.name} prefills, {out['dense_steps']} dense and "
        f"{out['paged_steps']} paged {target_cfg.name} decode steps")
    for name in ("pair", "oracle"):
        check_draft_state(draft_cfg, dparams, out["prompt"], arms[name])
        out["draft"].release_slot(arms[name].sid)
    orch.release(session)
    busy = {k: s.slots_in_use() for k, s in orch.sites.items()
            if s.slots_in_use()}
    if mgr.states or busy:
        fail(f"split session release left {busy} in use, states "
             f"{list(mgr.states)}")
    for site in out["sites"]:
        eng = orch.sites[site].engine
        if eng.free_slots() != eng.slots:
            fail(f"{site}'s engine still holds {eng._slot_map}")
    log(f"[split] session {session.session_id} released: every anchor's "
        f"slots free, in the control plane and the engines")



# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# training: minitron-8b at full width, 4 layers, on the card
# ---------------------------------------------------------------------------

def train_config(cfg, layers: int = TRAIN_LAYERS):
    """``cfg`` at full width and ``layers`` of its layers, full remat
    (minitron-8b's f32 train state at 32 layers, 16 B a parameter, is 158
    GB: full depth waits for the port's distribution)."""
    import dataclasses
    return dataclasses.replace(cfg, num_layers=layers, remat="full")


def moe_train_config(cfg):
    """qwen3-moe-30b-a3b's training config: MOE_TRAIN_LAYERS layers, or
    one fewer where their predicted peak (``train_bytes`` on the
    parameters' shapes) passes MOE_TRAIN_BYTES."""
    from repro_torch.models.transformer import LM
    tcfg = train_config(cfg, MOE_TRAIN_LAYERS)
    predicted = train_bytes(tcfg, LM(tcfg).param_specs())
    if predicted > MOE_TRAIN_BYTES:
        log(f"[train] {cfg.name}: {MOE_TRAIN_LAYERS} layers predict "
            f"{predicted / 1e9:.2f} GB > {MOE_TRAIN_BYTES / 1e9:.0f}: "
            f"{MOE_TRAIN_LAYERS - 1} layers")
        tcfg = train_config(cfg, MOE_TRAIN_LAYERS - 1)
    return tcfg


def recurrent_train_config(cfg):
    """recurrentgemma-2b's or mamba2-1.3b's training config: full width,
    full remat, all its layers, or as many as keep the predicted peak
    (``train_bytes``) within REC_TRAIN_BYTES; the depth is printed."""
    from repro_torch.models.transformer import LM
    layers = cfg.num_layers
    while True:
        tcfg = train_config(cfg, layers)
        predicted = train_bytes(tcfg, LM(tcfg).param_specs())
        if predicted <= REC_TRAIN_BYTES or layers == 1:
            break
        layers -= 1
    log(f"[train] {cfg.name}: {layers} of its {cfg.num_layers} layers "
        f"(predicted peak {predicted / 1e9:.2f} GB, limit "
        f"{REC_TRAIN_BYTES / 1e9:.0f})")
    return tcfg


def moe_groups(cfg, b: int, s: int) -> int:
    """The expert-FFN groups of one MoE layer's forward on [b, s] tokens,
    by ``models.moe.moe_apply``'s rule: one for s < 64, else one per row
    and chunk of ``cfg.moe_chunk`` (rounded down to a divisor of s)."""
    if s < 64:
        return 1
    chunk = max(1, min(s, cfg.moe_chunk))
    while s % chunk:
        chunk -= 1
    return b * (s // chunk)


def expert_leaves(params):
    """The stacked expert weights (w_gate, w_up, w_down) of a MoE tree."""
    moe = params["layers"].get("moe", {}) \
        if isinstance(params["layers"], dict) else {}
    return [moe[k] for k in ("w_gate", "w_up", "w_down") if k in moe]


def train_bytes(cfg, params) -> int:
    """Predicted peak device memory of a train step: the f32 state (master,
    m, v and the f32 gradients: 16 B a parameter), the bf16 compute copies
    of the matrices, the largest leaf's bf16 and f32 gradients in flight at
    the end of a backward, and a microbatch's activations under full remat
    (one layer's MLP recompute and its gradients, f32 gate and up
    included; a 512-position CE chunk's f32 logits, their log-sum-exp and
    gradient). MoE adds: every stacked expert leaf's bf16 gradient, whose
    layer slices wait until the stack's backward gathers them (full size,
    2 B an element), and one group's expert activations twice (recompute
    and backward): the [E, C, d] capacity buffers, out and their
    gradients; ``disp`` (bf16), ``comb`` (f32, its bf16 copy and its f32
    gradient) [T, E, C]; the f32 g and u [E, C, f] of the plain versions
    and the bf16 act, dg and du."""
    from repro_torch.bridge import leaves
    n = sum(p.numel() for p in leaves(params))
    mats = sum(p.numel() for p in leaves(params) if p.dim() >= 2)
    largest = max(p.numel() for p in leaves(params))
    mb = TRAIN_BATCH // TRAIN_MICRO
    act = 2 * 5 * mb * TRAIN_SEQ * cfg.d_ff * 4 \
        + 4 * mb * 512 * cfg.padded_vocab * 4
    S = TRAIN_SEQ * mb
    if cfg.family == "hybrid":
        # one RG-LRU block's recompute and backward: ~12 f32 [S, W]
        # tensors (gates, a, b, h and their gradients); one local
        # attention layer's banded scores and their gradient (f32)
        act += 12 * S * cfg.lru_width * 4 + 3 * mb * cfg.num_heads \
            * TRAIN_SEQ * (cfg.sliding_window + 128) * 4
    if cfg.family == "ssm":
        # one SSD layer's recompute and backward: ~8 f32 [S, d_inner]
        # tensors (y, dy, x, the gate and their gradients) and the
        # backward's workspaces (per-head dB and dC shares, the states
        # entering and the gradients leaving each chunk)
        nc = -(-TRAIN_SEQ // cfg.ssm_chunk)
        act += 8 * S * cfg.d_inner * 4 \
            + 2 * S * cfg.ssm_nheads * cfg.ssm_state * 4 \
            + 2 * mb * nc * cfg.ssm_nheads * cfg.ssm_headdim \
            * cfg.ssm_state * 4
    experts = sum(p.numel() for p in expert_leaves(params))
    if experts:
        E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        T = TRAIN_SEQ * mb // moe_groups(cfg, mb, TRAIN_SEQ)
        C = max(8, -(-math.ceil(T * cfg.num_experts_per_tok
                                * cfg.moe_capacity_factor / E) // 8) * 8)
        group = 4 * E * C * d * 2 + T * E * C * (2 + 4 + 2 + 4) \
            + E * C * f * (2 * 4 + 3 * 2)
        act += 2 * experts + 2 * group
    return 16 * n + 2 * mats + 6 * largest + act


def train_flops(cfg, params) -> float:
    """Model FLOPs of one train step (no remat recompute): 6 per token
    and parameter of every product (the layers and the LM head; the
    embedding is a lookup; of the experts only the active share, top-k of
    E), the attention's 4 * hq * d per causal (query, key) pair in the
    forward (within the window, on the attention layers; the
    encoder-decoder's encoder and cross attention: every pair, their
    leaves at the frames' count), 3 times for forward and backward, and
    for the SSM the SSD scan's forward (``ssd_flops``) and gradient
    (``ssd_bwd_flops``)."""
    from repro_torch.bridge import leaves
    n = sum(p.numel() for p in leaves(params)) - params["embed"].numel()
    experts = sum(p.numel() for p in expert_leaves(params))
    if experts:
        n -= experts - experts * cfg.num_experts_per_tok // cfg.num_experts
    tokens = TRAIN_BATCH * TRAIN_SEQ
    window = cfg.sliding_window or TRAIN_SEQ
    layers = (cfg._pattern().count("attn") if cfg.family == "hybrid"
              else 0 if cfg.family == "ssm" else cfg.num_layers)
    pairs = sum(min(i + 1, window) for i in range(TRAIN_SEQ)) * layers
    src_flops = 0.0
    if cfg.family == "encdec":
        # the encoder's leaves and the cross attention's K/V projections
        # take the frames, not the tokens; the encoder's self attention
        # sees every pair of frames, the cross attention every (token,
        # frame) pair
        xa = params["layers"]["xattn"]
        n_src = sum(p.numel() for p in leaves(params["enc_layers"])) \
            + params["adapter"].numel() + xa["w_k"].numel() \
            + xa["w_v"].numel()
        n -= n_src
        src_flops = 6.0 * n_src * TRAIN_BATCH * cfg.source_len
        pairs += cfg.source_len * (TRAIN_SEQ * cfg.num_layers
                                   + cfg.source_len * cfg.encoder_layers)
    attn = 3 * 4 * cfg.num_heads * cfg.head_dim * pairs * TRAIN_BATCH
    if cfg.family == "ssm":          # the SSD scan's own products
        attn += (ssd_flops(TRAIN_SEQ, cfg.ssm_chunk, cfg.ssm_nheads,
                           cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state)
                 + ssd_bwd_flops(TRAIN_SEQ, cfg.ssm_chunk, cfg.ssm_nheads,
                                 cfg.ssm_headdim, cfg.ssm_ngroups,
                                 cfg.ssm_state)) \
            * TRAIN_BATCH * cfg.num_layers
    return 6.0 * n * tokens + src_flops + attn


def train_batches(cfg, n: int, seed: int = 0):
    """n batches [TRAIN_BATCH, TRAIN_SEQ] of the synthetic LM stream on
    the card; for the encoder-decoder family each with ``frames``
    [TRAIN_BATCH, source_len, d_model] from the audio frontend stub
    (``models.frontends.fake_audio_frames``, drawn from ``seed``)."""
    import torch
    from repro_torch.models.frontends import fake_audio_frames
    from repro_torch.training.data import DataConfig, SyntheticLMStream
    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in stream.next_batch().items()}
        if cfg.family == "encdec":
            batch["frames"] = fake_audio_frames(cfg, gen, TRAIN_BATCH)
        out.append(batch)
    return out


def launch_counts(mods) -> dict:
    """Every launch counter of the kernel modules ``mods``, by kernel."""
    return {k: n for m in mods for k, n in m.LAUNCHES.items()}


def remat_forwards(cfg) -> int:
    """Forward passes a layer's kernels make in one microbatch's step under
    ``cfg.remat`` "full" (``models.transformer._maybe_remat``): the forward
    and the recompute in the backward; a stack of 48 or more layers is
    also checkpointed in √L groups (``_scan_groups``), whose recompute
    runs the group's layers once more, but for its last: non-reentrant
    checkpointing stops a recompute once the tensors the group saved are
    back (early stop, PyTorch's default), and a group's last layer's
    output is not one of them."""
    import torch.utils.checkpoint as ckp
    from repro_torch.models.transformer import _scan_groups
    L, G = cfg.num_layers, _scan_groups(cfg)
    if G == 1:
        return 2 * L
    early = ckp._enable_checkpoint_early_stop
    return 3 * L - (G if early is None or early else 0)


def train_kernels(cfg) -> dict:
    """The kernels one train step launches and how often: flash_attention
    twice an attention layer and microbatch (the forward and the full
    remat's recompute) and flash_attention_bwd once (the encoder-decoder:
    each encoder layer, and each decoder layer's self and cross attention,
    12 + 2 x 12 = 36 attention layers for seamless-m4t-medium); for MoE, each expert-FFN group
    (``moe_groups``) launches the two forward kernels twice, K1 once and
    K2 and K3 twice (the down product's and gate/up's); the hybrid's
    RG-LRU blocks rglru_scan twice and rglru_scan_bwd once (its local
    attention is banded: no flash kernel), the SSM's layers ssd_chunk
    ``remat_forwards`` times and ssd_chunk_bwd once, each a
    microbatch."""
    L, m = cfg.num_layers, TRAIN_MICRO
    if cfg.family == "encdec":          # the encoder's, self and cross
        L += cfg.encoder_layers + cfg.num_layers
    if cfg.family == "hybrid":
        rec = cfg._pattern().count("rec")
        return {"flash_attention": 0, "flash_attention_bwd": 0,
                "rglru_scan": 2 * rec * m, "rglru_scan_bwd": rec * m}
    if cfg.family == "ssm":
        return {"ssd_chunk": remat_forwards(cfg) * m, "ssd_chunk_bwd": L * m}
    want = {"flash_attention": 2 * L * m, "flash_attention_bwd": L * m}
    if cfg.family == "moe":
        g = L * m * moe_groups(cfg, TRAIN_BATCH // m, TRAIN_SEQ)
        want.update(moe_gemm=2 * g, moe_ffn_fused=2 * g,
                    moe_ffn_fused_bwd=g, moe_gemm_dx=2 * g,
                    moe_gemm_dw=2 * g)
    return want


def train_modules(cfg):
    """The kernel modules whose launches a train step of ``cfg`` counts."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    return {"moe": (FA, MG), "hybrid": (FA, RS),
            "ssm": (SC,)}.get(cfg.family, (FA,))


def drive_train(cfg) -> dict:
    """The training path: ``init_train_state`` on the card (f32 masters),
    ``make_train_step`` (bf16 compute, TRAIN_MICRO microbatches, AdamW)
    for TRAIN_STEPS steps on the data stream, then REPEAT_STEPS steps on
    one batch with ``AdamWHyper(warmup_steps=1, lr=1e-4)`` and one more
    under the profiler. Each step is timed to a synchronize; the kernels'
    launch counts are read around each step."""
    import torch
    from repro_torch.models.transformer import LM
    from repro_torch.training.optimizer import AdamWHyper
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    lm = LM(cfg)
    t0 = time.perf_counter()
    state = init_train_state(lm, 0, device="cuda")
    torch.cuda.synchronize()
    from repro_torch.bridge import leaves
    n = sum(p.numel() for p in leaves(state.params))
    predicted = train_bytes(cfg, state.params)
    flops = train_flops(cfg, state.params)
    log(f"[train] {cfg.name}, {cfg.num_layers} layers at full width: "
        f"{n / 1e9:.3f} B params, f32 state drawn in "
        f"{time.perf_counter() - t0:.1f} s; device memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    out = {"steps": [], "repeat": [], "launches": [], "predicted": predicted,
           "n": n, "flops": flops}
    where = card()
    mods = train_modules(cfg)
    runs = (("stream", make_train_step(lm, hyper=AdamWHyper(total_steps=100),
                                       microbatches=TRAIN_MICRO),
             train_batches(cfg, TRAIN_STEPS)),
            ("repeat", make_train_step(
                lm, hyper=AdamWHyper(warmup_steps=1, lr=1e-4),
                microbatches=TRAIN_MICRO),
             train_batches(cfg, 1, seed=1) * REPEAT_STEPS))
    for kind, step, batches in runs:
        for batch in batches:
            before = launch_counts(mods)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out["launches"].append({k: n - before[k] for k, n in
                                    launch_counts(mods).items()})
            out["steps" if kind == "stream" else "repeat"].append(
                (loss, float(metrics["grad_norm"]), ms))
            log(f"[train] {kind} step {int(metrics['step'])}: loss "
                f"{loss:.4f} grad_norm {float(metrics['grad_norm']):.4f} "
                f"{ms:.1f} ms, {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} "
                f"tokens/s, model {flops / ms / 1e9:.1f} TFLOP/s "
                f"({flops / ms / 1e9 / (BF16_FLOPS / 1e12):.1%} of the bf16 "
                f"peak; {where}); launches {out['launches'][-1]}")
    # one more step on the repeated batch under the profiler: where a
    # step's device time goes (not in the step times above)
    from torch.profiler import ProfilerActivity, profile
    step, batch = runs[1][1], runs[1][2][0]
    torch.cuda.synchronize()
    before = launch_counts(mods)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out["launches"].append({k: n - before[k]
                            for k, n in launch_counts(mods).items()})
    log_profile(prof, f"{cfg.name} train step ({cfg.num_layers} layers)",
                wall_us, 1, "step")
    out["finite"] = all(torch.isfinite(p).all() for p in leaves(state.params))
    del state
    return out


def check_train(cfg, out) -> None:
    """The step's launch counts (``train_kernels``), finite losses and
    weights, a falling loss on the repeated batch, the times and the peak
    memory."""
    import torch
    want = train_kernels(cfg)
    for i, got in enumerate(out["launches"]):
        if got != want:
            fail(f"train step {i}: launches {got}, expected {want} "
                 f"({cfg.num_layers} layers x {TRAIN_MICRO} microbatches)")
    if "moe_ffn_fused_bwd" in want:
        why = (f" x {want['moe_ffn_fused_bwd'] // cfg.num_layers // TRAIN_MICRO}"
               f" expert groups; forward kernels twice: forward and remat "
               f"recompute")
    elif cfg.family == "ssm" and remat_forwards(cfg) != 2 * cfg.num_layers:
        why = (f"; the forward kernel {remat_forwards(cfg)} times a "
               f"microbatch: forward, each layer's recompute and each "
               f"√L group's but for its last layer")
    else:
        why = "; the forward kernel twice: forward and remat recompute"
    layers = f"{cfg.num_layers} layers"
    if cfg.family == "encdec":
        layers = (f"{cfg.encoder_layers} encoder layers + {cfg.num_layers} "
                  f"decoder layers' self and cross attention")
    log(f"[train] every step launched "
        + ", ".join(f"{k} {n}" for k, n in want.items())
        + f" times ({layers} x {TRAIN_MICRO} microbatches" + why + ")")
    losses = [x[0] for x in out["steps"] + out["repeat"]]
    if not all(math.isfinite(x) for x in losses) or not out["finite"]:
        fail(f"train: a loss or a weight is not finite ({losses})")
    rep = [x[0] for x in out["repeat"]]
    if not rep[-1] < rep[0]:
        fail(f"train: the loss on one repeated batch did not fall ({rep})")
    log(f"[train] the loss on one repeated batch falls: "
        f"{' -> '.join(f'{x:.4f}' for x in rep)}")
    ms = sorted(x[2] for x in out["steps"][1:] + out["repeat"][1:])
    med = ms[len(ms) // 2]
    log(f"[train] step ms median {med:.1f} (min {ms[0]:.1f}, max "
        f"{ms[-1]:.1f}; the first step of each run excluded): "
        f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.0f} tokens/s, model "
        f"{out['flops'] / med / 1e9:.1f} TFLOP/s, "
        f"{out['flops'] / med / 1e9 / (BF16_FLOPS / 1e12):.1%} of the bf16 "
        f"peak; {card()}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[train] peak device memory {peak / 1e9:.2f} GB (predicted "
        f"{out['predicted'] / 1e9:.2f}; reserved at most "
        f"{torch.cuda.max_memory_reserved() / 1e9:.2f}) of total_memory "
        f"{total / 1e9:.2f} GB ({peak / total:.1%}); {card()}")
    if peak >= total:
        fail(f"train peak {peak / 1e9:.2f} GB >= {total / 1e9:.2f} GB")


def grad_arms(cfg, arms, mods, want, what: str) -> None:
    """One layer of ``cfg`` at full width, b 1, s TRAIN_SEQ: a
    microbatch's loss and every gradient leaf in each arm, an arm being
    module attributes set for its step (``(module, name, value)``, put
    back after it). The arm "plain" (the plain versions on the card, no
    kernel of ``mods`` launched) is the reference; "kernels" (launches
    exactly ``want``) must hold each leaf within GRAD_REL of its norm in
    L2 and the loss within 1e-3; every other arm is a planted fault in
    the kernels' outputs and must fail that bound."""
    import dataclasses
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.models.transformer import LM
    from repro_torch.training.train_step import (accumulate_grads,
                                                 init_train_state)
    one = dataclasses.replace(cfg, num_layers=1)
    lm = LM(one)
    params = init_train_state(lm, 3, device="cuda").params
    batch = {k: v[:1] for k, v in train_batches(one, 1, seed=2)[0].items()}
    worst, losses, launched = {}, {}, {}
    for arm, patches in arms.items():
        for p in leaves(params):
            p.requires_grad_(True)
            p.grad = None
        before = launch_counts(mods)
        kept = [(m, n, getattr(m, n)) for m, n, _ in patches]
        for m, n, v in patches:
            setattr(m, n, v)
        try:
            loss, _ = accumulate_grads(lm, params, batch)
        finally:
            for m, n, v in kept:
                setattr(m, n, v)
        launched[arm] = {k: n - before[k]
                         for k, n in launch_counts(mods).items()}
        losses[arm] = loss.item()
        if arm == "plain":
            gp = [p.grad for p in leaves(params)]
            continue
        rel = [float((p.grad - b).norm() / b.norm().clamp(min=1e-30))
               for p, b in zip(leaves(params), gp)]
        worst[arm] = max(rel)
        log(f"[train] grad check, {one.name} 1 layer at full width, b 1 s "
            f"{TRAIN_SEQ}, {arm}: loss {losses[arm]:.6f} plain "
            f"{losses['plain']:.6f}; each leaf's ||diff|| / ||plain||: "
            + ", ".join(f"{r:.2e}" for r in rel))
    nk, np_ = launched["kernels"], launched["plain"]
    if nk != want or any(np_.values()):
        fail(f"{what} grad check: launches kernels {nk} (expected {want}), "
             f"plain {np_}")
    lk, lp = losses["kernels"], losses["plain"]
    if abs(lk - lp) > 1e-3 * abs(lp) or worst["kernels"] > GRAD_REL:
        fail(f"{what} grad check: kernels and plain versions differ (loss "
             f"{lk} vs {lp}, worst leaf {worst['kernels']:.3e} > "
             f"{GRAD_REL})")
    for arm, w in worst.items():
        if arm != "kernels" and w <= GRAD_REL:
            fail(f"{what} grad check: the planted fault '{arm}' passes "
                 f"(worst leaf {w:.3e} <= {GRAD_REL})")
    for p in leaves(params):
        p.requires_grad_(False)
        p.grad = None


def train_grad_check(cfg) -> None:
    """``grad_arms`` on the attention: the flash kernels (forward and
    backward) against the attention's plain forward and backward on the
    card (bf16 compute, the two rounding at other places). Planted faults
    in the backward kernel's outputs: dk and dv of one key tile zeroed,
    and dq without that tile's share for the later half of the
    queries."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import attention as A

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, qpos, kpos, causal, bq, bkv):
            o, lse = FA.blocked_attention(q, k, v, qpos, kpos, causal=causal,
                                          window=0, block_q=bq, block_kv=bkv,
                                          return_lse=True)
            ctx.save_for_backward(q, k, v, o, lse, qpos, kpos)
            ctx.args = (causal, bq, bkv)
            return o

        @staticmethod
        def backward(ctx, do):
            causal, bq, bkv = ctx.args
            q, k, v, o, lse, qpos, kpos = ctx.saved_tensors
            grads = FA.flash_attention_bwd_ref(
                q, k, v, o, lse, do, qpos, kpos, causal=causal, block_q=bq,
                block_kv=bkv)
            return grads + (None,) * 5

    def plain(q, k, v, qpos, kpos, *, causal, block_q, block_kv):
        return Plain.apply(q, k, v, qpos, kpos, causal, block_q, block_kv)

    kernel_bwd = FA.flash_attention_bwd

    def drop_dkdv(q, k, v, o, lse, do, qpos, kpos, **kw):
        dq, dk, dv = kernel_bwd(q, k, v, o, lse, do, qpos, kpos, **kw)
        dk[:, FAULT_TILE] = 0
        dv[:, FAULT_TILE] = 0
        return dq, dk, dv

    def drop_dq(q, k, v, o, lse, do, qpos, kpos, **kw):
        dq, dk, dv = kernel_bwd(q, k, v, o, lse, do, qpos, kpos, **kw)
        holed = kpos.clone()
        holed[FAULT_TILE] = -1
        half = q.shape[1] // 2
        dq[:, half:] = kernel_bwd(q, k, v, o, lse, do, qpos, holed,
                                  **kw)[0][:, half:]
        return dq, dk, dv

    tile = f"keys {FAULT_TILE.start}-{FAULT_TILE.stop - 1}"
    grad_arms(cfg, {
        "plain": [(A, "flash_attention", plain)],
        "kernels": [],
        f"dk, dv of {tile} dropped": [(FA, "flash_attention_bwd",
                                       drop_dkdv)],
        f"dq without {tile} for the later half": [
            (FA, "flash_attention_bwd", drop_dq)]},
        (FA,), {"flash_attention": 2, "flash_attention_bwd": 1}, "train")


def moe_grad_check(cfg) -> None:
    """``grad_arms`` on the expert FFN: the expert kernels (forward and
    K1-K3) against its plain forward and backward on the card. Planted
    faults made from the kernels' own outputs: ``dw_down`` of one expert
    zeroed, and dx without its ``du @ w_up^T`` term for the rows of the
    expert where that term is largest."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    from repro_torch.models import moe as M

    class PlainFFN(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, wg, wu):
            ctx.save_for_backward(x, wg, wu)
            return MG.moe_ffn_fused_ref(x, wg, wu)

        @staticmethod
        def backward(ctx, dout):
            x, wg, wu = ctx.saved_tensors
            dg, du = MG.moe_ffn_fused_bwd_ref(x, wg, wu, dout)
            return (MG.moe_gemm_dx_ref((dg, du), (wg, wu)),
                    *MG.moe_gemm_dw_ref(x, (dg, du)))

    class PlainGemm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return MG.moe_gemm_ref(x, w)

        @staticmethod
        def backward(ctx, dy):
            x, w = ctx.saved_tensors
            return (MG.moe_gemm_dx_ref((dy,), (w,)),
                    MG.moe_gemm_dw_ref(x, (dy,))[0])

    kernel_dx, kernel_dw = MG.moe_gemm_dx, MG.moe_gemm_dw

    def zero_dwd(a, dys):               # the down product: one output
        dws = kernel_dw(a, dys)
        if len(dys) == 1:
            dws[0][0] = 0
        return dws

    def drop_du(dys, ws):               # gate/up: two pairs
        dx = kernel_dx(dys, ws)
        if len(dys) == 2:
            part = kernel_dx(dys[:1], ws[:1])
            e = int((dx.float() - part.float()).flatten(1).norm(dim=1)
                    .argmax())
            dx[e] = part[e]
        return dx

    g = moe_groups(cfg, 1, TRAIN_SEQ)
    grad_arms(cfg, {
        "plain": [(M, "moe_ffn_fused", PlainFFN.apply),
                  (M, "moe_gemm", PlainGemm.apply)],
        "kernels": [],
        "dw_down of expert 0 zeroed": [(MG, "moe_gemm_dw", zero_dwd)],
        "dx without du @ w_up^T for one expert's rows": [
            (MG, "moe_gemm_dx", drop_du)]},
        (MG,), {"moe_gemm": 2 * g, "moe_ffn_fused": 2 * g,
                "moe_ffn_fused_bwd": g, "moe_gemm_dx": 2 * g,
                "moe_gemm_dw": 2 * g}, "moe")


def rec_grad_check(cfg) -> None:
    """``grad_arms`` on the RG-LRU block: rglru_scan and its reverse scan
    against the scan's plain forward and plain backward on the card.
    Planted faults made from the kernel's own outputs: the gradient
    carried into the 64-step chunk FAULT_TILE dropped (that chunk's da and
    db from the kernel run on the chunk alone), and that chunk's da
    zeroed."""
    import torch
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    from repro_torch.models import rglru as RG

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b, h0):
            h = RS.rglru_scan_ref(a, b, h0)
            ctx.save_for_backward(a, h, h0)
            return h

        @staticmethod
        def backward(ctx, dh):
            return RS.rglru_scan_bwd_ref(*ctx.saved_tensors, dh)

    kernel_bwd = RS.rglru_scan_bwd
    c = FAULT_TILE

    def drop_carry(a, h, h0, dh):
        da, db, dh0 = kernel_bwd(a, h, h0, dh)
        da[:, c], db[:, c], _ = kernel_bwd(
            a[:, c].contiguous(), h[:, c].contiguous(),
            h[:, c.start - 1].contiguous(), dh[:, c].contiguous())
        return da, db, dh0

    def zero_da(a, h, h0, dh):
        da, db, dh0 = kernel_bwd(a, h, h0, dh)
        da[:, c] = 0
        return da, db, dh0

    steps = f"steps {c.start}-{c.stop - 1}"
    grad_arms(cfg, {
        "plain": [(RG, "rglru_scan", Plain.apply)],
        "kernels": [],
        f"the gradient carried into {steps} dropped": [
            (RS, "rglru_scan_bwd", drop_carry)],
        f"da of {steps} zeroed": [(RS, "rglru_scan_bwd", zero_da)]},
        (RS,), {"rglru_scan": 2, "rglru_scan_bwd": 1}, "rec")


def ssd_grad_check(cfg) -> None:
    """``grad_arms`` on the SSD layer: ssd_chunk and its backward kernels
    against the scan's plain forward and plain backward on the card.
    Planted faults made from the kernels' own outputs: the state's
    gradient carried into the chunk that ends at step FAULT_SSD_STEP
    dropped (the kernels run on the steps before it with dS_final 0 and
    on the steps after it from that chunk's state), and ddt without its
    A·rcumsum(dcum) term (x·dxdt alone, from dx / dt)."""
    import torch
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    from repro_torch.models import ssd as SSD

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, B, C, S0, chunk):
            y, S = SC.ssd_chunk_ref(x, dt, A, B, C, S0, chunk)
            ctx.save_for_backward(x, dt, A, B, C, S0)
            ctx.chunk = chunk
            return y, S

        @staticmethod
        def backward(ctx, dy, dS):
            return SC.ssd_chunk_bwd_ref(*ctx.saved_tensors, dy, dS,
                                        ctx.chunk) + (None,)

    kernel_bwd = SC.ssd_chunk_bwd
    e = FAULT_SSD_STEP

    def drop_carry(x, dt, A, B, C, S0, dy, dS, chunk, ws=None):
        k = e // chunk
        if ws is not None:              # [b, nc, nh, hp, n]
            ws = ws.view(x.shape[0], -1, *S0.shape[1:])
        pre = kernel_bwd(x[:, :e], dt[:, :e].contiguous(), A, B[:, :e],
                         C[:, :e], S0, dy[:, :e], torch.zeros_like(dS),
                         chunk, ws=None if ws is None else ws[:, :k])
        S_e = (ws[:, k] if ws is not None else SC.ssd_chunk_ref(
            x[:, :e], dt[:, :e], A, B[:, :e], C[:, :e], S0, chunk)[1])
        suf = kernel_bwd(x[:, e:], dt[:, e:].contiguous(), A, B[:, e:],
                         C[:, e:], S_e.contiguous(), dy[:, e:], dS, chunk,
                         ws=None if ws is None else ws[:, k:])
        return (torch.cat([pre[0], suf[0]], 1), torch.cat([pre[1], suf[1]],
                                                          1),
                pre[2] + suf[2], torch.cat([pre[3], suf[3]], 1),
                torch.cat([pre[4], suf[4]], 1), pre[5])

    def no_rcum(x, dt, A, B, C, S0, dy, dS, chunk, ws=None):
        dx, ddt, dA, dB, dC, dS0 = kernel_bwd(x, dt, A, B, C, S0, dy, dS,
                                              chunk, ws=ws)
        direct = (x.float() * dx.float()).sum(-1) / dt
        return dx, direct, dA, dB, dC, dS0

    grad_arms(cfg, {
        "plain": [(SSD, "ssd_chunk", lambda *a: Plain.apply(*a))],
        "kernels": [],
        f"the state's gradient carried into step {e - 1} dropped": [
            (SC, "ssd_chunk_bwd", drop_carry)],
        "ddt without A·rcumsum(dcum)": [(SC, "ssd_chunk_bwd", no_rcum)]},
        (SC,), {"ssd_chunk": 2, "ssd_chunk_bwd": 1}, "ssd")


# ---------------------------------------------------------------------------
# distributed: the distribution layer (DTensor over a DeviceMesh)
# ---------------------------------------------------------------------------

DIST_TURNS = 5                  # the 1x1 DTensor train step and the plain
#                                 one, taken in turns: the median of each
DIST_REL = 1e-3                 # a leaf DTensor computes with other ops
#                                 than the plain step's: within this of its
#                                 norm in L2 (bit for bit otherwise)
DIST_SERVE_ROWS = 2             # the 1x1 DTensor serving path: 2 prompts
DIST_PROMPT = 512               # of 512 tokens in a 1024-row cache,
DIST_MAX_LEN = 1024             # prefill and 8 greedy decode steps
DIST_STEPS = 8
LSE_TOL = 1e-5                  # decode_attention's lse vs its plain
#                                 version, of max(1, |lse|)
DIST_MOE_LAYERS = 4             # qwen3-moe's and mixtral's DTensor
#                                 serving paths: 4 of their layers
MX_DIST_PROMPT = 4500           # mixtral: 2 prompts past its 4096 window,
MX_DIST_MAX_LEN = 8192          # a ring of 4096 slots a layer
RG_DIST_LAYERS = 3              # recurrentgemma-2b's DTensor train step:
#                                 rec, rec, attn
MB_DIST_LAYERS = 4              # mamba2-1.3b's
RG_DIST_PROMPT = 2500           # recurrentgemma-2b's DTensor serving: 2
RG_DIST_MAX_LEN = 4096          # prompts past its 2048 window (the ring
#                                 of 2048 slots wraps)
DRYRUN_CELLS = (("minitron-8b", "train_4k"),
                ("phi3-medium-14b", "prefill_32k"),
                ("qwen3-moe-30b-a3b", "train_4k"),
                ("mixtral-8x7b", "decode_32k"),
                ("mamba2-1.3b", "train_4k"),
                ("recurrentgemma-2b", "long_500k"),
                ("seamless-m4t-medium", "train_4k"),
                ("seamless-m4t-medium", "prefill_32k"))
DRYRUN_DIR = ROOT / "artifacts" / "dryrun-chip"


def start_dryruns():
    """The dry-run cells at full scale on the 16x16 production mesh, each
    in a subprocess of its own (its fake world of 256 ranks is
    process-wide and cannot share a process with the card's NCCL group),
    all started together so they run beside the card's phases; they
    use no card (CUDA_VISIBLE_DEVICES empty) and run at a lower CPU
    priority than the host-bound phases beside them."""
    import os
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    # one thread each: fake tensors compute nothing, and the host-bound
    # phases beside them share the machine's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        out = open(DRYRUN_DIR / f"{arch}__{shape}.log", "w")
        procs.append((arch, shape, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--force", "--out", str(DRYRUN_DIR)],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(10))))
    atexit.register(stop_dryruns, procs)     # a failed phase exits early
    return procs


def stop_dryruns(procs) -> None:
    """Kill any dry-run subprocess still running."""
    for _, _, out, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()


def finish_dryruns(procs) -> list:
    """Wait for the dry-run cells; each must be ``ok`` with a per-device
    peak under the card's total_memory. Prints each cell's record."""
    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    recs = []
    for arch, shape, out, proc in procs:
        try:
            rc = proc.wait(timeout=600)
        finally:
            stop_dryruns([(arch, shape, out, proc)])
        path = DRYRUN_DIR / f"{arch}__{shape}__pod16x16.json"
        if rc != 0 or not path.exists():
            tail = (DRYRUN_DIR / f"{arch}__{shape}.log").read_text()[-2000:]
            fail(f"dry run {arch} {shape} exited {rc}: {tail}")
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            fail(f"dry run {arch} {shape}: {rec['status']} "
                 f"{rec.get('error', rec.get('reason'))}")
        mem, roof = rec["memory"], rec["roofline"]
        peak = mem["peak_bytes_per_device"]
        log(f"[dryrun] {arch} {shape} on pod16x16 (256 fake ranks, "
            f"{rec['microbatches']} microbatches; fake-tensor estimate, "
            f"H100 SXM5 data-sheet constants): peak {peak / 1e9:.2f} GB a "
            f"device (arguments {mem['argument_bytes'] / 1e9:.2f}, "
            f"temporaries {mem['temp_bytes'] / 1e9:.2f}) of this card's "
            f"total_memory {total / 1e9:.2f} GB; compute "
            f"{roof['compute_s'] * 1e3:.1f} ms, memory "
            f"{roof['memory_s'] * 1e3:.1f} ms, collective "
            f"{roof['collective_s'] * 1e3:.1f} ms -> {roof['dominant']}; "
            f"useful_flops_ratio {rec['useful_flops_ratio']:.4f}; "
            f"collectives " + ", ".join(
                f"{k} {v['count']} ({v['wire_bytes'] / 1e9:.2f} GB on the "
                f"wire)" for k, v in rec["collectives"].items())
            + f"; traced in {rec['compile_s']:.1f} s")
        log(f"[dryrun] {arch} {shape} record: " + json.dumps(
            {k: rec[k] for k in ("memory", "roofline", "useful_flops_ratio",
                                 "plan_notes")}))
        if peak >= total:
            fail(f"dry run {arch} {shape}: {peak / 1e9:.2f} GB a device >= "
                 f"total_memory {total / 1e9:.2f} GB")
        recs.append(rec)
    return recs


def phase_lse(cfg, vl_cfg) -> None:
    """decode_attention's lse output (``return_lse=True``) against its
    plain version at minitron-8b's and qwen2-vl-72b's decode shapes, bf16
    and f32: lengths 0, exactly one shard of S on a 16-way model axis,
    half past one, and S. The output must be the call without lse's bit
    for bit; lse within LSE_TOL of max(1, |lse|), -inf at length 0."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention as DA
    for c, B, S in ((cfg, 4, 2048), (vl_cfg, 4, 1040)):
        Hq, Hkv, D = c.num_heads, c.num_kv_heads, c.head_dim
        lengths = torch.tensor([0, S // 16, S // 2 + 1, S],
                               dtype=torch.int32, device="cuda")
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(41)
            q = torch.randn((B, Hq, D), generator=g, device="cuda").to(dt)
            k, v = (torch.randn((B, S, Hkv, D), generator=g,
                                device="cuda").to(dt).transpose(1, 2)
                    for _ in range(2))
            o = DA.decode_attention(q, k, v, lengths)
            o2, lse = DA.decode_attention(q, k, v, lengths, return_lse=True)
            torch.cuda.synchronize()
            if not torch.equal(o, o2):
                fail(f"decode_attention {c.name} {dt}: the output with lse "
                     f"differs from the output without it")
            _, want = DA.decode_attention_ref(q, k, v, lengths,
                                              return_lse=True)
            empty = lengths == 0
            if not (bool(torch.isneginf(lse[empty]).all())
                    and bool(torch.isfinite(lse[~empty]).all())):
                fail(f"decode_attention {c.name} {dt}: lse at length 0 must "
                     f"be -inf, elsewhere finite: {lse[:, 0].tolist()}")
            err = float(((lse[~empty] - want[~empty]).abs()
                         / want[~empty].abs().clamp(min=1.0)).max())
            log(f"[distributed] decode_attention lse {c.name} (B {B} Hq "
                f"{Hq} Hkv {Hkv} D {D} S {S}, lengths "
                f"{lengths.tolist()}) {str(dt)[6:]}: output bit for bit "
                f"the call without lse; lse vs plain {err:.2e} of max(1, "
                f"|lse|) (tolerance {LSE_TOL:.0e}), -inf at length 0")
            if err > LSE_TOL:
                fail(f"decode_attention lse {c.name} {dt}: {err:.2e} > "
                     f"{LSE_TOL:.0e}")


def init_nccl() -> None:
    """A process group of one rank on NCCL (address given explicitly: no
    launcher tells this process of a cluster)."""
    import socket
    import torch.distributed as dist
    if dist.is_initialized():
        return
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)


def dist_train_plain(cfg, batch, mods):
    """The plain step of ``cfg``'s train state from seed 0 on ``batch``:
    (metrics on the host, the updated params, m and v copied to the host
    leaf by leaf, the launches of the kernel modules ``mods``)."""
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.models.transformer import LM
    from repro_torch.training.optimizer import AdamWHyper
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    lm = LM(cfg)
    state = init_train_state(lm, 0, device="cuda")
    step = make_train_step(lm, hyper=AdamWHyper(warmup_steps=1, lr=1e-4),
                           microbatches=TRAIN_MICRO)
    before = launch_counts(mods)
    state, m = step(state, batch)
    torch.cuda.synchronize()
    launches = {k: n - before[k] for k, n in launch_counts(mods).items()}
    host = [[t.cpu() for t in leaves(tree)] for tree in
            (state.params, state.opt["m"], state.opt["v"])]
    metrics = {k: float(v) for k, v in m.items()}
    del state
    return metrics, host, launches


def dist_train_sharded(cfg, batch):
    """The DTensor step: the state from seed 0 laid out on a 1x1 mesh of
    an NCCL group by ``make_plan`` and ``train_state_specs`` (on one rank
    each DTensor wraps the plain tensor itself), the batch by the plan's
    batch specs, one ``make_train_step`` step inside ``use_mesh``.
    Returns (mesh, plan, the DTensor state, the plain state it wraps,
    metrics, the step, the DTensor batch)."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import make_plan
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.planner import distribute_tree
    from repro_torch.training.optimizer import AdamWHyper
    from repro_torch.training.train_step import (distribute_batch,
                                                 init_train_state,
                                                 make_train_step,
                                                 train_state_specs)
    mesh = make_test_mesh((1, 1), device_type="cuda")
    lm = LM(cfg)
    state = init_train_state(lm, 0, device="cuda")
    plan = make_plan(cfg, mesh, "train", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     param_tree=state.params)
    dstate = distribute_tree(state, train_state_specs(plan, state), mesh)
    dbatch = distribute_batch(batch, plan, mesh, TRAIN_MICRO)
    step = make_train_step(lm, hyper=AdamWHyper(warmup_steps=1, lr=1e-4),
                           microbatches=TRAIN_MICRO)
    with use_mesh(mesh):
        dstate, m = step(dstate, dbatch)
    torch.cuda.synchronize()
    metrics = {k: float(v.full_tensor()) for k, v in m.items()}
    return mesh, dstate, state, metrics, step, dbatch


def check_dist_train(cfg, plain, sharded) -> None:
    """Loss, grad norm and every updated leaf (params, m, v) of the DTensor
    step against the plain step's: bit for bit, or, where DTensor computes
    a leaf with other ops, within DIST_REL of its norm (named here)."""
    import torch
    from repro_torch.bridge import leaves
    (pm, host, plain_launches), (dstate, dm, launches) = plain, sharded
    if plain_launches != launches:
        fail(f"[distributed] {cfg.name} launches: DTensor step {launches}, "
             f"plain {plain_launches}")
    log(f"[distributed] {cfg.name} launches a step: DTensor {launches} == "
        f"plain {plain_launches}")
    for k in ("loss", "grad_norm"):
        if dm[k] != pm[k]:
            rel = abs(dm[k] - pm[k]) / max(abs(pm[k]), 1e-30)
            log(f"[distributed] {k}: DTensor {dm[k]!r} plain {pm[k]!r} "
                f"({rel:.2e})")
            if rel > DIST_REL:
                fail(f"[distributed] {k} {dm[k]} vs plain {pm[k]}")
    exact, near = 0, []
    for name, tree, want in zip(("params", "m", "v"), (
            dstate.params, dstate.opt["m"], dstate.opt["v"]), host):
        for i, (t, w) in enumerate(zip(leaves(tree), want)):
            got = t.to_local()        # compared on the card, leaf by leaf
            w = w.to(got.device)
            if torch.equal(got, w):
                exact += 1
                continue
            rel = float((got.double() - w.double()).norm()
                        / w.double().norm().clamp(min=1e-30))
            near.append((f"{name}[{i}] {tuple(w.shape)}", rel))
            del w
    log(f"[distributed] {cfg.name} ({cfg.num_layers} layers) 1x1 DTensor "
        f"train step vs the plain step from the same seed: loss {dm['loss']!r} vs {pm['loss']!r}, grad_norm "
        f"{dm['grad_norm']!r} vs {pm['grad_norm']!r}; {exact} of "
        f"{exact + len(near)} updated leaves (params, m, v) bit for bit"
        + ("" if not near else "; the others within " + ", ".join(
            f"{n} {r:.2e}" for n, r in near) + " of their norms"))
    bad = [(n, r) for n, r in near if r > DIST_REL]
    if bad:
        fail(f"[distributed] leaves past {DIST_REL:.0e} of their norm: "
             f"{bad}")


def time_dist_train(cfg, mesh, dstate, state, step, dbatch) -> None:
    """The DTensor step and the plain step on the same tensors (on one
    rank the DTensor state wraps the plain one), DIST_TURNS each in turns
    in this process: the median ms of each and the DTensor host
    overhead it shows."""
    import torch
    from repro_torch.sharding.ctx import use_mesh
    batch = {k: v.to_local() for k, v in dbatch.items()}
    ms = {"plain": [], "DTensor": []}
    for _ in range(DIST_TURNS):
        for kind in ("plain", "DTensor"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "plain":
                state, m = step(state, batch)
                float(m["loss"])
            else:
                with use_mesh(mesh):
                    dstate, m = step(dstate, dbatch)
                float(m["loss"].full_tensor())
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    log(f"[distributed] {cfg.name} train step ({cfg.num_layers} layers, "
        f"seq {TRAIN_SEQ}, batch {TRAIN_BATCH} in {TRAIN_MICRO} "
        f"microbatches, full remat), median of {DIST_TURNS} in turns: plain "
        f"{med['plain']:.1f} ms ({', '.join(f'{x:.1f}' for x in ms['plain'])}"
        f"), DTensor on a 1x1 mesh {med['DTensor']:.1f} ms ("
        f"{', '.join(f'{x:.1f}' for x in ms['DTensor'])}): DTensor's host "
        f"overhead {med['DTensor'] - med['plain']:.1f} ms a step "
        f"({med['DTensor'] / med['plain'] - 1:.1%}); {card()}")


def drive_dist_serve(cfg, params, batch, max_len=DIST_MAX_LEN) -> dict:
    """The 1x1 DTensor serving path: the params laid out by the decode
    plan on a 1x1 NCCL mesh (wrapping the plain tensors), a prefill of
    ``batch`` (tokens; encdec's frames) into a ``max_len`` cache and
    DIST_STEPS greedy decode steps through the DTensor model; encdec's
    cross K/V caches must be DTensors in the plan's cache layout. Returns
    its tokens and times."""
    import torch
    from repro_torch.kernels.sharded import is_dtensor
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import make_plan
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.planner import (distribute, distribute_tree,
                                              placements)
    mesh = make_test_mesh((1, 1), device_type="cuda")
    lm = LM(cfg)
    b = batch["tokens"].shape[0]
    plan = make_plan(cfg, mesh, "decode", batch=b, seq=max_len,
                     param_tree=params, cache_tree=lm.init_cache(
                         b, max_len, device="meta"))
    dparams = distribute_tree(params, plan.param_specs, mesh)
    spec = plan.batch_specs["tokens"]
    out = {"tokens": [], "ms": []}
    with torch.no_grad(), use_mesh(mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = lm.prefill(dparams, {
            k: distribute(v, plan.batch_specs[k], mesh)
            for k, v in batch.items()}, max_len)
        t = lg.full_tensor().argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        for _ in range(DIST_STEPS):
            out["tokens"].append(t.cpu())
            t0 = time.perf_counter()
            lg, cache = lm.decode_step(dparams, cache,
                                       distribute(t, spec, mesh))
            t = lg.full_tensor()[:, 0].argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
    out["layout"] = cache_layout(cache["layers"])
    for k in ("cross_k", "cross_v"):
        if k not in cache:
            continue
        want = placements(plan.cache_specs[k], mesh)
        if not is_dtensor(cache[k]) or tuple(cache[k].placements) != want:
            fail(f"[distributed] {cfg.name}: the prefill's {k} is "
                 f"{type(cache[k]).__name__} "
                 f"{getattr(cache[k], 'placements', None)}, not a DTensor "
                 f"laid out as the plan's {want}")
        out["layout"][k] = [str(p) for p in cache[k].placements]
    return out


def cache_layout(layers) -> dict:
    """Each cache leaf's placements (of the first layer that holds it,
    for the hybrid's tuple of layers)."""
    seen = {}
    for layer in layers if isinstance(layers, tuple) else (layers,):
        for k, v in layer.items():
            seen.setdefault(k, [str(p) for p in v.placements])
    return seen


def plain_serve(cfg, params, batch, max_len=DIST_MAX_LEN) -> dict:
    """``drive_dist_serve``'s prefill and greedy steps on the plain
    tensors."""
    import torch
    from repro_torch.models.transformer import LM
    lm = LM(cfg)
    out = {"tokens": [], "ms": []}
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = lm.prefill(params, batch, max_len)
        t = lg.argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        for _ in range(DIST_STEPS):
            out["tokens"].append(t.cpu())
            t0 = time.perf_counter()
            lg, cache = lm.decode_step(params, cache, t)
            t = lg[:, 0].argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def check_dist_serve(cfg, got, want, launches, want_n=None,
                     prompt=DIST_PROMPT) -> None:
    """The DTensor path's tokens equal to the plain path's, and its
    launches ``want_n`` (by default a dense model's: flash once a layer,
    decode attention once a layer a step)."""
    import torch
    if not all(torch.equal(a, b) for a, b in zip(got["tokens"],
                                                  want["tokens"])):
        fail(f"[distributed] {cfg.name}: the DTensor path's tokens differ "
             f"from the plain path's: "
             f"{[t[:, 0].tolist() for t in got['tokens']]} vs "
             f"{[t[:, 0].tolist() for t in want['tokens']]}")
    if want_n is None:
        want_n = {"flash_attention": cfg.num_layers,
                  "decode_attention": cfg.num_layers * DIST_STEPS}
    if any(launches[k] != n for k, n in want_n.items()):
        fail(f"[distributed] {cfg.name} serving launches {launches}, "
             f"expected {want_n}")
    med = {k: sorted(v["ms"])[len(v["ms"]) // 2]
           for k, v in (("plain", want), ("DTensor", got))}
    log(f"[distributed] {cfg.name} ({cfg.num_layers} layers) 1x1 DTensor "
        f"serving: {DIST_SERVE_ROWS} prompts of {prompt} tokens, "
        f"{DIST_STEPS} greedy steps: tokens equal the plain path's "
        f"({[t[:, 0].tolist() for t in got['tokens']]}); "
        f"launches {want_n}; cache layout {got['layout']}; prefill "
        f"{got['prefill_ms']:.1f} ms (plain {want['prefill_ms']:.1f}), "
        f"decode step median {med['DTensor']:.2f} ms (plain "
        f"{med['plain']:.2f}); {card()}")


def dist_train_path(tcfg, counters, mods, required, variant=None,
                    then=None) -> dict:
    """A 1x1 DTensor train step of ``tcfg`` against the plain step from
    the same seed (bit for bit, or DIST_REL where DTensor's ops differ;
    equal launches of the kernel modules ``mods``; the grouped GEMMs on
    ``variant``, if given), then both timed in turns. Returns the DTensor
    step's launches; ``then(tcfg, mesh, dstate, step, dbatch)``, if
    given, runs on the stepped DTensor state before the timing and its
    launches are returned beside them (a list of two)."""
    import torch
    batch = train_batches(tcfg, 1, seed=1)[0]
    torch.cuda.reset_peak_memory_stats()
    plain = dist_train_plain(tcfg, batch, mods)
    release_memory()
    name = f"{tcfg.name} DTensor train (1x1 mesh, {tcfg.num_layers} layers)"
    launches, (mesh, dstate, state, dm, step, dbatch) = drive_path(
        name, counters, required, dist_train_sharded, tcfg, batch)
    if variant:
        check_variant(name, launches, variant)
    check_dist_train(tcfg, plain, (dstate, dm, {
        k: launches[k] for k in plain[2]}))
    del plain
    if then is not None:
        launches = [launches, then(tcfg, mesh, dstate, step, dbatch)]
        release_memory()
    time_dist_train(tcfg, mesh, dstate, state, step, dbatch)
    log(f"[distributed] {tcfg.name} train peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB; "
        f"{card()}")
    del dstate, state, step, dbatch
    release_memory()
    return launches


def dist_serve_path(cfg, counters, required, want_n, prompt: int,
                    max_len: int, variant=None) -> dict:
    """``cfg``'s 1x1 DTensor serving path (``drive_dist_serve``: a prefill
    of DIST_SERVE_ROWS prompts of ``prompt`` tokens, for encdec each with
    ``source_len`` frames, into a ``max_len`` cache, DIST_STEPS greedy
    steps) against the plain path's tokens, with
    the launches ``want_n`` and the grouped GEMMs on ``variant``, if
    given. Returns the DTensor path's launches (an int8 path's also under
    "<kernel> (int8)")."""
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    import torch
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(7)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (DIST_SERVE_ROWS, prompt), generator=g,
        device="cuda", dtype=torch.int32)}
    if cfg.family == "encdec":
        from repro_torch.models.frontends import fake_audio_frames
        batch["frames"] = fake_audio_frames(cfg, g, DIST_SERVE_ROWS)
    want = plain_serve(cfg, params, batch, max_len)
    name = f"{cfg.name} DTensor serving (1x1 mesh, {cfg.num_layers} layers)"
    launches, got = drive_path(name, counters, required, drive_dist_serve,
                               cfg, params, batch, max_len)
    if variant:
        check_variant(name, launches, variant)
    if variant == "int8":
        launches.update({f"{k} (int8)": v
                         for k, v in MG.INT8_LAUNCHES.items()})
    check_dist_serve(cfg, got, want, launches, want_n, prompt)
    log(f"[distributed] {cfg.name} serving peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card()}")
    del params
    release_memory()
    return launches


def state_pairs(a, b) -> list:
    """(name, leaf of ``a``, leaf of ``b``) over two train states' params,
    m, v and step."""
    from repro_torch.bridge import leaves
    pairs = [(f"{n}[{i}] {tuple(x.shape)}", x, y)
             for n, ta, tb in (("params", a.params, b.params),
                               ("m", a.opt["m"], b.opt["m"]),
                               ("v", a.opt["v"], b.opt["v"]))
             for i, (x, y) in enumerate(zip(leaves(ta), leaves(tb)))]
    return pairs + [("step", a.opt["step"], b.opt["step"])]


def dist_ckpt_path(counters):
    """``then`` of mamba2-1.3b's 1x1 DTensor train path: its stepped
    DTensor state saved (``checkpoint.save``: gathered leaf by leaf, one
    file) to a directory under artifacts/ that is removed after, restored
    from a ``meta`` tree straight into the plan's layout
    (``restore(shardings=)``), every restored leaf bit for bit the saved
    one in its layout; then a step from the restored state (the main
    path: ssd_chunk and ssd_chunk_bwd launched) against a step from the
    state in memory on the same batch: every leaf (params, m, v, the
    step) bit for bit or within DIST_REL of its norm (named), loss and
    grad norm likewise, launches of the SSD kernels equal. Prints the GB
    written and the save and restore seconds beside the card. Returns the
    resumed step's launches."""

    def then(tcfg, mesh, dstate, step, dbatch) -> dict:
        import os
        import shutil
        import tempfile
        import torch
        from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
        from repro_torch.models.transformer import LM
        from repro_torch.sharding import make_plan
        from repro_torch.sharding.ctx import use_mesh
        from repro_torch.training import checkpoint as ckpt
        from repro_torch.training.train_step import (init_train_state,
                                                     train_state_specs)
        DRYRUN_DIR.parent.mkdir(parents=True, exist_ok=True)
        d = tempfile.mkdtemp(prefix="ckpt-", dir=DRYRUN_DIR.parent)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = ckpt.save(d, 1, dstate, extra={"data_step": 1})
            save_s = time.perf_counter() - t0
            gb = os.path.getsize(os.path.join(path, "shard_0.npz")) / 1e9
            like = init_train_state(LM(tcfg), 0, device="meta")
            plan = make_plan(tcfg, mesh, "train", batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ, param_tree=like.params)
            t0 = time.perf_counter()
            rstate, extra = ckpt.restore(
                d, 1, like, shardings=(mesh, train_state_specs(plan, like)))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(d, ignore_errors=True)
        pairs = state_pairs(rstate, dstate)
        moved = [n for n, a, b in pairs
                 if type(a) is not type(b) or a.placements != b.placements
                 or not torch.equal(a.to_local(), b.to_local())]
        if moved or extra != {"data_step": 1}:
            fail(f"[checkpoint] {tcfg.name}: restored leaves differ from "
                 f"the saved state or its layout: {moved[:8]}; extra "
                 f"{extra}")
        log(f"[checkpoint] {tcfg.name} ({tcfg.num_layers} layers) DTensor "
            f"state: {gb:.3f} GB written in {save_s:.2f} s, restored from "
            f"a meta tree into the plan's layout in {restore_s:.2f} s, "
            f"{len(pairs)} of {len(pairs)} leaves bit for bit; {card()}")

        def resumed():
            with use_mesh(mesh):
                new, m = step(rstate, dbatch)
            torch.cuda.synchronize()
            return new, {k: float(v.full_tensor()) for k, v in m.items()}
        launches, (rnew, rm) = drive_path(
            f"{tcfg.name} DTensor train step resumed from a checkpoint",
            counters, tuple(SC.LAUNCHES), resumed)
        before = launch_counts((SC,))
        with use_mesh(mesh):
            dnew, dm = step(dstate, dbatch)
        torch.cuda.synchronize()
        dm = {k: float(v.full_tensor()) for k, v in dm.items()}
        mem = {k: n - before[k] for k, n in launch_counts((SC,)).items()}
        got = {k: launches[k] for k in mem}
        if got != mem:
            fail(f"[checkpoint] {tcfg.name} SSD launches: resumed step "
                 f"{got}, step in memory {mem}")
        exact, near = 0, []
        for k in ("loss", "grad_norm"):
            if rm[k] != dm[k]:
                near.append((k, abs(rm[k] - dm[k]) / max(abs(dm[k]),
                                                          1e-30)))
        for n, a, b in state_pairs(rnew, dnew):
            a, b = a.to_local(), b.to_local()
            if torch.equal(a, b):
                exact += 1
                continue
            near.append((n, float((a.double() - b.double()).norm()
                                  / b.double().norm().clamp(min=1e-30))))
        log(f"[checkpoint] {tcfg.name} step resumed from the checkpoint vs "
            f"the step from the state in memory: loss {rm['loss']!r} vs "
            f"{dm['loss']!r}; {exact} of {len(pairs)} leaves (params, m, "
            f"v, step) bit for bit"
            + ("" if not near else "; the others within " + ", ".join(
                f"{n} {r:.2e}" for n, r in near) + " of their norms")
            + f"; SSD launches {got} == {mem}")
        bad = [(n, r) for n, r in near if r > DIST_REL]
        if bad:
            fail(f"[checkpoint] {tcfg.name} resumed step past "
                 f"{DIST_REL:.0e}: {bad}")
        del rstate, rnew, dnew
        return launches
    return then


def dist_recurrent_paths(rg_cfg, mb_cfg, counters) -> list:
    """The recurrent families on a 1x1 mesh: recurrentgemma-2b's train
    step at RG_DIST_LAYERS layers and mamba2-1.3b's at MB_DIST_LAYERS
    (full width; the scans and their backward through their DTensor
    routes) against the plain steps, launches equal, mamba2's state then
    saved and resumed (``dist_ckpt_path``); then their serving
    at full depth (recurrentgemma's prompts past its window), tokens equal
    to the plain path's, every RG-LRU block and SSD layer's prefill scan
    launched once, decode on the plain single-step recurrence (no kernel).
    Returns the paths' launches."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    paths = []
    for rcfg, layers, mod, then in (
            (rg_cfg, RG_DIST_LAYERS, RS, None),
            (mb_cfg, MB_DIST_LAYERS, SC, dist_ckpt_path(counters))):
        t0 = time.perf_counter()
        tcfg = train_config(rcfg, layers)
        launches = dist_train_path(tcfg, counters, (mod, FA),
                                   tuple(mod.LAUNCHES), then=then)
        paths += launches if then else [launches]
        log(f"[distributed] {tcfg.name} train path"
            + (" and checkpoint" if then else "")
            + f": {time.perf_counter() - t0:.1f} s")
    none = {"flash_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0}
    for rcfg, kernel, n, prompt, max_len in (
            (rg_cfg, "rglru_scan", rg_cfg._pattern().count("rec"),
             RG_DIST_PROMPT, RG_DIST_MAX_LEN),
            (mb_cfg, "ssd_chunk", mb_cfg.num_layers, DIST_PROMPT,
             DIST_MAX_LEN)):
        t0 = time.perf_counter()
        paths.append(dist_serve_path(rcfg, counters, (kernel,),
                                     dict(none, **{kernel: n}), prompt,
                                     max_len))
        log(f"[distributed] {rcfg.name} serving path ({rcfg.num_layers} "
            f"layers, prompts of {prompt}): {time.perf_counter() - t0:.1f} "
            f"s")
    return paths


def dist_encdec_paths(sm_cfg, counters) -> list:
    """The encoder-decoder family on a 1x1 mesh at full width and depth
    (12 encoder and 12 decoder layers): seamless-m4t-medium's train step
    (frames from the audio frontend stub; the encoder, the cross
    attention and the memory's gradient through DTensor ops) against the
    plain step, launches equal; then its serving, 2 prompts with
    ``source_len`` frames each, tokens equal to the plain path's,
    flash_attention once an encoder layer and twice a decoder layer (self
    and cross) a prefill, decode_attention once a decoder layer a step
    (the cross attention's decode is plain PyTorch, as in the
    reference). Returns the paths' launches."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    t0 = time.perf_counter()
    tcfg = train_config(sm_cfg, sm_cfg.num_layers)
    paths = [dist_train_path(tcfg, counters, (FA,),
                             ("flash_attention", "flash_attention_bwd"))]
    log(f"[distributed] {tcfg.name} train path: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    L = sm_cfg.num_layers
    paths.append(dist_serve_path(
        sm_cfg, counters, ("flash_attention", "decode_attention"),
        {"flash_attention": sm_cfg.encoder_layers + 2 * L,
         "decode_attention": L * DIST_STEPS, "paged_decode_attention": 0},
        DIST_PROMPT, DIST_MAX_LEN))
    log(f"[distributed] {sm_cfg.name} serving path ({sm_cfg.encoder_layers} "
        f"+ {L} layers, prompts of {DIST_PROMPT} with {sm_cfg.source_len} "
        f"frames): {time.perf_counter() - t0:.1f} s")
    return paths


def phase_distributed(cfg, counters, dryruns, moe_cfg, mx_cfg, rg_cfg,
                      mb_cfg, sm_cfg) -> list:
    """The distribution layer on the card, each path on a 1x1 mesh of a
    one-rank NCCL group against the same path on plain tensors: the train
    steps of minitron-8b and qwen3-moe-30b-a3b at 4 layers (bit for bit,
    or DIST_REL where DTensor's ops differ; equal launches of every
    kernel, the expert kernels and K1-K3 too; both steps timed in turns),
    minitron-8b's serving at 32 layers, qwen3-moe's at DIST_MOE_LAYERS
    (expert parallelism's region: dispatch, the expert kernels and combine
    in one ``local_map``) and mixtral-8x7b's on int8 weights at
    DIST_MOE_LAYERS (prompts past its window: the banded prefill, the
    ring filled and read rank by rank), tokens equal to the plain path's;
    the recurrent families' train steps and serving
    (``dist_recurrent_paths``); seamless-m4t-medium's train step and
    serving at full depth (``dist_encdec_paths``); then the dry-run
    cells. Returns the main paths' launches."""
    import dataclasses
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.moe_gemm import moe_gemm as MG
    paths = []
    init_nccl()
    t0 = time.perf_counter()
    paths.append(dist_train_path(
        train_config(cfg), counters, (FA,),
        ("flash_attention", "flash_attention_bwd")))
    log(f"[distributed] {cfg.name} train path: "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    paths.append(dist_serve_path(
        cfg, counters, ("flash_attention", "decode_attention"), None,
        DIST_PROMPT, DIST_MAX_LEN))
    log(f"[distributed] {cfg.name} serving path: "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    mcfg = moe_train_config(moe_cfg)
    experts = tuple(MG.LAUNCHES)
    launches = dist_train_path(mcfg, counters, (FA, MG),
                               ("flash_attention", "flash_attention_bwd")
                               + experts, "tensor")
    paths.append(launches)
    log(f"[distributed] {mcfg.name} train path: "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    scfg = dataclasses.replace(moe_cfg, num_layers=DIST_MOE_LAYERS)
    n = scfg.num_layers
    launches = dist_serve_path(
        scfg, counters, ("flash_attention", "decode_attention",
                         "moe_ffn_fused", "moe_gemm"),
        {"flash_attention": n, "decode_attention": n * DIST_STEPS,
         "moe_ffn_fused": n * (moe_groups(scfg, DIST_SERVE_ROWS,
                                          DIST_PROMPT) + DIST_STEPS),
         "moe_gemm": n * (moe_groups(scfg, DIST_SERVE_ROWS, DIST_PROMPT)
                          + DIST_STEPS)}, DIST_PROMPT, DIST_MAX_LEN,
        "tensor")
    paths.append(launches)
    log(f"[distributed] {scfg.name} serving path: "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    xcfg = dataclasses.replace(mx_cfg, num_layers=DIST_MOE_LAYERS)
    n = xcfg.num_layers
    per = moe_groups(xcfg, DIST_SERVE_ROWS, MX_DIST_PROMPT) + DIST_STEPS
    launches = dist_serve_path(
        xcfg, counters, ("moe_ffn_fused", "moe_gemm"),
        {"flash_attention": 0, "decode_attention": 0,
         "paged_decode_attention": 0, "moe_ffn_fused": n * per,
         "moe_gemm": n * per}, MX_DIST_PROMPT, MX_DIST_MAX_LEN, "int8")
    paths.append(launches)
    log(f"[distributed] {xcfg.name} int8 serving path (prompts of "
        f"{MX_DIST_PROMPT} past the {xcfg.sliding_window}-token window, "
        f"ring of {min(xcfg.sliding_window, MX_DIST_MAX_LEN)} slots, "
        f"{DIST_STEPS} steps): {time.perf_counter() - t0:.1f} s")
    paths += dist_recurrent_paths(rg_cfg, mb_cfg, counters)
    paths += dist_encdec_paths(sm_cfg, counters)
    if dryruns:
        finish_dryruns(dryruns)
    else:
        log("[distributed] --quick: the dry-run subprocesses are skipped")
    return paths


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


_LAP = {"t": time.perf_counter()}


def lap(name: str) -> None:
    """Print the seconds since the previous lap (or the start) as the
    seconds of phase ``name``."""
    now = time.perf_counter()
    log(f"[time] {name}: {now - _LAP['t']:.1f} s")
    _LAP["t"] = now


def drive_path(name: str, counters, required, fn, *args):
    """One main path: every launch counter set to 0 just before ``fn``,
    read just after; each kernel in ``required`` must have been launched.
    Checks of the path's result run after this, outside the window.
    Returns (launches, what ``fn`` returned)."""
    for c in counters:
        c.reset_launches()
    out = fn(*args)
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    log(f"[main path] {name}: launches {launches}")
    for k in required:
        if launches[k] == 0:
            fail(f"{k} was not launched on the {name} path")
    return launches, out


def main() -> None:
    import argparse
    import dataclasses
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build, check every kernel against its plain "
                         "version and compare the small models card vs CPU; "
                         "no full-width path and no result line")
    quick = ap.parse_args().quick
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch.configs import get_config
        from repro_torch.configs.registry import DRAFT_PAIRINGS
        from repro_torch.kernels.decode_attention import decode_attention \
            as DA
        from repro_torch.kernels.flash_attention import flash_attention as FA
        from repro_torch.kernels.moe_gemm import moe_gemm as MG
        from repro_torch.kernels.rglru_scan import rglru_scan as RS
        from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    phase_build()
    lap("build")
    dryruns = [] if quick else start_dryruns()
    cfg = get_config("minitron-8b")
    moe_cfg = get_config("qwen3-moe-30b-a3b")
    mx_cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                                 serve_weight_dtype="int8")
    rg_cfg = get_config("recurrentgemma-2b")
    mb_cfg = get_config("mamba2-1.3b")
    sm_cfg = get_config("seamless-m4t-medium")
    vl_cfg = dataclasses.replace(get_config("qwen2-vl-72b"),
                                 serve_weight_dtype="int8")
    rows = phase_kernels(cfg, moe_cfg, sm_cfg, vl_cfg)
    lap("kernels: decode attention")
    rows.update(phase_flash_kernels(cfg, sm_cfg, vl_cfg))
    lap("kernels: flash_attention")
    rows.update(phase_flash_bwd_kernels(cfg, sm_cfg))
    lap("kernels: flash_attention_bwd")
    rows.update(phase_moe_kernels(moe_cfg, cfg.d_model))
    lap("kernels: grouped GEMMs")
    rows.update(phase_moe_bwd_kernels(moe_cfg))
    check_refusals()
    lap("kernels: expert backward")
    rows.update(phase_int8_kernels(mx_cfg))
    lap("kernels: int8 experts")
    phase_split_kernels(moe_cfg, mx_cfg, rg_cfg, mb_cfg, sm_cfg)
    lap("kernels: split shapes")
    rows.update(phase_recurrent_kernels(rg_cfg, mb_cfg))
    lap("kernels: recurrent")
    rows.update(phase_recurrent_bwd_kernels(rg_cfg, mb_cfg))
    lap("kernels: recurrent backward")
    phase_lse(cfg, vl_cfg)
    lap("kernels: decode lse")
    if quick:
        log("[distributed] --quick: the dry-run subprocesses and the 1x1 "
            "DTensor paths are skipped")
        phase_reference()
        log(f"[quick] kernels and small models checked in "
            f"{time.perf_counter() - t_start:.1f} s")
        return

    counters = (DA, FA, MG, RS, SC)
    attn = ("decode_attention", "paged_decode_attention", "flash_attention")
    paths = []

    params = init_model(cfg)
    with PrefillCount() as pc:
        launches, _ = drive_path(cfg.name, counters, attn, drive_model, cfg,
                                 params)
    check_flash(cfg.name, launches, cfg.num_layers, pc.n)
    paths.append(launches)
    catalog, sessions = adapter_setup(cfg)
    with PrefillCount() as pc:
        launches, mixed = drive_path(
            f"{cfg.name} adapters", counters,
            ("decode_attention", "moe_gemm", "flash_attention"),
            phase_adapters, cfg, params, catalog, sessions)
    check_flash(f"{cfg.name} adapters", launches, cfg.num_layers, pc.n)
    check_variant(f"{cfg.name} adapters", launches, "narrow")
    paths.append(launches)
    check_adapters(cfg, params, catalog, sessions, mixed)
    check_logits(cfg, params)
    profile_prefill(cfg, params)
    del params
    release_memory()
    lap(f"path: {cfg.name}, adapters")

    params = init_model(moe_cfg)
    with PrefillCount() as pc:
        launches, _ = drive_path(moe_cfg.name, counters,
                                 attn + ("moe_gemm", "moe_ffn_fused"),
                                 drive_model, moe_cfg, params)
    check_flash(moe_cfg.name, launches, moe_cfg.num_layers, pc.n)
    check_variant(moe_cfg.name, launches, "tensor")
    paths.append(launches)
    check_logits(moe_cfg, params)
    profile_prefill(moe_cfg, params)
    log(f"[moe] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del params
    release_memory()
    lap(f"path: {moe_cfg.name}")

    torch.cuda.reset_peak_memory_stats()
    mpath = dataclasses.replace(mx_cfg, num_layers=MIXTRAL_LAYERS)
    params = init_model(mpath)
    name = f"{mpath.name} int8 ({mpath.num_layers} layers)"
    launches, out = drive_path(name, counters, ("moe_gemm", "moe_ffn_fused"),
                               drive_mixtral, mpath, params)
    launches.update({f"{k} (int8)": n for k, n in MG.INT8_LAUNCHES.items()})
    check_variant(name, launches, "int8")
    if any(launches[k] for k in attn):
        fail(f"{name}: an attention kernel ran on a path whose prefill is "
             f"banded and whose decode reads a ring "
             f"({ {k: launches[k] for k in attn} })")
    log(f"[main path] {name}: no attention kernel launched (banded prefill, "
        f"ring decode)")
    paths.append(launches)
    check_mixtral(mpath, params, out)
    profile_prefill(mpath, params, n=6000, width=MIXTRAL_MAX_LEN)
    peak = torch.cuda.max_memory_allocated()
    log(f"[mixtral] peak device memory {peak / 1e9:.1f} GB; {card()}")
    if peak >= 80e9:
        fail(f"mixtral peak device memory {peak / 1e9:.1f} GB >= 80 GB")
    del params, out
    release_memory()
    lap(f"path: {mx_cfg.name} int8")

    left = torch.cuda.memory_allocated()
    log(f"[qwen2-vl] device memory allocated after the mixtral path: "
        f"{left / 1e9:.3f} GB")
    if left > 0.1e9:
        fail(f"{left / 1e9:.2f} GB still allocated before qwen2-vl-72b")
    torch.cuda.reset_peak_memory_stats()
    params = init_model(vl_cfg)
    slots, predicted, total = qwen2vl_slots(vl_cfg,
                                            torch.cuda.memory_allocated())
    time_qwen2vl_decode(rows, vl_cfg, slots)
    name = f"{vl_cfg.name} int8"
    with PrefillCount() as pc:
        launches, out = drive_path(name, counters, attn, drive_qwen2vl,
                                   vl_cfg, params, slots)
    check_qwen2vl_launches(vl_cfg, launches, pc)
    paths.append(launches)
    check_qwen2vl(vl_cfg, params, out)
    profile_prefill(vl_cfg, params, n=1500, width=QWEN2VL_MAX_LEN)
    peak = torch.cuda.max_memory_allocated()
    log(f"[qwen2-vl] peak device memory {peak / 1e9:.2f} GB (predicted "
        f"{predicted / 1e9:.2f} at {slots} slots; reserved at most "
        f"{torch.cuda.max_memory_reserved() / 1e9:.2f}) of total_memory "
        f"{total / 1e9:.2f} GB; {card()}")
    if peak >= total:
        fail(f"qwen2-vl peak device memory {peak / 1e9:.2f} GB >= "
             f"total_memory {total / 1e9:.2f} GB")
    del params, out
    release_memory()
    lap(f"path: {vl_cfg.name} int8")

    for rcfg, kernel, per_prefill in (
            (rg_cfg, "rglru_scan", rg_cfg._pattern().count("rec")),
            (mb_cfg, "ssd_chunk", mb_cfg.num_layers)):
        torch.cuda.reset_peak_memory_stats()
        params = init_model(rcfg)
        paths.append(drive_recurrent(rcfg, params, kernel, per_prefill,
                                     counters))
        profile_prefill(rcfg, params)
        log(f"[{kernel}] {rcfg.name} peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        del params
        release_memory()
        lap(f"path: {rcfg.name}")

    torch.cuda.reset_peak_memory_stats()
    params = init_model(sm_cfg)
    with PrefillCount() as pc:
        launches, out = drive_path(sm_cfg.name, counters,
                                   ("flash_attention", "decode_attention"),
                                   drive_encdec, sm_cfg, params)
    check_flash(sm_cfg.name, launches, sm_cfg.encoder_layers
                + 2 * sm_cfg.num_layers, pc.n)
    if launches["decode_attention"] != sm_cfg.num_layers * ENCDEC_STEPS \
            or launches["paged_decode_attention"]:
        fail(f"{sm_cfg.name}: decode attention launched "
             f"{launches['decode_attention']} times in {ENCDEC_STEPS} steps, "
             f"expected {sm_cfg.num_layers} per step (paged: none)")
    paths.append(launches)
    check_encdec(sm_cfg, out)
    profile_prefill(sm_cfg, params, n=700, width=1024)
    log(f"[encdec] {sm_cfg.name} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params, out
    release_memory()
    lap(f"path: {sm_cfg.name}")

    draft_id, target_id = "recurrentgemma-2b", "minitron-8b"
    if target_id not in DRAFT_PAIRINGS[draft_id]:
        fail(f"{draft_id} does not draft for {target_id}")
    torch.cuda.reset_peak_memory_stats()
    orch, mgr, session = split_session(draft_id, target_id)
    verify_binding = mgr.states[session.session_id].verify_binding
    log(f"[split] session {session.session_id}: draft "
        f"{session.binding.site_id}/{session.binding.model_id}, verify "
        f"{verify_binding.site_id}/{verify_binding.model_id}")
    draft_cfg = get_config(session.binding.model_id)
    target_cfg = get_config(verify_binding.model_id)
    dparams, tparams = init_model(draft_cfg), init_model(target_cfg)
    name = f"split {draft_cfg.name} -> {target_cfg.name}"
    with PrefillCount() as pc:
        launches, out = drive_path(name, counters, attn + ("rglru_scan",),
                                   phase_split, orch, mgr, session,
                                   draft_cfg, target_cfg, dparams, tparams)
    paths.append(launches)
    log(f"[split] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; {card()}")
    check_split(orch, mgr, session, draft_cfg, target_cfg, dparams,
                launches, pc.by_model, out)
    del dparams, tparams, out, orch, mgr, session
    release_memory()
    lap("path: split")

    left = torch.cuda.memory_allocated()
    log(f"[train] device memory allocated after the split path: "
        f"{left / 1e9:.3f} GB")
    if left > 0.1e9:
        fail(f"{left / 1e9:.2f} GB still allocated before the training path")
    torch.cuda.reset_peak_memory_stats()
    tcfg = train_config(cfg)
    name = f"{tcfg.name} train ({tcfg.num_layers} layers)"
    launches, out = drive_path(name, counters, ("flash_attention",
                                                "flash_attention_bwd"),
                               drive_train, tcfg)
    paths.append(launches)
    check_train(tcfg, out)
    del out
    release_memory()
    train_grad_check(tcfg)
    release_memory()
    lap(f"train: {tcfg.name}")

    left = torch.cuda.memory_allocated()
    log(f"[train] device memory allocated before {moe_cfg.name}'s training "
        f"path: {left / 1e9:.3f} GB")
    if left > 0.1e9:
        fail(f"{left / 1e9:.2f} GB still allocated before the MoE training "
             f"path")
    torch.cuda.reset_peak_memory_stats()
    mcfg = moe_train_config(moe_cfg)
    name = f"{mcfg.name} train ({mcfg.num_layers} layers)"
    launches, out = drive_path(name, counters, tuple(train_kernels(mcfg)),
                               drive_train, mcfg)
    check_variant(name, launches, "tensor")
    bwd = {k: launches[k] for k in MG.BWD_TENSOR_CORE_LAUNCHES}
    if dict(MG.BWD_TENSOR_CORE_LAUNCHES) != bwd:
        fail(f"{name}: backward launches {bwd}, of them on the tensor cores "
             f"{dict(MG.BWD_TENSOR_CORE_LAUNCHES)}: expected all")
    log(f"[main path] {name}: every backward kernel on the tensor-core "
        f"route {bwd}")
    paths.append(launches)
    check_train(mcfg, out)
    del out
    release_memory()
    moe_grad_check(mcfg)
    release_memory()
    lap(f"train: {mcfg.name}")

    for rcfg, check in ((rg_cfg, rec_grad_check), (mb_cfg, ssd_grad_check)):
        left = torch.cuda.memory_allocated()
        log(f"[train] device memory allocated before {rcfg.name}'s "
            f"training path: {left / 1e9:.3f} GB")
        if left > 0.1e9:
            fail(f"{left / 1e9:.2f} GB still allocated before "
                 f"{rcfg.name}'s training path")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tcfg = recurrent_train_config(rcfg)
        want = train_kernels(tcfg)
        name = f"{tcfg.name} train ({tcfg.num_layers} layers)"
        launches, out = drive_path(name, counters,
                                   tuple(k for k, n in want.items() if n),
                                   drive_train, tcfg)
        paths.append(launches)
        check_train(tcfg, out)
        del out
        release_memory()
        check(tcfg)
        release_memory()
        log(f"[train] {rcfg.name}'s training path and grad check: "
            f"{time.perf_counter() - t0:.1f} s")
        lap(f"train: {rcfg.name}")

    left = torch.cuda.memory_allocated()
    log(f"[train] device memory allocated before {sm_cfg.name}'s training "
        f"path: {left / 1e9:.3f} GB")
    if left > 0.1e9:
        fail(f"{left / 1e9:.2f} GB still allocated before {sm_cfg.name}'s "
             f"training path")
    torch.cuda.reset_peak_memory_stats()
    tcfg = train_config(sm_cfg, sm_cfg.num_layers)
    name = (f"{tcfg.name} train ({tcfg.encoder_layers} + {tcfg.num_layers} "
            f"layers)")
    launches, out = drive_path(name, counters, ("flash_attention",
                                                "flash_attention_bwd"),
                               drive_train, tcfg)
    paths.append(launches)
    check_train(tcfg, out)
    del out
    release_memory()
    lap(f"train: {sm_cfg.name}")

    left = torch.cuda.memory_allocated()
    log(f"[distributed] device memory allocated before the distribution "
        f"layer's paths: {left / 1e9:.3f} GB")
    if left > 0.1e9:
        fail(f"{left / 1e9:.2f} GB still allocated before the distributed "
             f"paths")
    t0 = time.perf_counter()
    paths += phase_distributed(cfg, counters, dryruns, moe_cfg, mx_cfg,
                               rg_cfg, mb_cfg, sm_cfg)
    log(f"[distributed] {time.perf_counter() - t0:.1f} s")
    lap("distributed")

    for name, row in rows.items():
        # a grouped-GEMM row counts its variant's launches: the int8 rows
        # the int8 variant's, the others every launch but those
        row["launches"] = sum(p.get(name, 0) - p.get(f"{name} (int8)", 0)
                              for p in paths)
    phase_reference()
    lap("reference")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": list(rows.values())}))
    log(card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

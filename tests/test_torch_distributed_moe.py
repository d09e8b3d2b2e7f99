"""The MoE family on several ranks, held against the unsharded port and
the reference: each case starts its own world of gloo ranks in a
subprocess (``tests/_torch_dist_cases.py``, OMP_NUM_THREADS=1); this
process never joins a process group.

* One ``make_train_step`` step of qwen3-moe's smoke config on a 2x2
  data×model mesh against the unsharded port step and the reference's,
  f32: each leaf of m and v within 1e-5 of its largest magnitude, each
  leaf's update within 2e-3 of the other's update's norm (the rule of
  tests/test_torch_training.py), loss and grad norm within 1e-5: 4
  experts on the 2-way model axis (expert parallelism) and 3 (expert-TP
  over d_ff, the planner's fallback). 32 tokens a row, the flattened
  group (s < 64) that routes each microbatch's tokens together, so each
  microbatch must group the rows it groups unsharded
  (``distribute_batch``); and 64, the per-row groups of the train cells.
* Flattened decode (s < 64) with capacity drops: 16 rows at
  ``moe_capacity_factor`` 0.5 on the 2x2 mesh and unsharded; the
  unsharded run drops assignments, and each data rank's own token count
  would give another capacity or other positions, so the global count
  and the ranks' position offsets decide the tokens: equal, logits within
  1e-5. At capacity factor 4 each rank's buffers, which hold its own
  tokens only, are smaller than the capacity: the same.
* int8 expert weights (``quantize_tree``): prefill and greedy decode,
  tokens equal, logits within 1e-5.
* mixtral's smoke config with one KV head, so its ring is split on S over
  the model axis: a 40-token prefill past the 16-token window and 24
  decode steps that wrap the ring, tokens equal, logits within 1e-5.
* The dry run's FLOPs of a small qwen3-moe train cell on a fake 2x4
  world against the reference's loop-aware HLO count on 8 forced host
  devices, within [0.9, 1.1].
* Every MoE cell at 1/128 scale on a fake world of 256 ranks (the 16x16
  production mesh, where mixtral's 8 experts take the expert-TP
  fallback), 4 of each model's layers: ``ok``, no all-to-all.
* ``--production`` plans and distributes qwen3-moe's smoke state with no
  code of its own (a 2x2 mesh in place of the production one)."""

import dataclasses
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro.models.transformer import LM as JaxLM
from repro_torch import bridge
from repro_torch.models import moe as TM
from repro_torch.models.quant import quantize_tree
from repro_torch.models.transformer import LM
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from tests._torch_pairs import configs, weights
from tests.test_torch_distributed import ENV, _close, _result, _run

TOL = 1e-5          # f32: each leaf, or each logit, of its largest magnitude
STEP_REL = 2e-3     # a step's update of a leaf vs the reference's, of its
#                     norm (tests/test_torch_training.py)
LOSS_TOL = 2e-2     # bf16 launcher steps: loss, relative

#: case: (overrides, tokens a row)
TRAIN = {"ep": ({}, 32), "expert_tp": ({"num_experts": 3}, 32),
         "ep_rows": ({}, 64)}


@pytest.mark.parametrize("case", list(TRAIN))
def test_moe_train_step_on_2x2_matches_unsharded_and_reference(case,
                                                               tmp_path):
    over, seq = TRAIN[case]
    jcfg, tcfg = configs("qwen3-moe-30b-a3b", smoke=True)
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(tcfg, **over)
    jstate = jax_ts.init_train_state(JaxLM(jcfg), jax.random.key(0))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (4, seq)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = _run("train", {"cfg": tcfg, "batch": tbatch,
                         "state": bridge.train_state_to_torch(jstate,
                                                              "cpu")},
               tmp_path)
    plain, pm = ts.make_train_step(
        LM(tcfg), hyper=opt.AdamWHyper(warmup_steps=1), microbatches=2,
        compute_dtype=torch.float32)(
            bridge.train_state_to_torch(jstate, "cpu"), tbatch)
    jnew, jm = jax.jit(jax_ts.make_train_step(
        JaxLM(jcfg), hyper=jax_opt.AdamWHyper(warmup_steps=1),
        microbatches=2, compute_dtype=jnp.float32))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    plain = bridge.train_state_to_numpy(plain)
    ref = bridge.train_state_to_numpy(jnew)
    # the gradients, through AdamW's moments: each leaf within TOL
    for want, name in ((plain, "unsharded port"), (ref, "reference")):
        _close(out["m"], want["opt"]["m"], f"m vs {name}")
        _close(out["v"], want["opt"]["v"], f"v vs {name}")
    # the params by tests/test_torch_training.py's rule for a step: each
    # leaf's update within STEP_REL of its norm. AdamW's first step divides
    # each gradient by its own magnitude, so an element whose gradient is
    # 1e-8 of its leaf's largest (where the sharded sums round otherwise)
    # moves by a share of lr: 3.98e-5 of the embedding's largest against
    # the unsharded port at 32 tokens, 2.14e-5 for the unsharded port
    # against the reference
    before = bridge.train_state_to_numpy(jstate)["params"]
    for want, name in ((plain, "unsharded port"), (ref, "reference")):
        for g, w, b in zip(bridge.leaves(out["params"]),
                           bridge.leaves(want["params"]),
                           bridge.leaves(before)):
            g, w, b = (np.asarray(t, np.float64) for t in (g, w, b))
            du, dw = g - b, w - b
            assert np.linalg.norm(du - dw) <= STEP_REL * max(
                np.linalg.norm(dw), 1e-30), f"update vs {name}"
    for k, got in (("loss", out["loss"]), ("grad_norm", out["grad_norm"])):
        for want in (float(pm[k]), float(jm[k])):
            assert abs(got - want) <= TOL * max(1.0, abs(want)), k
    # every layer's MoE ran sharded: 2 layers, 2 microbatches
    assert out["moe"] == 2 * tcfg.num_layers
    # [L, E, d, f]: E over model (EP) or f over model (expert-TP), the
    # ZeRO-3 dim over data
    want = [2, 3] if over else [2, 1]
    assert out["placements"]["w_gate"] == want
    assert any("expert-TP" in n for n in out["notes"]) == \
        bool(over)


def _serve(tcfg, params, tokens, steps, max_len, tmp_path):
    """The 2x2 serving case and the unsharded prefill + greedy decode of
    the same tokens: tokens equal, logits within TOL. Returns the case's
    output."""
    out = _run("serve", {"cfg": tcfg, "params": params, "tokens": tokens,
                         "steps": steps, "max_len": max_len}, tmp_path)
    lm = LM(tcfg)
    with torch.no_grad():
        lg, cache = lm.prefill(params, {"tokens": tokens}, max_len)
        want_logits, want_tokens = [lg.numpy()], []
        t = lg.argmax(-1)[:, None].to(torch.int32)
        for _ in range(steps):
            want_tokens.append(t.numpy())
            lg, cache = lm.decode_step(params, cache, t)
            want_logits.append(lg[:, 0].numpy())
            t = lg[:, 0].argmax(-1)[:, None].to(torch.int32)
    for got, want in zip(out["tokens"], want_tokens):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(out["logits"], want_logits):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert out["calls"]["moe"] == (steps + 1) * tcfg.num_layers
    return out


def test_flattened_decode_with_drops_on_2x2_matches_unsharded(tmp_path,
                                                              monkeypatch):
    """16 rows, 8 prompt tokens each, 6 greedy steps at capacity factor
    0.5: the prefill's group is 128 tokens (C 32; a data rank's 64 would
    give C 16) and each decode step's 16 (C 8: a rank's 8 rows give the
    same C but positions from 0, where the global count starts the second
    rank's after the first's)."""
    _, tcfg = configs("qwen3-moe-30b-a3b", smoke=True)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.5)
    _, params = weights(*configs("qwen3-moe-30b-a3b", smoke=True))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (16, 8)).astype(np.int32))
    groups = []
    real = TM._route

    def route(p, cfg, x, lay=None, flat=False):
        out = real(p, cfg, x, lay, flat)
        groups.append(out[1])
        return out
    monkeypatch.setattr(TM, "_route", route)
    _serve(tcfg, params, tokens, 6, 32, tmp_path)
    drops = bites = 0
    for top_i in groups:
        T = top_i.shape[0]
        C, pos = TM._capacity(tcfg, T), TM._positions(tcfg, top_i, T)
        drops += int((pos >= C).sum())
        half = top_i[T // 2:]
        local = TM._positions(tcfg, half, T // 2)
        bites += (TM._capacity(tcfg, T // 2) != C
                  or not torch.equal(local, pos[T // 2:]))
    assert drops > 0
    assert bites == len(groups)


def test_flattened_group_local_buffers_on_2x2_match_unsharded(tmp_path):
    """16 rows, 8 prompt tokens each, 6 greedy steps at capacity factor
    4: a decode step's group of 16 tokens has capacity 32, and each data
    rank's buffers hold its own 8 tokens' rows at their positions among
    its own (the prefill's: 64 of 256), so a row placed at its position
    in the global group would fall outside them."""
    _, tcfg = configs("qwen3-moe-30b-a3b", smoke=True)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=4.0)
    _, params = weights(*configs("qwen3-moe-30b-a3b", smoke=True))
    lay = types.SimpleNamespace(token_parts=2, e0=0, experts=2)
    assert TM._group(tcfg, 8, lay, True)[:2] == (32, 8)
    assert TM._group(tcfg, 64, lay, True)[:2] == (256, 64)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (16, 8)).astype(np.int32))
    _serve(tcfg, params, tokens, 6, 32, tmp_path)


def test_int8_experts_on_2x2_match_unsharded(tmp_path):
    """``quantize_tree`` of the smoke weights (the experts and attention
    matrices int8 ``{q, s}``, split as their q): 4 rows of 8 tokens, 6
    greedy steps."""
    _, tcfg = configs("qwen3-moe-30b-a3b", smoke=True)
    _, params = weights(*configs("qwen3-moe-30b-a3b", smoke=True))
    params = quantize_tree(params)
    assert set(params["layers"]["moe"]["w_gate"]) == {"q", "s"}
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (4, 8)).astype(np.int32))
    _serve(tcfg, params, tokens, 6, 32, tmp_path)


def test_mixtral_seq_split_ring_on_2x2_matches_unsharded(tmp_path):
    """One KV head (on a 2-way model axis): the ring of 16 slots splits on
    S, 8 a rank. A 40-token prefill past the window, 24 steps wrapping
    the ring; every layer's prefill banded and every step's ring
    attention run sharded."""
    over = {"num_kv_heads": 1}
    jcfg, tcfg = configs("mixtral-8x7b", smoke=True)
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(tcfg, **over)
    assert tcfg.sliding_window == 16
    _, params = weights(jcfg, tcfg)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (4, 40)).astype(np.int32))
    steps = 24
    out = _serve(tcfg, params, tokens, steps, 64, tmp_path)
    # [L, b, S, kh, hd]: the batch over data, S over model
    assert out["cache_layout"] == [1, 2]
    assert out["calls"]["banded"] == tcfg.num_layers
    assert out["calls"]["ring"] == steps * tcfg.num_layers
    assert out["calls"]["seq"] == 0


_OVERRIDES = {"num_layers": 2, "d_model": 128, "num_heads": 8,
              "num_kv_heads": 4, "head_dim": 16, "d_ff": 64, "moe_d_ff": 64,
              "num_experts": 8, "num_experts_per_tok": 2,
              "vocab_size": 1024, "attn_block_q": 16, "attn_block_kv": 32}
#: 1/64: 4 rows of 64 tokens, the per-row groups of the train cells (at
#: 1/128 the 32-token rows take the flattened group, whose capacity, 24,
#: counts both data ranks' tokens while each rank's buffers hold its own
#: 32: every rank runs its experts over 24 rows where the reference
#: splits them over the data axis, 1.42x its count, PERF.md §5b)
_SCALE = 1 / 64

_REF_DRY = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    sys.path.insert(0, "src")
    from repro.launch.mesh import make_test_mesh
    from repro.launch.dryrun import lower_cell
    mesh = make_test_mesh((2, 4), ("data", "model"))
    rec, _ = lower_cell("qwen3-moe-30b-a3b", "train_4k", mesh,
                        scale={_SCALE!r}, overrides={_OVERRIDES!r})
    print("RESULT::" + json.dumps(rec["roofline"]))
""")

_PORT_DRY = textwrap.dedent(f"""
    import sys, json, warnings
    warnings.filterwarnings("ignore")
    sys.path.insert(0, "src")
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    from repro_torch.launch.dryrun import lower_cell
    fake_world(8)
    mesh = make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
    rec, _ = lower_cell("qwen3-moe-30b-a3b", "train_4k", mesh,
                        scale={_SCALE!r}, overrides={_OVERRIDES!r})
    print("RESULT::" + json.dumps({{"status": rec["status"],
                                    "roofline": rec["roofline"],
                                    "memory": rec["memory"],
                                    "collectives": rec["collectives"],
                                    "kernels": rec["kernels"]}}))
""")


def test_moe_dry_run_flops_match_reference_count():
    """Global FLOPs of one train step of a small qwen3-moe cell (8
    experts, 2 on each of 4 model ranks) on a fake world of 8 ranks,
    against the reference's loop-aware count off its compiled HLO. The
    port counts the expert kernels' reported work (K1 recomputes gate and
    up, two products the reference's autodiff does not repeat) and the
    flash kernel's causal pairs."""
    ref = _result(_REF_DRY, dict(ENV, JAX_PLATFORMS="cpu"))
    got = _result(_PORT_DRY, ENV)
    assert got["status"] == "ok" and got["memory"]["fits_hbm"]
    assert {"moe_ffn_fused", "moe_gemm", "moe_ffn_fused_bwd", "moe_gemm_dx",
            "moe_gemm_dw"} <= set(got["kernels"])
    assert "all-to-all" not in got["collectives"]
    ratio = got["roofline"]["flops_global"] / ref["flops_global"]
    assert 0.9 <= ratio <= 1.1, ratio


_CELLS = textwrap.dedent("""
    import sys, json, warnings
    warnings.filterwarnings("ignore")
    sys.path.insert(0, "src")
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.sharding import SHAPES
    fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    out = {}
    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x7b"):
        for shape in SHAPES:
            rec, _ = lower_cell(arch, shape, mesh, scale=1 / 128,
                                overrides={"num_layers": 4})
            out[f"{arch} {shape}"] = {
                k: rec.get(k) for k in ("status", "reason", "collectives",
                                        "kernels", "plan_notes")}
    print("RESULT::" + json.dumps(out))
""")


def test_every_moe_cell_ok_at_small_scale():
    """Each MoE cell at 1/128 scale on the 16x16 production mesh (full
    widths, 4 layers): ``ok`` but qwen3-moe's long_500k (the sub-quadratic
    rule); expert work counted; no all-to-all; mixtral's experts on the
    expert-TP fallback."""
    got = _result(_CELLS, ENV)
    ok = {k for k, r in got.items() if r["status"] == "ok"}
    assert set(got) - ok == {"qwen3-moe-30b-a3b long_500k"}
    assert "sub-quadratic" in got["qwen3-moe-30b-a3b long_500k"]["reason"]
    for k in ok:
        assert "all-to-all" not in got[k]["collectives"], k
        assert {"moe_ffn_fused", "moe_gemm"} <= set(got[k]["kernels"]), k
        assert any("expert-TP" in n for n in got[k]["plan_notes"]) == \
            k.startswith("mixtral"), k
    assert "moe_ffn_fused_bwd" in got["qwen3-moe-30b-a3b train_4k"]["kernels"]


def test_production_distributes_moe_state(tmp_path):
    """``launch.train.train(production_mesh=True)`` on a 2x2 gloo world
    (standing in for the 16x16 mesh): the launcher plans and lays out
    qwen3-moe's smoke state itself (experts split over model, their ZeRO-3
    dim over data) and its two bf16 steps' losses are the unsharded
    launcher's within LOSS_TOL."""
    from repro_torch.launch.train import train
    inp = {"arch": "qwen3-moe-30b-a3b", "steps": 2, "batch": 4, "seq": 64}
    out = _run("production", inp, tmp_path)
    assert out["placements"]["w_gate"] == [2, 1]
    _, want = train(inp["arch"], smoke=True, steps=inp["steps"],
                    batch=inp["batch"], seq=inp["seq"], device="cpu",
                    log_every=1000)
    assert all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_TOL, atol=0)

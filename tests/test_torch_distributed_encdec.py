"""The encoder-decoder family (seamless-m4t-medium's smoke config: 2
encoder and 2 decoder layers, 4 query heads over 2 KV heads of 16, 24
source frames) on several ranks, held against the unsharded port and the
reference. Each case starts its own world of gloo ranks in a subprocess
(``tests/_torch_dist_cases.py``, OMP_NUM_THREADS=1); this process never
joins a process group.

* One ``make_train_step`` step with frames on a 2x2 data×model mesh (f32,
  2 microbatches, each taking its rows of the tokens and of the frames),
  with the KV heads split over the model axis and with one KV head (K/V
  replicated, their gradient a partial sum): against the unsharded port
  step, loss and grad norm within 1e-5, m and v within 1e-5 of each
  leaf's largest magnitude and each leaf's update within 2e-3 of the
  other's update's norm (tests/test_torch_distributed_moe.py's rule:
  AdamW's first step divides each gradient by its own magnitude); against
  the reference's jitted step (the encoder-decoder's trees are dicts, so
  its optimizer applies) by the same rules.
* Prefill of a right-padded bucket (``length`` < s) and greedy decode
  with one row inactive for two steps, on the 2x2 mesh against the
  unsharded port: tokens equal, logits and every step's cache (self K/V,
  cross K/V) within 1e-5; the inactive row's self K/V bit for bit through
  the steps it sits out, the cross K/V bit for bit through every step.
  The cross caches in the planner's layouts: split on the KV heads (2 on
  the 2-way axis), on the source slots (one KV head, 24 frames: each
  rank's partial (o, lse) merged), or whole over the model axis (one KV
  head, 17 frames, which split over no axis); with 17 frames, the KV
  heads split, too.
* The dry run's global FLOPs of a small seamless train cell (2 + 2
  layers, d 128, the config's 1536 source frames at 1/128 scale) on a
  fake world of 8 ranks (2x4) against the reference's loop-aware count
  off its compiled HLO on 8 forced host devices, within [0.9, 1.1]; the
  cell runs the flash kernel and its backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro.models.transformer import LM as JaxLM
from repro_torch import bridge
from repro_torch.models.frontends import fake_audio_frames
from repro_torch.models.transformer import LM
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from tests._torch_dist_cases import plain_rec_serve
from tests._torch_pairs import configs, weights
from tests.test_torch_distributed import ENV, _close, _result, _run
from tests.test_torch_dryrun_recurrent import _PORT_DRY, _REF_DRY

ARCH = "seamless-m4t-medium"
TOL = 1e-5          # f32: each leaf, or each logit, of its largest magnitude
STEP_REL = 2e-3     # a step's update of a leaf vs another's, of its norm
RUN_S = 300         # a case's gloo world, at most (10-20 s unloaded)


def _leaves(tree):
    return [np.asarray(t, np.float64) for t in bridge.leaves(tree)]


def _updates_close(got, want, before, what):
    for g, w, b in zip(_leaves(got), _leaves(want), _leaves(before)):
        du, dw = g - b, w - b
        assert np.linalg.norm(du - dw) <= STEP_REL * max(
            np.linalg.norm(dw), 1e-30), f"update vs {what}"


TRAIN = {"kv_heads_split": {}, "kv_replicated": {"num_kv_heads": 1}}


@pytest.mark.parametrize("case", list(TRAIN))
def test_encdec_train_step_on_2x2_matches_unsharded_and_reference(
        case, tmp_path):
    jcfg, tcfg = configs(ARCH, smoke=True)
    jcfg = dataclasses.replace(jcfg, **TRAIN[case])
    tcfg = dataclasses.replace(tcfg, **TRAIN[case])
    jstate = jax_ts.init_train_state(JaxLM(jcfg), jax.random.key(0))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1),
             "frames": fake_audio_frames(
                 tcfg, torch.Generator().manual_seed(8), 4).numpy()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = _run("train", {"cfg": tcfg, "batch": tbatch,
                         "state": bridge.train_state_to_torch(jstate,
                                                              "cpu")},
               tmp_path, timeout=RUN_S)
    plain, pm = ts.make_train_step(
        LM(tcfg), hyper=opt.AdamWHyper(warmup_steps=1), microbatches=2,
        compute_dtype=torch.float32)(
            bridge.train_state_to_torch(jstate, "cpu"), tbatch)
    jnew, jm = jax.jit(jax_ts.make_train_step(
        JaxLM(jcfg), hyper=jax_opt.AdamWHyper(warmup_steps=1),
        microbatches=2, compute_dtype=jnp.float32))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    before = bridge.train_state_to_numpy(jstate)["params"]
    for want, metrics, name in (
            (bridge.train_state_to_numpy(plain), pm, "unsharded port"),
            (bridge.train_state_to_numpy(jnew), jm, "reference")):
        _close(out["m"], want["opt"]["m"], f"m vs {name}")
        _close(out["v"], want["opt"]["v"], f"v vs {name}")
        _updates_close(out["params"], want["params"], before, name)
        for k in ("loss", "grad_norm"):
            w = float(metrics[k])
            assert abs(out[k] - w) <= TOL * max(1.0, abs(w)), (k, name)
    # the query heads split over the model axis: no sequence-parallel
    # fallback; with one KV head the planner notes its head-count fallback
    assert out["qwhole"] == 0
    assert any("head-count fallback" in n for n in out["notes"]) == \
        (case == "kv_replicated")


#: case: (overrides, frames, their dims split by (data, model) in the
#: cross caches [L, b, src, kh, hd])
SERVE = {"kv_heads_split": ({}, 24, [1, 3]),
         "frames_17": ({}, 17, [1, 3]),
         "src_split": ({"num_kv_heads": 1}, 24, [1, 2]),
         "src_whole": ({"num_kv_heads": 1}, 17, [1, None])}


@pytest.mark.parametrize("case", list(SERVE))
def test_encdec_prefill_and_decode_on_2x2_match_unsharded(case, tmp_path):
    """4 rows of a 12-token bucket holding 9 prompt tokens, a 32-row
    cache, 6 greedy steps, row 1 inactive in steps 2 and 3."""
    over, src, cross_dims = SERVE[case]
    jcfg, tcfg = configs(ARCH, smoke=True)
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(tcfg, **over)
    _, params = weights(jcfg, tcfg)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (4, 12)).astype(np.int32))
    frames = fake_audio_frames(tcfg, torch.Generator().manual_seed(12),
                               4, src)
    length, max_len, steps, inactive = 9, 32, 6, (1, (2, 3))
    out = _run("rec_serve", {"cfg": tcfg, "params": params,
                             "tokens": tokens, "frames": frames,
                             "length": length, "max_len": max_len,
                             "steps": steps, "inactive": inactive},
               tmp_path, timeout=RUN_S)
    logits, toks, caches = plain_rec_serve(tcfg, params, tokens, length,
                                           max_len, steps, inactive, frames)
    for got, want in zip(out["tokens"], toks):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(out["logits"], logits):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for got, want in zip(out["caches"], caches):
        for g, w in zip(bridge.leaves(got), bridge.leaves(want)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=TOL * max(
                float(np.abs(w).max()), 1.0), rtol=0)
    assert out["caches"][0]["cross_k"].shape[2] == src
    # the inactive row's self K/V bit for bit through the steps it sits
    # out; the cross K/V through every step
    row, quiet = inactive
    for i in quiet:
        for key in ("k", "v"):
            np.testing.assert_array_equal(
                out["caches"][i + 1]["layers"][key][:, row],
                out["caches"][i]["layers"][key][:, row])
    for c in out["caches"][1:]:
        for key in ("cross_k", "cross_v"):
            np.testing.assert_array_equal(c[key], out["caches"][0][key])
    # the layouts: the batch over data; the self K/V's KV heads, or S where
    # one KV head does not split, over model; the cross K/V as the planner
    # lays them out
    seq = tcfg.num_kv_heads == 1
    assert out["layout"] == {"k": [1, 2 if seq else 3],
                             "v": [1, 2 if seq else 3]}
    assert out["cross_layout"] == {"cross_k": cross_dims,
                                   "cross_v": cross_dims}
    L = tcfg.num_layers
    # the masked decodes are the cross attention's (the self
    # attention's go through the decode kernel)
    assert out["calls"]["masked"] == steps * L
    assert out["calls"]["seq"] == (steps * L if seq else 0)


#: the small cell (the reference test's sizes): 2 of its 8 heads a rank on
#: the 4-way model axis, 12 source frames at 1/128
SMALL = {ARCH: {"num_layers": 2, "encoder_layers": 2, "d_model": 128,
                "num_heads": 8, "num_kv_heads": 8, "head_dim": 16,
                "d_ff": 256, "vocab_size": 1024, "attn_block_q": 16,
                "attn_block_kv": 32}}


def test_encdec_dry_run_flops_match_reference_count():
    """The port's flash kernel counts the pairs it computes; the
    reference's blocked attention computes whole blocks, 12 frames padded
    to a 32-key block, so the port's count is a little lower."""
    ref = _result(_REF_DRY.format(small=SMALL), dict(ENV, JAX_PLATFORMS="cpu"))
    got = _result(_PORT_DRY.format(small=SMALL), ENV)[ARCH]
    assert got["status"] == "ok" and got["memory"]["fits_hbm"]
    assert set(got["kernels"]) == {"flash_attention", "flash_attention_bwd"}
    ratio = got["roofline"]["flops_global"] / ref[ARCH]
    assert 0.9 <= ratio <= 1.1, ratio

"""The recurrent families on several ranks, held against the unsharded
port and the reference: recurrentgemma-2b's RG-LRU blocks (hybrid) and
mamba2-1.3b's SSD layers (SSM). Each case starts its own world of gloo
ranks in a subprocess (``tests/_torch_dist_cases.py``, OMP_NUM_THREADS=1);
this process never joins a process group.

* One ``make_train_step`` step of each smoke config on a 2x2 data×model
  mesh (f32, 2 microbatches), mamba2's with one group of B and C (every
  model rank handed group 0 for its 4 of 8 heads, their gradients partial
  sums) and with two (the groups split with the heads): against the
  unsharded port step, m and v within 1e-5 of each leaf's largest
  magnitude and each leaf's update within 2e-3 of the other's update's
  norm (the rule of tests/test_torch_distributed_moe.py: AdamW's first
  step divides each gradient by its own magnitude); against the
  reference's loss and gradients (``jax.value_and_grad`` of its loss over
  the batch): loss and grad norm within 1e-5, m within 1e-5 of each
  leaf's largest of 0.1 g clipped at norm 1, AdamW's first moment. The
  hybrid's update is held to the unsharded port only: the reference's
  optimizer mangles its tuple of layers (ROADMAP.md §3).
* The scan kernels' DTensor routes (``kernels.sharded.scan_layout``) on
  the 2x2 mesh against their plain versions, forward, backward by
  autograd and the backward wrappers on DTensors, f64, B and C of one to
  four groups.
* Prefill and greedy decode on the 2x2 mesh against the unsharded port: a
  right-padded bucket (``length`` < s; the hybrid's prompt past its
  16-token window, so its ring, split on S, wraps), one row inactive for
  two steps, whose conv, ``h``, SSM state and ring stay bit for bit:
  tokens equal, logits and every step's cache within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import train_step as jax_ts
from repro.models.transformer import LM as JaxLM
from repro_torch import bridge
from repro_torch.models.transformer import LM
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from tests._torch_dist_cases import plain_rec_serve
from tests._torch_pairs import configs, weights
from tests.test_torch_distributed import _close, _run

TOL = 1e-5          # f32: each leaf, or each logit, of its largest magnitude
STEP_REL = 2e-3     # a step's update of a leaf vs the unsharded port's, of
#                     its norm (tests/test_torch_distributed_moe.py)
RUN_S = 300         # a case's gloo world, at most (10-25 s unloaded)

#: case: (arch, overrides)
TRAIN = {"hybrid": ("recurrentgemma-2b", {}),
         "ssm": ("mamba2-1.3b", {}),
         "ssm_groups": ("mamba2-1.3b", {"ssm_ngroups": 2})}


def test_scan_kernels_dtensor_routes_match_plain_on_2x2(tmp_path):
    """``ssd_chunk`` and ``rglru_scan`` on DTensors (batch over data,
    heads or channels over model; f64, their plain versions on the CPU
    shards) against the plain calls: outputs, every input's gradient by
    autograd and the backward wrappers called on DTensors, within 1e-12.
    The SSD's B and C: one group (each rank handed group 0, a slice), two
    and four (split with the heads), and three groups of two heads over
    six heads (a rank's three heads cut a group: one group a head, a
    tensor of indices)."""
    out = _run("scans", {"ssd": [(1, 8), (2, 8), (4, 8), (3, 6)]}, tmp_path,
               timeout=RUN_S)
    for case, errs in out.items():
        for k in ("forward", "grads", "bwd"):
            assert errs[k] <= 1e-12, (case, k, errs[k])
    assert out["ssd g 1 nh 8"]["sel"] == "slice(0, 1, None)"
    assert out["ssd g 2 nh 8"]["sel"] == "None"
    assert out["ssd g 3 nh 6"]["sel"].startswith("tensor(")


def _leaves(tree):
    return [np.asarray(t, np.float64) for t in bridge.leaves(tree)]


@pytest.mark.parametrize("case", list(TRAIN))
def test_recurrent_train_step_on_2x2_matches_unsharded_and_reference(
        case, tmp_path):
    arch, over = TRAIN[case]
    jcfg, tcfg = configs(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(tcfg, **over)
    jstate = jax_ts.init_train_state(JaxLM(jcfg), jax.random.key(0))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = _run("train", {"cfg": tcfg, "batch": tbatch,
                         "state": bridge.train_state_to_torch(jstate,
                                                              "cpu")},
               tmp_path, timeout=RUN_S)
    plain, pm = ts.make_train_step(
        LM(tcfg), hyper=opt.AdamWHyper(warmup_steps=1), microbatches=2,
        compute_dtype=torch.float32)(
            bridge.train_state_to_torch(jstate, "cpu"), tbatch)
    plain = bridge.train_state_to_numpy(plain)
    _close(out["m"], plain["opt"]["m"], "m vs unsharded port")
    _close(out["v"], plain["opt"]["v"], "v vs unsharded port")
    before = _leaves(bridge.train_state_to_numpy(jstate)["params"])
    for g, w, b in zip(_leaves(out["params"]), _leaves(plain["params"]),
                       before):
        du, dw = g - b, w - b
        assert np.linalg.norm(du - dw) <= STEP_REL * max(
            np.linalg.norm(dw), 1e-30), "update vs unsharded port"
    for k in ("loss", "grad_norm"):
        assert abs(out[k] - float(pm[k])) <= TOL * max(1.0, abs(float(
            pm[k]))), k
    # the reference: loss and gradients of the batch, through AdamW's
    # first moment
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JaxLM(jcfg).loss(p, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True))(jstate.params)
    grads = [np.asarray(g, np.float64) for g in jax.tree.leaves(jgrads)]
    gn = float(np.sqrt(sum(float((g * g).sum()) for g in grads)))
    assert abs(out["loss"] - float(jloss)) <= TOL * max(1.0, abs(
        float(jloss)))
    assert abs(out["grad_norm"] - gn) <= TOL * max(1.0, gn)
    scale = 0.1 * min(1.0, 1.0 / max(gn, 1e-12))
    got = _leaves(out["m"])
    assert len(got) == len(grads)
    for i, (m, g) in enumerate(zip(got, grads)):
        want = scale * g
        assert np.abs(m - want).max() <= TOL * max(np.abs(want).max(),
                                                   1e-30), f"m leaf {i}"
    # every scan ran through its DTensor route: 2 microbatches
    kernel = "rglru_scan" if case == "hybrid" else "ssd_chunk"
    layers = tcfg._pattern().count("rec") if case == "hybrid" \
        else tcfg.num_layers
    assert out["calls"][kernel] == 2 * layers


#: case: (arch, overrides, prompt tokens, true length, max_len, steps,
#: (inactive row, the steps it sits out))
SERVE = {"hybrid": ("recurrentgemma-2b", {}, 40, 35, 64, 12, (1, (3, 4))),
         "ssm": ("mamba2-1.3b", {}, 24, 19, 32, 8, (2, (2, 3))),
         "ssm_groups": ("mamba2-1.3b", {"ssm_ngroups": 2}, 24, 21, 32, 6,
                        (0, (1, 2)))}


@pytest.mark.parametrize("case", list(SERVE))
def test_recurrent_prefill_and_decode_on_2x2_match_unsharded(case,
                                                             tmp_path):
    arch, over, s, length, max_len, steps, inactive = SERVE[case]
    jcfg, tcfg = configs(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(tcfg, **over)
    _, params = weights(jcfg, tcfg)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (4, s)).astype(np.int32))
    out = _run("rec_serve", {"cfg": tcfg, "params": params,
                             "tokens": tokens, "length": length,
                             "max_len": max_len, "steps": steps,
                             "inactive": inactive}, tmp_path,
               timeout=RUN_S)
    logits, toks, caches = plain_rec_serve(tcfg, params, tokens, length,
                                           max_len, steps, inactive)
    for got, want in zip(out["tokens"], toks):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(out["logits"], logits):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for got, want in zip(out["caches"], caches):
        for g, w in zip(bridge.leaves(got), bridge.leaves(want)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=TOL * max(
                float(np.abs(w).max()), 1.0), rtol=0)
    # the inactive row's state: bit for bit through the steps it sits out
    row, quiet = inactive
    stacked = case != "hybrid"          # [L, b, ...] against [b, ...]
    for i in quiet:
        for before, after in zip(bridge.leaves(out["caches"][i]),
                                 bridge.leaves(out["caches"][i + 1])):
            sel = (slice(None), row) if stacked else (row,)
            np.testing.assert_array_equal(after[sel], before[sel])
    calls = out["calls"]
    if case == "hybrid":
        pattern = tcfg._pattern()
        assert calls["rglru_scan"] == pattern.count("rec")
        assert calls["banded"] == pattern.count("attn")
        assert calls["ring"] == steps * pattern.count("attn")
        # the rings split on S (one KV head on a 2-way axis), the states
        # on w; the batch over data throughout
        for layer, kind in zip(out["layout"], pattern):
            if kind == "rec":
                assert layer == {"conv": [0, 2], "h": [0, 1]}
            else:
                assert layer == {"k": [0, 1], "v": [0, 1]}
    else:
        assert calls["ssd_chunk"] == tcfg.num_layers
        # [L, b, K-1, conv_dim] on its channels, [L, b, nh, hp, n] on heads
        assert out["layout"] == {"conv": [1, 3], "ssm": [1, 2]}

"""The port's distribution layer on several ranks, held against the
unsharded port and the reference: each case starts its own world of gloo
ranks in a subprocess (``tests/_torch_dist_cases.py``, OMP_NUM_THREADS=1);
this process never joins a process group.

* One ``make_train_step`` step on a 2x2 data×model mesh against the
  unsharded port step and the reference's, f32, each leaf within 1e-5 of
  its largest magnitude: a config whose heads split over the model axis,
  one whose heads do not (``qwhole_attention``), and one whose two query
  heads a rank fall inside one KV group (GQA under head splitting).
* A prefill and greedy decode steps on the 2x2 mesh against the unsharded
  port: with the cache split on S (a shard holding no valid row while the
  positions stay in the first half) and split on KV heads: tokens equal,
  logits within 1e-5.
* ``pipeline_forward`` on 4 ranks against the sequential loop in torch
  and in jnp, 1e-5 (the reference's tests/test_pipeline.py sizes).
* The dry run's FLOP count of a small dense train cell on a fake 2x4
  world against the reference's loop-aware HLO count on 8 forced host
  devices, within [0.9, 1.1].
* The training launcher's ``--production`` under ``torchrun`` with too
  few ranks, and outside ``torchrun``: both raise, naming what they
  need."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro.models.transformer import LM as JaxLM
from repro_torch import bridge
from repro_torch.models.transformer import LM
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from tests._torch_pairs import configs, weights

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
TOL = 1e-5


def _run(case, inp, folder, world=4, timeout=120):
    torch.save(inp, folder / "in.pt")
    r = subprocess.run([sys.executable, "-m", "tests._torch_dist_cases",
                        case, str(folder), str(world)], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return torch.load(folder / "out.pt", weights_only=False)


def _close(got, want, what):
    """Each leaf within TOL of its largest magnitude."""
    for g, w in zip(bridge.leaves(got), bridge.leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, what
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= TOL * scale, what


TRAIN = {"heads": {},
         "qwhole": {"num_heads": 3, "num_kv_heads": 1},
         "kv_group_split": {"num_kv_heads": 1}}


@pytest.mark.parametrize("case", list(TRAIN))
def test_train_step_on_2x2_matches_unsharded_and_reference(case, tmp_path):
    import dataclasses
    jcfg, tcfg = configs("minitron-8b", smoke=True)
    jcfg = dataclasses.replace(jcfg, **TRAIN[case])
    tcfg = dataclasses.replace(tcfg, **TRAIN[case])
    jstate = jax_ts.init_train_state(JaxLM(jcfg), jax.random.key(0))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
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
    for want, name in ((plain, "unsharded port"), (ref, "reference")):
        _close(out["params"], want["params"], f"params vs {name}")
        _close(out["m"], want["opt"]["m"], f"m vs {name}")
        _close(out["v"], want["opt"]["v"], f"v vs {name}")
    for k, got in (("loss", out["loss"]), ("grad_norm", out["grad_norm"])):
        for want in (float(pm[k]), float(jm[k])):
            assert abs(got - want) <= TOL * max(1.0, abs(want)), k
    assert (out["qwhole"] > 0) == (case == "qwhole")
    assert any("head-count fallback" in n for n in out["notes"]) == \
        (case != "heads")


SERVE = {"seq_sharded": {"num_kv_heads": 1},
         "heads": {},
         "qwhole_seq_sharded": {"num_heads": 3, "num_kv_heads": 1}}


@pytest.mark.parametrize("case", list(SERVE))
def test_prefill_and_decode_on_2x2_match_unsharded(case, tmp_path):
    """4 rows of 8 prompt tokens in a 32-row cache, 6 greedy steps: with
    the cache split on S over 2 ranks, the second half never holds a
    valid row (lse -inf, weight 0) while every step merges both."""
    import dataclasses
    jcfg, tcfg = configs("minitron-8b", smoke=True)
    jcfg = dataclasses.replace(jcfg, **SERVE[case])
    tcfg = dataclasses.replace(tcfg, **SERVE[case])
    _, params = weights(jcfg, tcfg)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (4, 8)).astype(np.int32))
    steps, max_len = 6, 32
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
    seq = case != "heads"
    assert (out["seq_sharded"] == steps * tcfg.num_layers) == seq
    # [L, b, S, kh, hd]: the batch over data, S or the KV heads over model
    assert out["cache_layout"] == ([1, 2] if seq else [1, 3])


def test_pipeline_matches_sequential(tmp_path):
    L, D, M, mb = 8, 32, 6, 4      # 8 layers over 4 stages, 6 microbatches
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((M, mb, D)).astype(np.float32)
    out = _run("pipeline", {"w": torch.from_numpy(w),
                            "x": torch.from_numpy(x)}, tmp_path)["out"]
    seq_t, seq_j = torch.from_numpy(x), jnp.asarray(x)
    for i in range(L):
        seq_t = torch.tanh(seq_t @ torch.from_numpy(w[i]))
        seq_j = jnp.tanh(seq_j @ jnp.asarray(w[i]))
    np.testing.assert_allclose(out, seq_t.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(out, np.asarray(seq_j), atol=TOL, rtol=0)


_OVERRIDES = {"num_layers": 2, "d_model": 128, "num_heads": 8,
              "num_kv_heads": 8, "head_dim": 16, "d_ff": 256,
              "vocab_size": 1024, "attn_block_q": 16, "attn_block_kv": 32}

_REF_DRY = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    sys.path.insert(0, "src")
    from repro.launch.mesh import make_test_mesh
    from repro.launch.dryrun import lower_cell
    mesh = make_test_mesh((2, 4), ("data", "model"))
    rec, _ = lower_cell("codeqwen1.5-7b", "train_4k", mesh, scale=1/128,
                        overrides={_OVERRIDES!r})
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
    rec, _ = lower_cell("codeqwen1.5-7b", "train_4k", mesh, scale=1/128,
                        overrides={_OVERRIDES!r})
    print("RESULT::" + json.dumps({{"status": rec["status"],
                                    "roofline": rec["roofline"],
                                    "memory": rec["memory"]}}))
""")


def _result(script, env):
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT::")]
    assert line, r.stdout[-2000:]
    return json.loads(line[0][8:])


def test_dry_run_flops_match_reference_count():
    """Global FLOPs of one train step of the small codeqwen cell (the
    reference test's overrides, 1/128 scale) on a fake world of 8 ranks,
    against the reference's loop-aware count off its compiled HLO. A known
    difference pulls the port's count down a little: its flash kernel
    counts the causal (query, key) pairs, the reference's blocked attention
    computes every block."""
    ref = _result(_REF_DRY, dict(ENV, JAX_PLATFORMS="cpu"))
    got = _result(_PORT_DRY, ENV)
    assert got["status"] == "ok" and got["memory"]["fits_hbm"]
    ratio = got["roofline"]["flops_global"] / ref["flops_global"]
    assert 0.9 <= ratio <= 1.1, ratio


@pytest.mark.parametrize("torchrun", [True, False])
def test_production_launcher_raises_without_its_ranks(torchrun):
    """``--production`` builds the 16x16 production mesh over the ranks
    torchrun launched: with 2 it raises, naming the 256 it needs and how
    to launch them; outside torchrun it raises, naming torchrun."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = ["-m", "repro_torch.launch.train", "--arch", "edge-tiny",
           "--smoke", "--steps", "1", "--batch", "2", "--seq", "16",
           "--device", "cpu", "--production"]
    if torchrun:
        cmd = ["-m", "torch.distributed.run", "--nproc-per-node=2",
               f"--master-port={port}", "--master-addr=localhost"] + cmd
    r = subprocess.run([sys.executable] + cmd, cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    want = "need 256 ranks" if torchrun else "runs under torchrun"
    assert want in r.stderr, r.stderr[-2000:]

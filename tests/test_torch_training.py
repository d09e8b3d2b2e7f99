"""Training in the port against the reference package, on the CPU.

* ``LM.loss`` and every gradient leaf against ``jax.value_and_grad`` of the
  reference's ``LM.loss``, on the reference's weights through the bridge,
  in f32, for each family: dense (edge-tiny's smoke config, with remat
  none, dots and full), MoE (with its aux loss), hybrid, SSM, encdec (with
  ``frames``) and qwen2-vl (``vision_embeds`` and [3, b, s] positions),
  the cross-entropy in three chunks. Loss within 1e-5; each gradient leaf
  within 5e-5 of its largest magnitude (the same f32 arithmetic in two
  frameworks, summed in another order: the worst leaf measured 4e-6).
  Remat changes no value: the port's gradients under none, dots and full
  are equal bit for bit, at 48 layers (√L groups) too.
* Two ``make_train_step`` steps against the reference's, f32 compute, with
  microbatches 1 and 2 and with int8 compression, at a one-step warmup
  (so the first update moves each parameter by ~lr, 3e-4): each leaf's
  update (params after - before), m and v within 2e-3 of the leaf's
  norm (measured: 7e-5 without compression, 5e-4 with it, where a
  gradient on an int8 rounding boundary may round the other way after a
  last-bit difference), the metrics within 1e-5. With compression, the
  error-feedback residual within 1e-5 but at up to 0.1% of a leaf's
  elements: such a flip moves its residual by one int8 step.
* ``lr_at`` (within 1e-6 relative: XLA's and torch's f32 cos differ in
  the last bit), global-norm clipping, ``adamw_update`` and
  ``compress_tree`` against the reference (compression bit for bit, on a
  tree of dicts: the reference's ``compress_tree`` takes a tuple node for
  a leaf).
* Checkpoints cross: the reference's restored by the port and the port's by
  the reference, bit for bit; a corrupt shard, a missing leaf and a wrong
  shape are refused.
* The port's launcher trains edge-tiny on the CPU with a falling loss, and
  10 steps then 10 resumed from the checkpoint equal 20 straight (its
  smoke config).
* ``param_specs`` gives the reference's shapes and dtypes; the kernels
  without a backward (and the expert kernels' int8-weight variant) refuse
  to run under autograd off the CPU, and the expert kernels' bf16 route
  reaches its ``torch.autograd.Function`` there instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import LM as JaxLM
from repro.training import checkpoint as jax_ckpt
from repro.training import compression as jax_comp
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch import bridge
from repro_torch.kernels.decode_attention import decode_attention as DA
from repro_torch.kernels.moe_gemm import moe_gemm as MG
from repro_torch.kernels.rglru_scan import rglru_scan as RS
from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
from repro_torch.launch.train import train
from repro_torch.models.transformer import LM
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression as comp
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from tests._torch_pairs import configs, weights

LOSS_TOL = 1e-5
GRAD_REL = 5e-5
STEP_TOL = 1e-5
STEP_REL = 2e-3     # a leaf's update, m and v, of the leaf's norm
EF_FLIPS = 1e-3     # share of a residual leaf whose int8 rounding may flip


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread inside each test, the worker's count
    restored after it: these tests run many small ops, which under a
    parallel test run's oversubscribed cores spend their time in thread
    hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _batch(jcfg, b, s, seed, extra=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 3] = -1
    batch = {"tokens": toks, "labels": labels}
    if extra == "frames":
        batch["frames"] = rng.standard_normal(
            (b, 24, jcfg.d_model)).astype(np.float32)
    elif extra == "vision":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        pos[1, :, :8] = np.arange(8) // 4       # a 2 x 4 image grid
        pos[2, :, :8] = np.arange(8) % 4
        batch["positions"] = pos
        batch["vision_embeds"] = rng.standard_normal(
            (b, 8, jcfg.d_model)).astype(np.float32)
    return batch


def _port_loss_and_grads(tcfg, params, batch, ce_chunk):
    for p in bridge.leaves(params):
        p.requires_grad_(True)
    loss, metrics = LM(tcfg).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()},
        ce_chunk=ce_chunk)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in bridge.leaves(params)]
    return loss, metrics, grads


FAMILIES = [   # arch, seq, extra input, remat
    ("edge-tiny", 48, None, "none"),
    ("edge-tiny", 48, None, "dots"),
    ("edge-tiny", 48, None, "full"),
    ("qwen3-moe-30b-a3b", 64, None, "none"),
    ("recurrentgemma-2b", 48, None, "none"),
    ("mamba2-1.3b", 48, None, "none"),
    ("seamless-m4t-medium", 48, "frames", "none"),
    ("qwen2-vl-72b", 48, "vision", "none"),
]


@pytest.mark.parametrize("arch,s,extra,remat", FAMILIES, ids=str)
def test_loss_and_gradients_match_reference(arch, s, extra, remat):
    jcfg, tcfg = configs(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    jp, tp = weights(jcfg, tcfg)
    batch = _batch(jcfg, 2, s, seed=len(arch), extra=extra)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JaxLM(jcfg).loss(p, jbatch, ce_chunk=16),
        has_aux=True))(jp)
    loss, metrics, grads = _port_loss_and_grads(tcfg, tp, batch, 16)
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    assert abs(metrics["aux"].item() - float(jm["aux"])) <= LOSS_TOL
    assert metrics["ntok"].item() == float(jm["ntok"])
    if arch.startswith("qwen3-moe"):
        assert metrics["aux"].item() > 0
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    assert len(jleaves) == len(grads)
    for i, (g, w) in enumerate(zip(grads, jleaves)):
        bound = GRAD_REL * max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= bound, f"leaf {i}"


@pytest.mark.parametrize("layers", [2, 48])
def test_remat_changes_no_gradient(layers):
    """Bit for bit, also at 48 layers, where the stack is checkpointed in
    √L groups as well (the reference's two-level scan)."""
    jcfg, tcfg = configs("edge-tiny", smoke=True)
    batch = _batch(jcfg, 2, 32, seed=3)
    out = {}
    for remat in ("none", "dots", "full") if layers < 48 else ("none",
                                                              "full"):
        cfg = dataclasses.replace(tcfg, remat=remat, num_layers=layers)
        tp = LM(cfg).init(0, device="cpu")
        out[remat] = _port_loss_and_grads(cfg, tp, batch, 16)
    for remat in out:
        assert torch.equal(out[remat][0], out["none"][0])
        for g, w in zip(out[remat][2], out["none"][2]):
            assert torch.equal(g, w), remat


def test_forward_logits_match_reference():
    jcfg, tcfg = configs("edge-tiny", smoke=True)
    jp, tp = weights(jcfg, tcfg)
    batch = _batch(jcfg, 2, 24, seed=4)
    jl, _ = JaxLM(jcfg).forward(jp, {"tokens": jnp.asarray(batch["tokens"])})
    with torch.no_grad():
        tl, aux = LM(tcfg).forward(
            tp, {"tokens": torch.from_numpy(batch["tokens"])})
    assert tl.dtype == torch.float32 and aux.item() == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["edge-tiny", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-2b", "seamless-m4t-medium",
                                  "qwen2-vl-72b"])
def test_param_specs_have_the_reference_shapes_and_dtypes(arch):
    jcfg, tcfg = configs(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    want = jax.tree.leaves(JaxLM(jcfg).param_specs())
    got = bridge.leaves(LM(tcfg).param_specs())
    assert [tuple(w.shape) for w in want] == [tuple(g.shape) for g in got]
    assert [str(w.dtype) for w in want] == \
        [str(g.dtype).replace("torch.", "") for g in got]
    assert all(g.device.type == "meta" for g in got)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(bridge.leaves(a), bridge.leaves(b)))


def _max_rel(a, b, base=None):
    """The largest ``||a - b|| / ||b||`` over the leaves, each leaf taken
    as its change from ``base`` where one is given."""
    out = []
    for i, (x, y) in enumerate(zip(bridge.leaves(a), bridge.leaves(b))):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if base is not None:
            z = np.asarray(bridge.leaves(base)[i], np.float64)
            x, y = x - z, y - z
        out.append(np.linalg.norm(x - y) / np.linalg.norm(y))
    return max(out)


@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (2, True)])
def test_train_step_matches_reference(microbatches, compress):
    jcfg, tcfg = configs("edge-tiny", smoke=True)
    jstate = jax_ts.init_train_state(JaxLM(jcfg), jax.random.key(0),
                                     compress=compress)
    state = bridge.train_state_to_torch(jstate, "cpu")
    before = bridge.train_state_to_numpy(jstate)["params"]
    jstep = jax.jit(jax_ts.make_train_step(
        JaxLM(jcfg), hyper=jax_opt.AdamWHyper(warmup_steps=1),
        microbatches=microbatches, compress=compress,
        compute_dtype=jnp.float32))
    step = ts.make_train_step(LM(tcfg), hyper=opt.AdamWHyper(warmup_steps=1),
                              microbatches=microbatches, compress=compress,
                              compute_dtype=torch.float32)
    for seed in (9, 10):
        batch = _batch(jcfg, 4, 32, seed=seed)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    want = bridge.train_state_to_numpy(jstate)
    got = bridge.train_state_to_numpy(state)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 2
    assert _max_rel(got["params"], want["params"], before) <= STEP_REL
    assert _max_rel(got["opt"]["m"], want["opt"]["m"]) <= STEP_REL
    assert _max_rel(got["opt"]["v"], want["opt"]["v"]) <= STEP_REL
    for k in ("loss", "grad_norm", "step"):
        assert abs(m[k].item() - float(jm[k])) <= STEP_TOL * max(
            1.0, abs(float(jm[k]))), k
    if compress:
        for e, w in zip(bridge.leaves(got["ef"]), bridge.leaves(want["ef"])):
            assert np.mean(np.abs(e - w) > STEP_TOL) <= EF_FLIPS
    else:
        assert got["ef"] is None


def test_optimizer_pieces_match_reference():
    h = jax_opt.AdamWHyper(warmup_steps=10, total_steps=50)
    th = opt.AdamWHyper(warmup_steps=10, total_steps=50)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        want = float(jax_opt.lr_at(h, jnp.asarray(step, jnp.int32)))
        got = opt.lr_at(th, torch.tensor(step, dtype=torch.int32)).item()
        assert abs(got - want) <= 1e-6 * want, step
    rng = np.random.default_rng(2)
    tree = {"b": rng.standard_normal((5, 7)).astype(np.float32) * 3,
            "a": {"y": rng.standard_normal(6).astype(np.float32),
                  "x": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    jt = jax.tree.map(jnp.asarray, tree)
    for max_norm in (1.0, 100.0):     # the port's clips its argument
        jc, jn = jax_opt.clip_by_global_norm(jt, max_norm)
        tc, tn = opt.clip_by_global_norm(bridge.tree_to_torch(tree),
                                         max_norm)
        assert abs(tn.item() - float(jn)) <= 1e-6 * float(jn)
        assert _max_diff(bridge.tree_to_numpy(tc),
                         jax.tree.map(np.asarray, jc)) <= 1e-6
    params = jax.tree.map(lambda x: x * 0.5, jt)
    jstate = jax_opt.adamw_init(params)
    tparams = bridge.tree_to_torch(jax.tree.map(np.asarray, params))
    tstate = opt.adamw_init(tparams)
    for _ in range(3):
        params, jstate, _ = jax_opt.adamw_update(jt, jstate, params, h)
        tparams, tstate, _ = opt.adamw_update(bridge.tree_to_torch(tree),
                                              tstate, tparams, th)
    assert _max_diff(bridge.tree_to_numpy(tparams),
                     jax.tree.map(np.asarray, params)) <= 1e-6
    assert _max_diff(bridge.tree_to_numpy(tstate["v"]),
                     jax.tree.map(np.asarray, jstate["v"])) <= 1e-6


def test_tuple_nodes_are_walked_not_taken_for_leaves():
    """The hybrid family's params hold their layers in a tuple. The
    reference's ``adamw_update`` and ``compress_tree`` unzip their per-leaf
    results with ``is_leaf=isinstance(x, tuple)``, which also stops at that
    tuple (ROADMAP.md §3); the port walks it: the same update as with the
    layers keyed by index in a dict."""
    rng = np.random.default_rng(6)
    a, b = (rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2))
    n = rng.standard_normal(4).astype(np.float32)
    as_tuple = {"layers": (a, {"n": n}), "w": b}
    as_dict = {"layers": {"0": a, "1": {"n": n}}, "w": b}
    out, news = [], []
    for tree in (as_tuple, as_dict):
        params = bridge.tree_to_torch(tree)
        grads = bridge.tree_map(lambda x: x * 0.3, params)
        state = opt.adamw_init(params)
        new, state, gn = opt.adamw_update(grads, state, params,
                                          opt.AdamWHyper())
        g, ef = comp.compress_tree(grads, bridge.tree_map(torch.zeros_like,
                                                          grads))
        out.append([bridge.leaves(x) for x in (new, state["m"], state["v"],
                                               g, ef)] + [[gn]])
        news.append(new)
    assert isinstance(news[0]["layers"], tuple)
    for got, want in zip(*out):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_compress_tree_matches_reference_bit_for_bit():
    rng = np.random.default_rng(5)
    grads = {"w": rng.standard_normal((8, 16)).astype(np.float32),
             "n": rng.standard_normal(16).astype(np.float32),
             "t": {"u": rng.standard_normal((3, 4, 5)).astype(np.float32)
                   * 1e-3}}
    ef = jax.tree.map(lambda x: (x * 0.01).astype(np.float32), grads)
    jg, je = jax_comp.compress_tree(jax.tree.map(jnp.asarray, grads),
                                    jax.tree.map(jnp.asarray, ef))
    tg, te = comp.compress_tree(bridge.tree_to_torch(grads),
                                bridge.tree_to_torch(ef))
    for a, b in ((tg, jg), (te, je)):
        for x, y in zip(bridge.leaves(bridge.tree_to_numpy(a)),
                        jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, np.asarray(y))
    q, s = comp.quantize(torch.tensor([[0.5, -1.5, 2.5, 127.0]]))
    assert q.tolist() == [[0, -2, 2, 127]] and s.item() == 1.0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _states():
    """A reference train state with every leaf set (moments and residual
    drawn, step 3) and the same state in the port."""
    jcfg, _ = configs("edge-tiny", smoke=True)
    jstate = jax_ts.init_train_state(JaxLM(jcfg), jax.random.key(1),
                                     compress=True)
    rng = np.random.default_rng(1)

    def draw(scale):
        return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32) * scale), jstate.params)
    jstate = jax_ts.TrainState(
        jstate.params, {"m": draw(0.1), "v": draw(0.01),
                        "step": jnp.asarray(3, jnp.int32)}, draw(1e-3))
    return jcfg, jstate, bridge.train_state_to_torch(jstate, "cpu")


def _equal(a, b):
    for x, y in zip(bridge.leaves(a), bridge.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_checkpoints_cross_between_the_packages(tmp_path):
    jcfg, jstate, state = _states()
    _, tcfg = configs("edge-tiny", smoke=True)
    like = ts.init_train_state(LM(tcfg), 0, compress=True, device="meta")
    jax_ckpt.save(str(tmp_path / "ref"), 1, jstate, extra={"data_step": 3})
    got, extra = ckpt.restore(str(tmp_path / "ref"), 1, like, device="cpu")
    assert extra == {"data_step": 3} and isinstance(got, ts.TrainState)
    _equal(bridge.train_state_to_numpy(got),
           bridge.train_state_to_numpy(jstate))

    ckpt.save(str(tmp_path / "port"), 1, state, extra={"data_step": 4})
    jlike = jax.eval_shape(lambda k: jax_ts.init_train_state(
        JaxLM(jcfg), k, compress=True), jax.random.key(0))
    back, extra = jax_ckpt.restore(str(tmp_path / "port"), 1, jlike)
    assert extra == {"data_step": 4}
    _equal(bridge.train_state_to_numpy(back),
           bridge.train_state_to_numpy(state))
    assert ckpt.latest_step(str(tmp_path / "port")) == 1
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_refuses_corruption_and_drift(tmp_path):
    _, _, state = _states()
    d = str(tmp_path)
    path = ckpt.save(d, 2, state) + "/shard_0.npz"
    _, tcfg = configs("edge-tiny", smoke=True)
    like = ts.init_train_state(LM(tcfg), 0, compress=True, device="meta")
    ckpt.restore(d, 2, like)
    no_ef = ts.init_train_state(LM(tcfg), 0, device="meta")
    ckpt.restore(d, 2, no_ef)              # a subset of the leaves is fine
    wide = ts.init_train_state(
        LM(dataclasses.replace(tcfg, d_model=96)), 0, device="meta")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 2, wide)
    deeper = ts.init_train_state(
        LM(dataclasses.replace(tcfg, num_layers=3)), 0, device="meta")
    deeper.params["extra"] = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore(d, 2, deeper)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        ckpt.restore(d, 2, like)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_and_resumes_exactly(tmp_path):
    _, losses = train("edge-tiny", steps=30, batch=4, seq=64, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])

    run = dict(smoke=True, batch=2, seq=32, device="cpu")
    straight, l20 = train("edge-tiny", steps=20, **run)
    d = str(tmp_path)
    _, l1 = train("edge-tiny", steps=10, ckpt_dir=d, ckpt_every=5, **run)
    assert ckpt.latest_step(d) == 10
    resumed, l2 = train("edge-tiny", steps=10, ckpt_dir=d, resume=True,
                        **run)
    assert l1 + l2 == l20
    _equal(bridge.train_state_to_numpy(resumed),
           bridge.train_state_to_numpy(straight))


def test_launcher_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            train("edge-tiny", steps=1, batch=2, seq=16, device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.init_train_state(LM(configs("edge-tiny", smoke=True)[1]), 0)


# ---------------------------------------------------------------------------
# kernels without a backward
# ---------------------------------------------------------------------------

def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta").requires_grad_(grad)


def _meta_int8(E, D, F):
    return {"q": torch.empty((E, D, F), dtype=torch.int8, device="meta"),
            "s": torch.empty((E, 1, F), device="meta")}


KERNELS = {
    # the expert kernels' int8-weight variant (their bf16 and f32 routes
    # have a backward: test_expert_kernels_under_autograd_reach_their_function;
    # so do rglru_scan and ssd_chunk:
    # test_recurrent_kernels_under_autograd_reach_their_function)
    "moe_gemm": lambda g: MG.moe_gemm(_meta(2, 4, 8, grad=g),
                                      _meta_int8(2, 8, 16)),
    "moe_ffn_fused": lambda g: MG.moe_ffn_fused(
        _meta(2, 4, 8, grad=g), _meta_int8(2, 8, 16), _meta_int8(2, 8, 16)),
    "decode_attention": lambda g: DA.decode_attention(
        _meta(1, 4, 16, grad=g), _meta(1, 2, 8, 16), _meta(1, 2, 8, 16),
        torch.empty(1, dtype=torch.int32, device="meta")),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernels_without_a_backward_refuse_autograd_off_the_cpu(name):
    """Off the CPU (``meta`` stands in for the card here) a kernel with no
    backward raises when autograd records, instead of returning an output
    with no ``grad_fn``; under ``no_grad`` it goes on to its other checks
    (which refuse the meta device)."""
    with pytest.raises(RuntimeError, match=f"{name} has no backward kernel"):
        KERNELS[name](True)
    with torch.no_grad():
        with pytest.raises(ValueError, match="cpu or cuda"):
            KERNELS[name](True)
    with pytest.raises(ValueError, match="cpu or cuda"):
        KERNELS[name](False)


@pytest.mark.parametrize("name", ["moe_gemm", "moe_ffn_fused"])
def test_expert_kernels_under_autograd_reach_their_function(name,
                                                            monkeypatch):
    """bf16 weights off the CPU (``meta``) under autograd go through
    ``MoEGemm`` / ``MoEFFNFused`` instead of refusing: the Function's
    forward is the kernel's launch (which refuses the meta device), and
    its output carries the Function's ``grad_fn``."""
    def bf16(*shape):
        return torch.empty(shape, dtype=torch.bfloat16,
                           device="meta").requires_grad_(True)

    def call():
        if name == "moe_gemm":
            return MG.moe_gemm(bf16(2, 4, 8), bf16(2, 8, 16))
        return MG.moe_ffn_fused(bf16(2, 4, 8), bf16(2, 8, 16),
                                bf16(2, 8, 16))

    with pytest.raises(ValueError, match="cpu or cuda"):
        call()
    launched = []

    def launch(kernel, x, ws):
        launched.append(kernel)
        return torch.empty(x.shape[:2] + ws[0].shape[2:], dtype=x.dtype,
                           device=x.device)

    monkeypatch.setattr(MG, "_launch", launch)
    out = call()
    assert launched == [name]
    assert type(out.grad_fn).__name__ == {
        "moe_gemm": "MoEGemmBackward",
        "moe_ffn_fused": "MoEFFNFusedBackward"}[name]


RECURRENT = {
    "rglru_scan": (RS, lambda g: RS.rglru_scan(
        _meta(1, 4, 8, grad=g), _meta(1, 4, 8), _meta(1, 8)), "RGLRUScan"),
    "ssd_chunk": (SC, lambda g: SC.ssd_chunk(
        _meta(1, 4, 2, 8, grad=g), _meta(1, 4, 2), _meta(2),
        _meta(1, 4, 1, 4), _meta(1, 4, 1, 4), _meta(1, 2, 8, 4), 4),
        "SSDChunk"),
}


@pytest.mark.parametrize("name", sorted(RECURRENT))
def test_recurrent_kernels_under_autograd_reach_their_function(name,
                                                               monkeypatch):
    """Off the CPU (``meta``) under autograd, rglru_scan and ssd_chunk go
    through ``RGLRUScan`` / ``SSDChunk`` instead of refusing: the
    Function's forward is the kernel's launch (which refuses the meta
    device, with autograd recording or not), and its output carries the
    Function's ``grad_fn``."""
    mod, call, fn = RECURRENT[name]
    for grad in (True, False):
        with pytest.raises(ValueError, match="cpu or cuda"):
            call(grad)
    launched = []

    def forward(*args):
        launched.append(name)
        if name == "rglru_scan":
            return torch.empty_like(args[0])
        return torch.empty_like(args[0]), torch.empty_like(args[5]), None

    monkeypatch.setattr(mod, "_forward", forward)
    out = call(True)
    out = out if name == "rglru_scan" else out[0]
    assert launched == [name]
    assert type(out.grad_fn).__name__ == f"{fn}Backward"

"""The expert kernels' backward (``MoEGemm``, ``MoEFFNFused`` and their plain
backward: K1 ``moe_ffn_fused_bwd``, K2 ``moe_gemm_dx``, K3 ``moe_gemm_dw``)
against the reference on the CPU.

* ``jax.vjp`` of the reference's ``_expert_ffn`` (``moe_gemm`` of
  ``moe_ffn_fused``) against the port's autograd through the Functions, on
  the same inputs and cotangent drawn with numpy: in f32 every gradient
  (h, w_gate, w_up, w_down) within 1e-5 of its largest magnitude (the same
  f32 arithmetic, summed in another order); in bf16 within 1e-2 of its
  norm in L2 (the port rounds where the reference rounds, and once more:
  dg and du are cast to bf16 for the tensor cores, which take bf16
  operands; measured 1.6e-3 to 4.2e-3, dw_down equal bit for bit).
* The Functions against autograd of the plain forward (f32: within 1e-6 of
  the largest magnitude), ``gradcheck`` of both in f64, and
  ``needs_input_grad``: no weight gradient when only x needs one, and the
  reverse, counted at the kernels' wrappers.
* The qwen3-moe smoke config trains through the Functions: remat none,
  dots and full give the same loss and gradients bit for bit; and a
  microbatch with the train step's bf16 compute copies (its router too)
  gives finite gradients on every leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import _expert_ffn as jax_expert_ffn
from repro_torch import bridge
from repro_torch.kernels.moe_gemm import moe_gemm as MG
from repro_torch.models.transformer import LM
from repro_torch.training.train_step import accumulate_grads
from tests._torch_pairs import configs

F32_REL = 1e-5      # of each gradient's largest magnitude
BF16_NORM = 1e-2    # of each gradient's norm


def _inputs(seed, E, C, D, F):
    """h [E, C, D], the three expert weights and the output's cotangent
    [E, C, D], f32 numpy."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((E, C, D)).astype(np.float32)
    wg = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    ct = rng.standard_normal((E, C, D)).astype(np.float32)
    return h, wg, wu, wd, ct


def _reference(h, wg, wu, wd, ct, dtype):
    """(dh, dw_gate, dw_up, dw_down) of jax.vjp of the reference's
    ``_expert_ffn``, as f32 numpy."""
    p = {"w_gate": jnp.asarray(wg, dtype), "w_up": jnp.asarray(wu, dtype),
         "w_down": jnp.asarray(wd, dtype)}
    _, vjp = jax.vjp(jax_expert_ffn, p, jnp.asarray(h, dtype))
    dp, dh = vjp(jnp.asarray(ct, dtype))
    return [np.asarray(t, np.float32)
            for t in (dh, dp["w_gate"], dp["w_up"], dp["w_down"])]


def _port(h, wg, wu, wd, ct, dtype):
    """The same gradients through the port's Functions (their plain
    backward on the CPU)."""
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True)
          for a in (h, wg, wu, wd)]
    out = MG.moe_gemm(MG.moe_ffn_fused(ts[0], ts[1], ts[2]), ts[3])
    assert type(out.grad_fn).__name__ == "MoEGemmBackward"
    out.backward(torch.from_numpy(ct).to(dtype))
    return [t.grad.float().numpy() for t in ts]


SHAPES = [(2, 8, 16, 24), (3, 5, 12, 8), (1, 1, 8, 40), (4, 21, 32, 16)]


@pytest.mark.parametrize("E,C,D,F", SHAPES)
def test_plain_backward_matches_reference_in_f32(E, C, D, F):
    args = _inputs(E * 7 + C, E, C, D, F)
    want = _reference(*args, jnp.float32)
    got = _port(*args, torch.float32)
    for name, g, w in zip(("dh", "dwg", "dwu", "dwd"), got, want):
        assert np.abs(g - w).max() <= F32_REL * np.abs(w).max(), name


@pytest.mark.parametrize("E,C,D,F", SHAPES)
def test_plain_backward_matches_reference_in_bf16(E, C, D, F):
    h, wg, wu, wd, ct = _inputs(E * 11 + C, E, C, D, F)
    # bf16-exact inputs, so both sides start from the same values
    args = [torch.from_numpy(a).bfloat16().float().numpy()
            for a in (h, wg, wu, wd, ct)]
    want = _reference(*args, jnp.bfloat16)
    got = _port(*args, torch.bfloat16)
    for name, g, w in zip(("dh", "dwg", "dwu", "dwd"), got, want):
        assert np.linalg.norm(g - w) <= BF16_NORM * np.linalg.norm(w), name


def test_the_kernels_plain_backward_is_the_functions_backward():
    """On the CPU the Functions' backward is the plain versions of K1-K3:
    dg and du from ``moe_ffn_fused_bwd_ref``, dx by ``moe_gemm_dx_ref``
    on both pairs, the weights' by ``moe_gemm_dw_ref``; and K1's recompute
    of gate and up is the forward's (its output from them is
    ``moe_ffn_fused_ref``'s)."""
    h, wg, wu, wd, ct = (torch.from_numpy(a) for a in
                         _inputs(3, 2, 9, 16, 24))
    dout = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 9, 24)).astype(np.float32))
    x, g, u = (t.clone().requires_grad_(True) for t in (h, wg, wu))
    MG.moe_ffn_fused(x, g, u).backward(dout)
    dg, du = MG.moe_ffn_fused_bwd_ref(h, wg, wu, dout)
    assert torch.equal(x.grad, MG.moe_gemm_dx_ref((dg, du), (wg, wu)))
    assert all(torch.equal(a, b) for a, b in zip(
        (g.grad, u.grad), MG.moe_gemm_dw_ref(h, (dg, du))))
    gate = torch.einsum("ecd,edf->ecf", h, wg)
    up = torch.einsum("ecd,edf->ecf", h, wu)
    assert torch.equal(torch.nn.functional.silu(gate) * up,
                       MG.moe_ffn_fused_ref(h, wg, wu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_match_autograd_of_the_plain_forward(dtype):
    """The Functions' gradients against autograd through the plain
    forward: f32 within 1e-6 of the largest magnitude; bf16 within 1e-2 of
    the norm (autograd keeps dg and du in f32 and sums dx's two terms
    before one cast)."""
    h, wg, wu, wd, ct = _inputs(5, 3, 10, 24, 16)
    grads = []
    for fused, gemm in ((MG.moe_ffn_fused, MG.moe_gemm),
                        (MG.moe_ffn_fused_ref, MG.moe_gemm_ref)):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in (h, wg, wu, wd)]
        gemm(fused(*ts[:3]), ts[3]).backward(torch.from_numpy(ct).to(dtype))
        grads.append([t.grad.float() for t in ts])
    for got, want in zip(*grads):
        if dtype == torch.float32:
            assert (got - want).abs().max() <= 1e-6 * want.abs().max()
        else:
            assert (got - want).norm() <= BF16_NORM * want.norm()


def test_gradcheck_in_f64():
    rng = np.random.default_rng(6)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()

    x, wg, wu = leaf(2, 5, 6), leaf(2, 6, 4), leaf(2, 6, 4)
    a, wd = leaf(2, 5, 4), leaf(2, 4, 6)
    assert torch.autograd.gradcheck(MG.moe_ffn_fused, (x, wg, wu))
    assert torch.autograd.gradcheck(MG.moe_gemm, (a, wd))


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, True),
                                   (False, True, False), (False, False, True),
                                   (True, True, True)])
def test_needs_input_grad(needs, monkeypatch):
    """Only the gradients asked for are computed: K2 (dx) runs only where
    x needs one, K3 (dw) only where a weight does, on just those outputs;
    the others come back None."""
    calls = []
    for name in ("moe_gemm_dx", "moe_gemm_dw"):
        real = getattr(MG, name)

        def counted(*args, _real=real, _name=name):
            out = _real(*args)
            calls.append((_name, len(out) if isinstance(out, list) else 1))
            return out

        monkeypatch.setattr(MG, name, counted)
    h, wg, wu, wd, ct = _inputs(8, 2, 4, 8, 16)
    x, g, u = (torch.from_numpy(a).requires_grad_(n)
               for a, n in zip((h, wg, wu), needs))
    MG.moe_ffn_fused(x, g, u).sum().backward()
    nw = needs[1] + needs[2]
    assert calls == [("moe_gemm_dx", 1)] * needs[0] + \
        [("moe_gemm_dw", nw)] * bool(nw)
    for t, n in zip((x, g, u), needs):
        assert (t.grad is not None) == n
    if not any(needs[:2]):
        return
    calls.clear()
    a, w = (torch.from_numpy(arr).requires_grad_(n) for arr, n in
            zip((np.ones((2, 4, 16), np.float32), wd), needs[:2]))
    MG.moe_gemm(a, w).sum().backward()
    assert calls == [("moe_gemm_dx", 1)] * needs[0] + \
        [("moe_gemm_dw", 1)] * needs[1]


def test_no_grad_keeps_the_forward():
    """Under ``no_grad`` (serving) the wrappers return the plain forward
    itself: no Function, no grad_fn."""
    h, wg, wu, wd, _ = (torch.from_numpy(a).requires_grad_()
                        for a in _inputs(9, 2, 4, 8, 16))
    with torch.no_grad():
        out = MG.moe_gemm(MG.moe_ffn_fused(h, wg, wu), wd)
    assert out.grad_fn is None
    assert torch.equal(out, MG.moe_gemm_ref(MG.moe_ffn_fused_ref(h, wg, wu),
                                            wd))


def test_qwen3_moe_remat_changes_no_gradient():
    """qwen3-moe's smoke config through the Functions: remat none, dots
    (the Functions are no aten products, so dots recomputes them: memory,
    not values) and full give the same loss and gradients bit for bit."""
    _, tcfg = configs("qwen3-moe-30b-a3b", smoke=True)
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 64),
                                         dtype=np.int64).astype(np.int32))
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -1
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = LM(cfg).init(0, device="cpu")
        for p in bridge.leaves(params):
            p.requires_grad_(True)
        loss, _ = LM(cfg).loss(params, {"tokens": toks, "labels": labels},
                               ce_chunk=16)
        loss.backward()
        out[remat] = (loss, [p.grad for p in bridge.leaves(params)])
    loss0, grads0 = out["none"]
    assert any(g is not None and g.abs().sum() > 0 for g in grads0)
    for remat, (loss, grads) in out.items():
        assert torch.equal(loss, loss0), remat
        for g, w in zip(grads, grads0):
            assert (g is None and w is None) or torch.equal(g, w), remat


def test_qwen3_moe_trains_in_bf16():
    """The train step casts every matrix leaf to bf16, the router too (as
    the reference does); routing reads it in f32, as the reference's
    einsum promotes it. A microbatch in bf16 gives a finite loss and a
    finite, non-zero f32 gradient on every leaf, the router's and the
    experts' included."""
    _, tcfg = configs("qwen3-moe-30b-a3b", smoke=True)
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 64),
                                         dtype=np.int64).astype(np.int32))
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -1
    params = LM(tcfg).init(0, device="cpu")
    for p in bridge.leaves(params):
        p.requires_grad_(True)
    loss, _ = accumulate_grads(LM(tcfg), params,
                               {"tokens": toks, "labels": labels})
    assert torch.isfinite(loss)
    moe = params["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    for p in bridge.leaves(params):
        assert p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert moe[k].grad.abs().sum() > 0, k

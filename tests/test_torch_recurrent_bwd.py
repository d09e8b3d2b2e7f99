"""The recurrent kernels' backward (``RGLRUScan``, ``SSDChunk`` and their
plain backward: ``rglru_scan_bwd_ref``, ``ssd_chunk_bwd_ref``) against the
reference on the CPU.

* ``jax.vjp`` of the reference's ``_scan_lru`` and ``_ssd_chunked`` against
  the plain backwards on the same inputs and cotangents drawn with numpy,
  in f32, with a nonzero h0 / S0, the final state's cotangent and a ragged
  last chunk: every gradient within 1e-5 of its largest magnitude (the
  same f32 arithmetic in another order; the SSD's dA, a sum over every
  step, within 5e-5).
* The plain backwards against autograd of the plain forwards (f64: 1e-10
  of the largest magnitude), ``gradcheck`` of both Functions in f64, and
  ``needs_input_grad``: one backward call a Function, its gradients where
  they are asked for, counted at the wrappers; ``no_grad`` keeps the plain
  forward.
* The SSD plain forward masks the decay's exponent before ``exp``: at a
  chunk's decay span past 88 (where the reference's ``jnp.where(causal,
  exp(seg), 0)`` at ``src/repro/models/ssd.py:116`` gives NaN gradients)
  its forward has the unmasked form's bits and every gradient is finite
  and equals a float64 evaluation.
* The hybrid and SSM smoke configs train through the Functions: remat
  none, dots and full give the same loss and gradients bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rglru import _scan_lru
from repro.models.ssd import _ssd_chunked
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.rglru_scan import rglru_scan as RS
from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
from repro_torch.models.transformer import LM
from repro_torch.training.train_step import accumulate_grads
from tests._torch_pairs import configs

F32_REL = 1e-5      # of each gradient's largest magnitude
DA_REL = 5e-5       # the SSD's dA: a sum over every step
F64_REL = 1e-10


def _close(got, want, rel):
    for g_, w_, r in zip(got, want, rel):
        g_, w_ = np.asarray(g_, np.float64), np.asarray(w_, np.float64)
        assert np.isfinite(g_).all()
        scale = max(float(np.abs(w_).max()), 1e-30)
        assert float(np.abs(g_ - w_).max()) <= r * scale


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _rg(seed, B, T, W):
    """a in (0.5, 1), b and h0 normal, and the cotangent of h (its last
    row, the final state's, doubled)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, T, W)).astype(np.float32)
    b = rng.standard_normal((B, T, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    dh = rng.standard_normal((B, T, W)).astype(np.float32)
    dh[:, -1] *= 2
    return a, b, h0, dh


def _ssd(seed, b, l, nh, hp, g, n):
    """The model's ranges (dt in [1e-3, 0.1], A = -(1..nh)), x, B, C, S0
    normal, and the cotangents of y and S_final."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, nh, hp)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (b, l, nh)).astype(np.float32)
    A = -np.arange(1, nh + 1, dtype=np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    S0 = rng.standard_normal((b, nh, hp, n)).astype(np.float32)
    dy = rng.standard_normal((b, l, nh, hp)).astype(np.float32)
    dS = rng.standard_normal((b, nh, hp, n)).astype(np.float32)
    return (x, dt, A, B, C, S0), dy, dS


def _t(*arrays, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad)
            for a in arrays]


# ---------------------------------------------------------------------------
# the plain backwards against jax.vjp of the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,W", [(2, 37, 5), (1, 300, 16), (3, 513, 3),
                                   (1, 1, 8)])
def test_rglru_plain_backward_matches_reference(B, T, W):
    """``_scan_lru``'s chunks of 256 with a ragged last one (T 300, 513)."""
    a, b, h0, dh = _rg(T + W, B, T, W)
    h, vjp = jax.vjp(_scan_lru, *(jnp.asarray(x) for x in (a, b, h0)))
    want = vjp(jnp.asarray(dh))
    at, bt, h0t, dht = _t(a, b, h0, dh)
    got = RS.rglru_scan_bwd_ref(at, RS.rglru_scan_ref(at, bt, h0t), h0t, dht)
    _close([g.numpy() for g in got], want, [F32_REL] * 3)


@pytest.mark.parametrize("b,l,nh,hp,g,n,chunk", [
    (2, 37, 4, 8, 1, 16, 16),       # smoke widths, a ragged last chunk
    (1, 10, 4, 8, 2, 8, 16),        # l below the chunk, g 2
    (1, 70, 4, 12, 2, 20, 32),      # hp, n off 16; last chunk of 6
])
def test_ssd_plain_backward_matches_reference(b, l, nh, hp, g, n, chunk):
    ins, dy, dS = _ssd(l * 3 + hp, b, l, nh, hp, g, n)
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              ssm_chunk=chunk)
    _, vjp = jax.vjp(lambda *a: _ssd_chunked(cfg, *a),
                     *(jnp.asarray(x) for x in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dS)))
    got = SC.ssd_chunk_bwd_ref(*_t(*ins), *_t(dy, dS), chunk)
    _close([t.numpy() for t in got], want,
           [F32_REL, F32_REL, DA_REL, F32_REL, F32_REL, F32_REL])


# ---------------------------------------------------------------------------
# the plain backwards against autograd; gradcheck; needs_input_grad
# ---------------------------------------------------------------------------

def test_rglru_plain_backward_is_autograd_of_the_plain_forward():
    a, b, h0, dh = _rg(4, 2, 300, 6)
    at, bt, h0t = _t(a, b, h0, dtype=torch.float64, grad=True)
    h = RS.rglru_scan_ref(at, bt, h0t)
    want = torch.autograd.grad(h, (at, bt, h0t), torch.from_numpy(dh).double())
    got = RS.rglru_scan_bwd_ref(at.detach(), h.detach(), h0t.detach(),
                                torch.from_numpy(dh).double())
    _close(got, want, [F64_REL] * 3)


def test_ssd_plain_backward_is_autograd_of_the_plain_forward():
    ins, dy, dS = _ssd(5, 2, 45, 4, 6, 2, 8)
    ts = _t(*ins, dtype=torch.float64, grad=True)
    y, S = SC.ssd_chunk_ref(*ts, 16)
    want = torch.autograd.grad((y, S), ts, tuple(_t(dy, dS,
                                                   dtype=torch.float64)))
    got = SC.ssd_chunk_bwd_ref(*(t.detach() for t in ts),
                               *_t(dy, dS, dtype=torch.float64), 16)
    _close(got, want, [F64_REL] * 6)


def test_gradcheck_both_functions_in_f64():
    a, b, h0, _ = _rg(6, 2, 20, 3)
    a = (0.5 + 0.5 * a).astype(np.float32)
    assert torch.autograd.gradcheck(
        RS.RGLRUScan.apply, tuple(_t(a, b, h0, dtype=torch.float64,
                                     grad=True)))
    ins, _, _ = _ssd(7, 1, 11, 2, 3, 1, 4)
    assert torch.autograd.gradcheck(
        lambda *t: SC.SSDChunk.apply(*t, 4),
        tuple(_t(*ins, dtype=torch.float64, grad=True)))


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, False),
                                   (False, False, True), (True, True, True)])
def test_rglru_needs_input_grad(needs, monkeypatch):
    """One reverse scan a backward, counted at its wrapper; the gradients
    come back where they are asked for, None elsewhere."""
    calls = []
    real = RS.rglru_scan_bwd

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(RS, "rglru_scan_bwd", counted)
    a, b, h0, dh = _rg(8, 2, 40, 4)
    ts = [t.requires_grad_(n) for t, n in zip(_t(a, b, h0), needs)]
    h = RS.rglru_scan(*ts)
    assert type(h.grad_fn).__name__ == "RGLRUScanBackward"
    h.backward(torch.from_numpy(dh))
    assert calls == [1]
    want = RS.rglru_scan_bwd_ref(ts[0].detach(), h.detach(), ts[2].detach(),
                                 torch.from_numpy(dh))
    for t, n, w in zip(ts, needs, want):
        assert (t.grad is not None) == n
        if n:
            assert torch.equal(t.grad, w)


@pytest.mark.parametrize("need", range(6))
def test_ssd_needs_input_grad(need, monkeypatch):
    calls = []
    real = SC.ssd_chunk_bwd

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(SC, "ssd_chunk_bwd", counted)
    ins, dy, dS = _ssd(9, 1, 20, 2, 4, 1, 8)
    ts = [t.requires_grad_(i == need) for i, t in enumerate(_t(*ins))]
    y, S = SC.ssd_chunk(*ts, 8)
    assert type(y.grad_fn).__name__ == "SSDChunkBackward"
    torch.autograd.backward((y, S), tuple(_t(dy, dS)))
    assert calls == [1]
    for i, t in enumerate(ts):
        assert (t.grad is not None) == (i == need)


def test_no_grad_keeps_the_forward():
    """Under ``no_grad`` (serving) the wrappers return the plain forward
    itself: no Function, no grad_fn."""
    a, b, h0, _ = _rg(10, 1, 30, 4)
    ts = _t(a, b, h0, grad=True)
    with torch.no_grad():
        h = RS.rglru_scan(*ts)
    assert h.grad_fn is None and torch.equal(h, RS.rglru_scan_ref(*ts))
    ins, _, _ = _ssd(11, 1, 20, 2, 4, 1, 8)
    ts = _t(*ins, grad=True)
    with torch.no_grad():
        y, S = SC.ssd_chunk(*ts, 8)
    y0, S0 = SC.ssd_chunk_ref(*ts, 8)
    assert y.grad_fn is None and torch.equal(y, y0) and torch.equal(S, S0)


# ---------------------------------------------------------------------------
# the SSD plain forward's masked exponent
# ---------------------------------------------------------------------------

def _unmasked_forward(x, dt, A, B, C, S0, chunk):
    """The plain forward as it was, ``where(causal, exp(seg), 0)``: the
    reference's form (``src/repro/models/ssd.py:116``)."""
    b, l, nh, hp = x.shape
    Q = min(chunk, l)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))[None, :, :,
                                                             None]
    hpg = nh // B.shape[2]
    S, ys = S0, []
    for c in range(l // Q):
        sl = slice(c * Q, (c + 1) * Q)
        dtq = dt[:, sl]
        cum = torch.cumsum(dtq * A, dim=1)
        Bh = B[:, sl].repeat_interleave(hpg, dim=2)
        Ch = C[:, sl].repeat_interleave(hpg, dim=2)
        xdt = x[:, sl] * dtq[..., None]
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        ldec = torch.where(causal, torch.exp(seg), torch.zeros_like(seg))
        scores = torch.einsum("bihn,bjhn->bijh", Ch, Bh)
        y_diag = torch.einsum("bijh,bjhp->bihp", scores * ldec, xdt)
        y_off = torch.einsum("bihn,bhpn->bihp",
                             Ch * torch.exp(cum)[..., None], S)
        decay_out = torch.exp(cum[:, -1:, :] - cum)
        S = (torch.exp(cum[:, -1, :])[..., None, None] * S
             + torch.einsum("bjhn,bjhp->bhpn", Bh * decay_out[..., None],
                            xdt))
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), S


def _probe():
    """b 1, l 256, nh 4, Q 128, dt 0.7, A = -(1, 8, 32, 64): every head's
    decay over a chunk passes 88."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 256, 4, 8)).astype(np.float32)
    dt = np.full((1, 256, 4), 0.7, np.float32)
    A = -np.array([1, 8, 32, 64], np.float32)
    B = rng.standard_normal((1, 256, 1, 8)).astype(np.float32)
    C = rng.standard_normal((1, 256, 1, 8)).astype(np.float32)
    S0 = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    dy = rng.standard_normal((1, 256, 4, 8)).astype(np.float32)
    return (x, dt, A, B, C, S0), dy


def test_ssd_masked_exponent_keeps_the_forward_and_finite_gradients():
    """At the probe's span the unmasked form's gradient of dt and A is NaN
    (0 x inf in where's backward); the plain forward gives the same bits
    as the unmasked form, finite gradients everywhere, and the gradients
    of a float64 evaluation."""
    ins, dy = _probe()
    old = _unmasked_forward(*_t(*ins), 128)
    ts = _t(*ins, grad=True)
    y, S = SC.ssd_chunk_ref(*ts, 128)
    assert torch.equal(y, old[0]) and torch.equal(S, old[1])
    olds = _t(*ins, grad=True)
    ddt_old = torch.autograd.grad(_unmasked_forward(*olds, 128)[0],
                                  olds[1], torch.from_numpy(dy))[0]
    assert torch.isnan(ddt_old).any()       # the fault the mask removes
    got = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    t64 = _t(*ins, dtype=torch.float64, grad=True)
    want = torch.autograd.grad(SC.ssd_chunk_ref(*t64, 128)[0], t64,
                               torch.from_numpy(dy).double())
    _close([g.numpy() for g in got], [w.numpy() for w in want],
           [F32_REL, 1e-4, 1e-4, F32_REL, F32_REL, F32_REL])
    plain = SC.ssd_chunk_bwd_ref(*_t(*ins), torch.from_numpy(dy),
                                 torch.zeros(1, 4, 8, 8), 128)
    _close([g.numpy() for g in plain], [w.numpy() for w in want],
           [F32_REL, 1e-4, 1e-4, F32_REL, F32_REL, F32_REL])


# ---------------------------------------------------------------------------
# the smoke models through the Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b"])
def test_remat_changes_no_gradient(arch):
    """The hybrid and SSM smoke configs train through ``RGLRUScan`` /
    ``SSDChunk``: remat none, dots and full give the same loss and
    gradients bit for bit, every gradient finite."""
    _, tcfg = configs(arch, smoke=True)
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 40),
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
                               ce_chunk=8)
        loss.backward()
        out[remat] = (loss, [p.grad for p in bridge.leaves(params)])
    loss0, grads0 = out["none"]
    assert all(g is not None and torch.isfinite(g).all() for g in grads0)
    for remat, (loss, grads) in out.items():
        assert torch.equal(loss, loss0), remat
        for g, w in zip(grads, grads0):
            assert torch.equal(g, w), remat


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b"])
def test_recurrent_families_train_in_bf16(arch, monkeypatch):
    """The train step's bf16 compute copies (every matrix leaf: the
    RG-LRU's block-diagonal gates too, which the block reads in f32 as the
    reference's einsum promotes them, and the SSM's layer-stacked A_log,
    whose exp the layer hands the scan in f32): the scans get the f32
    operands their kernels take, and the step a finite loss and a finite
    f32 gradient on every leaf, nonzero on the scans' own parameters."""
    from repro_torch.models import rglru as RG, ssd as SSD
    for mod, name, f32 in ((RG, "rglru_scan", (0, 1, 2)),
                           (SSD, "ssd_chunk", (1, 2, 5))):
        real = getattr(mod, name)

        def checked(*args, _real=real, _f32=f32):
            assert all(args[i].dtype == torch.float32 for i in _f32)
            return _real(*args)

        monkeypatch.setattr(mod, name, checked)
    _, tcfg = configs(arch, smoke=True)
    rng = np.random.default_rng(14)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 40),
                                         dtype=np.int64).astype(np.int32))
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -1
    params = LM(tcfg).init(0, device="cpu")
    for p in bridge.leaves(params):
        p.requires_grad_(True)
    loss, _ = accumulate_grads(LM(tcfg), params,
                               {"tokens": toks, "labels": labels})
    assert torch.isfinite(loss)
    for p in bridge.leaves(params):
        assert p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()
    if arch == "mamba2-1.3b":
        own = [params["layers"]["ssd"][k] for k in ("A_log", "dt_bias")]
    else:
        own = [params["layers"][0]["rec"][k]
               for k in ("gate_a", "gate_i", "lambda")]
    for p in own:
        assert p.grad.abs().sum() > 0

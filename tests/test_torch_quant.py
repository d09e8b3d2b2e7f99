"""Weight-only int8 quantisation in the port against the reference package's,
on the CPU: ``quantize_weight`` and ``quantize_tree`` give the reference's
int8 values and f32 scales bit for bit (bf16 and f32 leaves, layer- and
expert-stacked leaves, a zero column, the smoke trees of six families at
three ``min_size``s), and ``LM.init`` at ``serve_weight_dtype="int8"``
equals ``quantize_tree`` of the bf16 init, leaf for leaf and bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import quant as JQ
from repro.models.transformer import LM as JaxLM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import quant as Q
from repro_torch.models.transformer import LM

ARCHS = ("edge-tiny", "mixtral-8x7b", "qwen3-moe-30b-a3b",
         "recurrentgemma-2b", "mamba2-1.3b", "seamless-m4t-medium")


def _pair(w: np.ndarray, dtype: str):
    """The same values as a reference array and a port tensor in dtype."""
    return (jnp.asarray(w).astype(dtype),
            torch.from_numpy(w).to(getattr(torch, dtype)))


def _same_bits(ref_tree, port_tree):
    """Leaf for leaf (the reference's order): shape, dtype and every bit."""
    jl, tl = jax.tree.leaves(ref_tree), bridge.leaves(port_tree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        if b.dtype == torch.bfloat16:
            a, b = a.astype(np.float32), b.float()
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(64, 80), (3, 64, 80), (2, 4, 32, 48),
                                   (5, 7)])
def test_quantize_weight_is_the_references(dtype, shape):
    """Per-output-channel scales over the contracting (-2) axis of a plain,
    layer-stacked and expert-stacked leaf; column 3 all zeros (scale
    1e-12, values 0)."""
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 3] = 0.0
    jw, tw = _pair(w, dtype)
    want, got = JQ.quantize_weight(jw), Q.quantize_weight(tw)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert float(got["s"][..., 0, 3].max()) == np.float32(1e-12)
    # the input is left as it was (the port rounds in place, on a copy)
    np.testing.assert_array_equal(tw.float().numpy(), np.asarray(
        jw.astype(jnp.float32)))


@settings(max_examples=25, deadline=None, database=None)
@given(rows=st.integers(1, 40), cols=st.integers(1, 40),
       scale=st.floats(1e-6, 1e3), seed=st.integers(0, 2 ** 16),
       half_ties=st.booleans())
def test_quantize_weight_bits_property(rows, cols, scale, seed, half_ties):
    """Any [2, rows, cols] f32 leaf, including values that land on .5 after
    the division (round half to even in both packages)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((2, rows, cols)) * scale).astype(np.float32)
    if half_ties:          # halves in [-127, 127], amax 127: scale 1.0
        w = (rng.integers(-254, 255, (2, rows, cols)) / 2).astype(np.float32)
        w[:, 0] = 127.0
    jq = JQ.quantize_weight(jnp.asarray(w))
    tq = Q.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tq["s"].numpy(), np.asarray(jq["s"]))


@pytest.mark.parametrize("min_size", [1, 256, 1 << 12])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_tree_is_the_references(arch, min_size):
    """The reference's bf16 smoke tree (the hybrid's layers a tuple)
    through both ``quantize_tree``s: the same leaves quantised, EXCLUDE
    names and small or non-matrix leaves untouched, every bit equal."""
    jp = JaxLM(jax_smoke_config(arch)).init(jax.random.key(1))
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp),
                                get_smoke_config(arch), "cpu")
    want = JQ.quantize_tree(jp, min_size=min_size)
    got = Q.quantize_tree(tp, min_size=min_size)
    _same_bits(want, got)
    assert sum(t.dtype == torch.int8 for t in bridge.leaves(got)) == sum(
        a.dtype == jnp.int8 for a in jax.tree.leaves(want))
    if isinstance(tp["layers"], tuple):
        assert isinstance(got["layers"], tuple)


def test_quantize_tree_keeps_excluded_and_small_leaves():
    tree = {"embed": torch.ones(64, 64), "lm_head": torch.ones(64, 64),
            "router": torch.ones(64, 64), "w": torch.ones(64, 64),
            "small": torch.ones(8, 8), "vec": torch.ones(4096),
            "ids": torch.ones(64, 64, dtype=torch.int32)}
    out = Q.quantize_tree(tree)
    assert Q.is_quantized(out["w"])
    for k in ("embed", "lm_head", "router", "small", "vec", "ids"):
        assert out[k] is tree[k]
    assert Q.is_quantized(Q.quantize_tree(tree, min_size=64)["small"])


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_init_is_quantize_tree_of_the_bf16_init(arch):
    """The same draws, quantised as they are made: equal to quantising
    the finished bf16 tree, bit for bit, with its structure (stacked
    expert weights as int8 [L, E, d, f] and f32 [L, E, 1, f] scales)."""
    cfg = get_smoke_config(arch)
    assert cfg.serve_weight_dtype == "bfloat16"
    want = Q.quantize_tree(LM(cfg).init(3, "cpu"))
    got = LM(dataclasses.replace(cfg, serve_weight_dtype="int8")).init(
        3, "cpu")
    assert bridge.tree_map(lambda t: (tuple(t.shape), t.dtype), got) == \
        bridge.tree_map(lambda t: (tuple(t.shape), t.dtype), want)
    for a, b in zip(bridge.leaves(want), bridge.leaves(got)):
        assert torch.equal(a, b)
    if cfg.is_moe:
        wg = got["layers"]["moe"]["w_gate"]
        L, E, d, f = (cfg.num_layers, cfg.num_experts, cfg.d_model,
                      cfg.moe_d_ff)
        assert wg["q"].shape == (L, E, d, f) and wg["q"].dtype == torch.int8
        assert wg["s"].shape == (L, E, 1, f)

"""The port's distribution layer held against the reference's, in one
process: the sharding planner's specs, notes and microbatches for every
architecture, shape and production mesh; the placements the specs turn
into; the shape cells and their stand-in inputs; the abstract train state
and int8 tree; ``qwhole_attention``; decode with softcapped logits; the
plain decode's log-sum-exp; and the step analysis' cost model.

The planner's rules need only a mesh's axis names and sizes, so both
packages plan against a stand-in mesh (the reference test's ``FakeMesh``,
tests/test_sharding_plan.py:22). Multi-rank execution is in
test_torch_distributed.py."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

import repro.sharding.planner as RP
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.launch import hlo_analysis as RH
from repro.models import attention as JA
from repro.models import quant as JQ
from repro.models.transformer import LM as JaxLM
from repro.sharding import SHAPES as R_SHAPES
from repro.sharding import cell_runnable as r_cell_runnable
from repro.sharding import input_specs as r_input_specs
from repro.sharding import make_plan as r_make_plan
from repro.training import train_step as JTS
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention.decode_attention import \
    decode_attention_ref
from repro_torch.launch import step_analysis as SA
from repro_torch.models import attention as A
from repro_torch.models import quant as Q
from repro_torch.models.transformer import LM, layer_params
from repro_torch.sharding import SHAPES, cell_runnable, input_specs, make_plan
from repro_torch.sharding import planner as TP
from repro_torch.sharding.ctx import constrain, use_mesh
from repro_torch.sharding.planner import Spec, placements, spec_of
from repro_torch.training import train_step as TTS
from tests._torch_pairs import configs, weights

ASSIGNED = [a for a in ARCH_IDS if a != "edge-tiny"]
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Just enough mesh for both planners' pure rules."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty((int(np.prod(list(shape.values()))),),
                                object)


@functools.lru_cache(maxsize=None)
def _param_trees(arch):
    return JaxLM(jax_config(arch)).param_specs(), \
        LM(get_config(arch)).param_specs()


def _ref_flat(tree):
    out = {}
    for kp, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", "")))
                     for k in kp)] = s
    return out


def _port_flat(tree, prefix=()):
    if isinstance(tree, Spec):
        return {"/".join(prefix): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, prefix + (str(k),)))
    return out


def _leaf_shapes(tree, prefix=()):
    """{key path: (shape, dtype name)} of a tree of tensors, meta tensors,
    ShapeDtypeStructs or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_shapes(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaf_shapes(v, prefix + (str(i),)))
        return out
    dt = str(tree.dtype).replace("torch.", "")
    return {"/".join(prefix): (tuple(tree.shape), dt)}


def _specs_equal(ref_tree, port_tree, what):
    r, p = _ref_flat(ref_tree), _port_flat(port_tree)
    assert set(r) == set(p), f"{what}: key paths differ: {set(r) ^ set(p)}"
    for k in r:
        assert tuple(r[k]) == tuple(p[k]), f"{what} {k}: {r[k]} vs {p[k]}"


class TestPlannerParity:
    @pytest.mark.parametrize("mesh_name", list(MESHES))
    @pytest.mark.parametrize("shape", list(R_SHAPES))
    @pytest.mark.parametrize("arch", ASSIGNED)
    def test_plan_equals_reference(self, arch, shape, mesh_name,
                                   monkeypatch):
        """Param, cache and batch specs leaf for leaf by key path, notes
        and microbatches, under the reference's serving weight budget;
        every spec's placements map back to the same spec."""
        monkeypatch.setattr(TP, "SERVE_WEIGHT_BUDGET",
                            RP.SERVE_WEIGHT_BUDGET)
        mesh = FakeMesh(MESHES[mesh_name])
        rcfg, pcfg = jax_config(arch), get_config(arch)
        rparams, pparams = _param_trees(arch)
        cell, batch, seq, _ = r_input_specs(rcfg, shape)
        serve = cell.kind != "train"
        rcache = JaxLM(rcfg).init_cache(batch, seq, abstract=True) \
            if serve else None
        pcache = LM(pcfg).init_cache(batch, seq, device="meta") \
            if serve else None
        ref = r_make_plan(rcfg, mesh, cell.kind, batch=batch, seq=seq,
                          param_tree=rparams, cache_tree=rcache)
        got = make_plan(pcfg, mesh, cell.kind, batch=batch, seq=seq,
                        param_tree=pparams, cache_tree=pcache)
        _specs_equal(ref.param_specs, got.param_specs, "params")
        if serve:
            _specs_equal(ref.cache_specs, got.cache_specs, "cache")
        assert {k: tuple(v) for k, v in ref.batch_specs.items()} == \
            {k: tuple(v) for k, v in got.batch_specs.items()}
        assert got.notes == ref.notes
        assert got.microbatches == ref.microbatches
        shapes = _leaf_shapes(pparams)
        for path, spec in _port_flat(got.param_specs).items():
            nd = len(shapes[path][0])
            assert spec_of(placements(spec, mesh), mesh, nd) == \
                Spec(*(tuple(spec) + (None,) * (nd - len(spec)))), path

    def test_h100_budget_changes_only_weight_gathered_serving(self):
        """At the port's own budget (17.5 GB, the H100's 80 GB at the
        reference's 3.5 / 16 share) no catalog model serves weight-gathered;
        at the reference's 3.5 GB these four do. Nothing else of any plan
        moves."""
        mesh = FakeMesh(MESHES["pod16x16"])
        changed = []
        for arch in ASSIGNED:
            cfg = get_config(arch)
            cell, batch, seq, _ = input_specs(cfg, "decode_32k")
            pparams = _param_trees(arch)[1]
            cache = LM(cfg).init_cache(batch, seq, device="meta")
            own = make_plan(cfg, mesh, "decode", batch=batch, seq=seq,
                            param_tree=pparams, cache_tree=cache)
            assert not any("weight-gathered" in n for n in own.notes)
            old = TP.SERVE_WEIGHT_BUDGET
            try:
                TP.SERVE_WEIGHT_BUDGET = RP.SERVE_WEIGHT_BUDGET
                ref = make_plan(cfg, mesh, "decode", batch=batch, seq=seq,
                                param_tree=pparams, cache_tree=cache)
            finally:
                TP.SERVE_WEIGHT_BUDGET = old
            if _port_flat(ref.param_specs) != _port_flat(own.param_specs):
                changed.append(arch)
                assert any("weight-gathered" in n for n in ref.notes)
            assert ref.cache_specs == own.cache_specs
        assert sorted(changed) == sorted(
            ["command-r-35b", "qwen2-vl-72b", "qwen3-moe-30b-a3b",
             "mixtral-8x7b"])
        assert TP.SERVE_WEIGHT_BUDGET == 80e9 * 3.5 / 16

    @pytest.mark.parametrize("spec", [Spec(("pod", "data"), None, "model"),
                                      Spec(None, "model"), Spec("data"),
                                      Spec(None, None, ("pod", "data"))])
    def test_placements_round_trip(self, spec):
        """A dim over ("pod", "data") is Shard(d) on both mesh dims; unnamed
        mesh dims replicate; placements map back to the spec."""
        from torch.distributed.tensor import Replicate, Shard
        mesh = FakeMesh(MESHES["pod2x16x16"])
        pls = placements(spec, mesh)
        assert len(pls) == 3
        for name, pl in zip(("pod", "data", "model"), pls):
            dims = [d for d, e in enumerate(spec)
                    if name in (e if isinstance(e, tuple) else (e,))]
            assert pl == (Shard(dims[0]) if dims else Replicate())
        assert spec_of(pls, mesh, len(spec)) == spec

    def test_spec_normalises_one_axis_tuples(self):
        assert Spec(("data",), None) == Spec("data", None)
        assert tuple(Spec(("data",))) == tuple(P(("data",)))


class TestCells:
    @pytest.mark.parametrize("shape", list(R_SHAPES))
    @pytest.mark.parametrize("arch", list(ARCH_IDS))
    def test_cells_and_inputs_match_reference(self, arch, shape):
        """``cell_runnable`` and ``input_specs`` (full scale and 1/128):
        the same verdicts, cells, batch, seq, and inputs of the same shapes
        and dtypes, on the ``meta`` device."""
        rcfg, pcfg = jax_config(arch), get_config(arch)
        assert cell_runnable(pcfg, shape) == r_cell_runnable(rcfg, shape)
        assert dataclasses.asdict(SHAPES[shape]) == \
            dataclasses.asdict(R_SHAPES[shape])
        for scale in (1.0, 1 / 128):
            rc, rb, rs, rspecs = r_input_specs(rcfg, shape, scale=scale)
            pc, pb, ps, pspecs = input_specs(pcfg, shape, scale=scale)
            assert (rb, rs) == (pb, ps)
            assert _leaf_shapes(rspecs) == _leaf_shapes(pspecs)
            assert all(t.device.type == "meta" for t in pspecs.values())


class TestAbstractState:
    @pytest.mark.parametrize("arch", list(ARCH_IDS))
    def test_abstract_train_state_matches_reference(self, arch):
        """Shapes and dtypes of every leaf of params, m, v and step, on
        ``meta``; ``train_state_specs`` lays m and v out as the params and
        replicates the step."""
        ref = JTS.abstract_train_state(JaxLM(jax_config(arch)))
        got = TTS.abstract_train_state(LM(get_config(arch)))
        assert _leaf_shapes(got.params) == _leaf_shapes(ref.params)
        for k in ("m", "v", "step"):
            assert _leaf_shapes(got.opt[k]) == _leaf_shapes(ref.opt[k]), k
        assert got.ef is None and ref.ef is None
        assert all(t.device.type == "meta"
                   for t in jax.tree.leaves(dict(got.params)))
        plan = make_plan(get_config(arch), FakeMesh(MESHES["pod16x16"]),
                         "train", batch=256, seq=4096,
                         param_tree=got.params)
        specs = TTS.train_state_specs(plan, got)
        assert specs.opt["m"] is plan.param_specs
        assert specs.opt["v"] is plan.param_specs
        assert specs.opt["step"] == Spec() and specs.ef is None

    @pytest.mark.parametrize("arch", list(ARCH_IDS))
    def test_abstract_quantize_tree_matches_reference(self, arch):
        ref = JQ.abstract_quantize_tree(JaxLM(jax_config(arch)).param_specs())
        got = Q.abstract_quantize_tree(_param_trees(arch)[1]
                                       if arch != "edge-tiny" else
                                       LM(get_config(arch)).param_specs())
        assert _leaf_shapes(got) == _leaf_shapes(ref)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class TestQwholeAttention:
    @pytest.mark.parametrize("softcap", [0.0, 20.0])
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_reference(self, causal, softcap):
        """f32 within 1e-5: q kept whole (40 rows, not a multiple of the
        KV block), GQA 6 heads on 2, KV blocks of 16 with a padded tail."""
        q = _rand((2, 40, 6, 16), 1)
        k, v = _rand((2, 40, 2, 16), 2), _rand((2, 40, 2, 16), 3)
        pos = np.arange(40, dtype=np.int32)
        kw = dict(causal=causal, window=0, block_kv=16, softcap=softcap)
        ref = JA.qwhole_attention(*(jnp.asarray(a) for a in (q, k, v, pos,
                                                              pos)), **kw)
        got = A.qwhole_attention(*(torch.tensor(a) for a in (q, k, v, pos,
                                                              pos)), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)

    def test_dispatch_takes_it_when_heads_do_not_divide(self, monkeypatch):
        """``full_attention`` goes through ``qwhole_attention`` exactly when
        a mesh's model axis does not divide the query heads; ``constrain``
        is the identity on plain tensors inside the mesh."""
        calls = []
        real = A.qwhole_attention
        monkeypatch.setattr(A, "qwhole_attention",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        _, cfg = configs("phi3-medium-14b", smoke=True)   # 4 heads
        q = torch.tensor(_rand((1, 8, 4, 16), 4))
        k = v = torch.tensor(_rand((1, 8, 2, 16), 5))
        pos = torch.arange(8, dtype=torch.int32)
        plain = A.full_attention(q, k, v, pos, pos, cfg)
        for model, want in ((2, 0), (3, 1)):
            calls.clear()
            with use_mesh(FakeMesh({"data": 1, "model": model})):
                out = A.full_attention(q, k, v, pos, pos, cfg)
                assert constrain(q, "dp", "model", None, None) is q
            assert len(calls) == want
            np.testing.assert_allclose(out.numpy(), plain.numpy(),
                                       atol=1e-6)


class TestSoftcapDecode:
    @pytest.mark.parametrize("paged", [False, True])
    def test_softcapped_decode_matches_reference(self, paged):
        """Softcapped logits decode on the plain path, as the reference's
        dispatch routes them: dense and paged, f32, 1e-5."""
        jcfg, tcfg = configs()
        jcfg = dataclasses.replace(jcfg, attn_logits_softcap=4.0)
        tcfg = dataclasses.replace(tcfg, attn_logits_softcap=4.0)
        jp, tp = weights(jcfg, tcfg)
        jattn = jax.tree.map(lambda a: a[0], jp["layers"])["attn"]
        tattn = layer_params(tp["layers"], 0)["attn"]
        x = _rand((3, 1, tcfg.d_model), 6)
        pos = np.array([0, 5, 15], np.int32)
        kh, hd = tcfg.num_kv_heads, tcfg.head_dim
        if not paged:
            ck, cv = (_rand((3, 16, kh, hd), s) for s in (7, 8))
            ref = JA.decode_self_attention(
                jattn, jcfg, jnp.asarray(x), jnp.asarray(ck),
                jnp.asarray(cv), jnp.asarray(pos))[0]
            got = A.decode_self_attention(
                tattn, tcfg, torch.tensor(x), torch.tensor(ck),
                torch.tensor(cv), torch.tensor(pos))[0]
        else:
            kp, vp = (_rand((7, 8, kh, hd), s) for s in (7, 8))
            block = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
            ref = JA.paged_decode_self_attention(
                jattn, jcfg, jnp.asarray(x), jnp.asarray(kp),
                jnp.asarray(vp), jnp.asarray(block), jnp.asarray(pos))[0]
            got = A.paged_decode_self_attention(
                tattn, tcfg, torch.tensor(x), torch.tensor(kp),
                torch.tensor(vp), torch.tensor(block), torch.tensor(pos))[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


class TestPlainLse:
    @settings(deadline=None, database=None, max_examples=25)
    @given(B=st.integers(1, 3), kh=st.integers(1, 2), g=st.integers(1, 3),
           S=st.integers(1, 40), seed=st.integers(0, 1000))
    def test_lse_is_logsumexp_of_the_scores(self, B, kh, g, S, seed):
        """``decode_attention_ref(..., return_lse=True)``: each row's lse is
        the log-sum-exp of its scaled scores over its valid rows, -inf at
        length 0; the output is the call without lse."""
        rng = np.random.default_rng(seed)
        q, k, v = (torch.tensor(rng.standard_normal(shape),
                                dtype=torch.float32)
                   for shape in ((B, kh * g, 16), (B, kh, S, 16),
                                 (B, kh, S, 16)))
        lengths = torch.tensor(rng.integers(0, S + 1, B), dtype=torch.int32)
        lengths[0] = 0
        o, lse = decode_attention_ref(q, k, v, lengths, return_lse=True)
        assert torch.equal(o, decode_attention_ref(q, k, v, lengths))
        for b in range(B):
            n = int(lengths[b])
            for h in range(kh * g):
                if n == 0:
                    assert lse[b, h] == -math.inf
                    continue
                s = k[b, h // g, :n] @ q[b, h] / math.sqrt(16)
                assert abs(float(lse[b, h] - torch.logsumexp(s, 0))) <= 1e-5


class TestStepAnalysis:
    @pytest.mark.parametrize("n", [1, 2, 4, 16, 256])
    def test_wire_factors_match_reference(self, n):
        for op, f in RH._WIRE_FACTOR.items():
            want = f(n) * 1000.0 if n > 1 else 0.0
            assert SA.wire_bytes(op, 1000.0, n) == pytest.approx(want)

    @pytest.mark.parametrize("arch", ASSIGNED)
    def test_model_flops_match_reference(self, arch):
        for kind in ("train", "prefill", "decode"):
            assert SA.model_flops(get_config(arch), kind, 4, 128) == \
                RH.model_flops(jax_config(arch), kind, 4, 128)

    def test_memory_report_keys_and_h100_constants(self):
        mem = SA.MemoryAnalysis(argument_size_in_bytes=3e9,
                                temp_size_in_bytes=2e9,
                                output_size_in_bytes=1e9)
        rep = SA.memory_report(mem)
        assert set(rep) == set(RH.memory_report(mem))
        assert rep["peak_bytes_per_device"] == 6e9 and rep["fits_hbm"]
        assert (SA.PEAK_FLOPS, SA.HBM_BW, SA.HBM_PER_CHIP) == \
            (989e12, 3.35e12, 80e9)
        assert SA.link_bw(range(8)) == SA.NVLINK_BW
        assert SA.link_bw(range(16)) == SA.IB_BW

"""The dry run of the recurrent families, and its counter.

* ``StepCounter`` (``launch/step_analysis.py``) counts no bytes for
  ``prim::device``, the device query an index issues under a dispatch
  mode over fake tensors: an index of an activation costs its operands
  and result once.
* The global FLOPs of a small mamba2-1.3b train cell and a small
  recurrentgemma-2b train cell (2-3 layers, d 128, 1/128 scale) on a fake
  world of 8 ranks (a 2x4 data×model mesh) against the reference's
  loop-aware count off its compiled HLO on 8 forced host devices, within
  [0.9, 1.1]; the scans' reported work is their mathematical products
  (``ssd_chunk.ssd_products``), the reference's counts every operation
  of its chunked scans.
* Every hybrid and SSM cell at 1/128 scale on a fake world of 256 ranks
  (the 16x16 production mesh), at full widths and 3 (recurrentgemma-2b:
  rec, rec, attn) or 4 (mamba2-1.3b) layers: ``ok``, long_500k included;
  the train and prefill cells run their scan kernel, train_4k its
  backward too; the decode cells none (the single-step recurrence, as
  the reference's decode); the encoder-decoder's cells (2 decoder
  layers) ``ok`` and fitting, the flash kernel in train and prefill (its
  backward in train), the decode kernel in decode, but for long_500k,
  ``skipped`` by the sub-quadratic rule.
* A dense train cell whose batch is too small to split over the data
  axis (minitron-8b at 1/128, 2 layers): ``ok`` (ROADMAP §3).

Each dry run takes a process of its own (the fake world is
process-wide)."""

import textwrap

import torch

from tests.test_torch_distributed import ENV, _result

#: small cells (the reference test's sizes): 4 of mamba2's 8 heads, and 4
#: of recurrentgemma's 16 gate blocks, a rank on the 4-way model axis
SMALL = {
    "mamba2-1.3b": {"num_layers": 2, "d_model": 128, "ssm_state": 16,
                    "ssm_headdim": 16, "ssm_chunk": 16, "vocab_size": 1024},
    "recurrentgemma-2b": {"num_layers": 3, "d_model": 128,
                          "lru_width": 128, "num_heads": 4,
                          "num_kv_heads": 1, "head_dim": 32, "d_ff": 256,
                          "sliding_window": 16, "vocab_size": 1024,
                          "attn_block_q": 16, "attn_block_kv": 32},
}

_REF_DRY = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    sys.path.insert(0, "src")
    from repro.launch.mesh import make_test_mesh
    from repro.launch.dryrun import lower_cell
    mesh = make_test_mesh((2, 4), ("data", "model"))
    out = {{}}
    for arch, over in {small!r}.items():
        rec, _ = lower_cell(arch, "train_4k", mesh, scale=1 / 128,
                            overrides=over)
        out[arch] = rec["roofline"]["flops_global"]
    print("RESULT::" + json.dumps(out))
""")

_PORT_DRY = textwrap.dedent("""
    import sys, json, warnings
    warnings.filterwarnings("ignore")
    sys.path.insert(0, "src")
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    from repro_torch.launch.dryrun import lower_cell
    fake_world(8)
    mesh = make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
    out = {{}}
    for arch, over in {small!r}.items():
        rec, _ = lower_cell(arch, "train_4k", mesh, scale=1 / 128,
                            overrides=over)
        out[arch] = {{k: rec[k] for k in ("status", "roofline", "memory",
                                          "kernels")}}
    print("RESULT::" + json.dumps(out))
""")


def test_device_queries_move_no_bytes():
    """An index of an activation under ``FakeTensorMode`` issues
    ``prim::device`` on it twice; the counter charges the index its
    operands and result once, and the queries nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.step_analysis import StepCounter
    with FakeTensorMode():
        x = torch.empty((1024, 256))
        idx = torch.empty((8,), dtype=torch.long)
        with StepCounter() as counter:
            y = x[idx]
    assert counter.hbm_bytes == x.nbytes + idx.nbytes + y.nbytes


def test_recurrent_dry_run_flops_match_reference_count():
    ref = _result(_REF_DRY.format(small=SMALL), dict(ENV, JAX_PLATFORMS="cpu"))
    got = _result(_PORT_DRY.format(small=SMALL), ENV)
    for arch, kernel in (("mamba2-1.3b", "ssd_chunk"),
                         ("recurrentgemma-2b", "rglru_scan")):
        rec = got[arch]
        assert rec["status"] == "ok" and rec["memory"]["fits_hbm"], arch
        assert {kernel, kernel + "_bwd"} <= set(rec["kernels"]), arch
        ratio = rec["roofline"]["flops_global"] / ref[arch]
        assert 0.9 <= ratio <= 1.1, (arch, ratio)


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
    for arch, layers in (("mamba2-1.3b", 4), ("recurrentgemma-2b", 3),
                         ("seamless-m4t-medium", 2)):
        for shape in SHAPES:
            rec, _ = lower_cell(arch, shape, mesh, scale=1 / 128,
                                overrides={"num_layers": layers})
            out[f"{arch} {shape}"] = {
                k: rec.get(k) for k in ("status", "reason", "kernels",
                                        "memory")}
    rec, _ = lower_cell("minitron-8b", "train_4k", mesh, scale=1 / 128,
                        overrides={"num_layers": 2})
    out["minitron-8b train_4k"] = {k: rec.get(k) for k in ("status",
                                                            "error")}
    print("RESULT::" + json.dumps(out))
""")


def test_small_batch_train_cell_gathers_zero3_weights():
    """A train cell whose batch (2 at 1/128) is too small to split over
    the 16 data ranks: the ZeRO-3 weights are gathered over the data axis
    for each product (``layers.gathered``), where the partial sums they
    gave made DTensor split the sequence over that axis and then fail to
    plan the flattened product on fake tensors. The dense family's cell,
    run beside the recurrent ones (``_CELLS``)."""
    got = _cells()["minitron-8b train_4k"]
    assert got["status"] == "ok", got["error"]


_GOT = {}


def _cells():
    """``_CELLS``' records, run once for this file's tests."""
    if not _GOT:
        _GOT.update(_result(_CELLS, ENV))
    return _GOT


def test_every_recurrent_cell_ok_at_small_scale():
    for key, rec in _cells().items():
        arch, shape = key.split()
        if arch == "minitron-8b":
            continue
        if arch.startswith("seamless") and shape == "long_500k":
            assert rec["status"] == "skipped", key
            assert "sub-quadratic" in rec["reason"], key
            continue
        assert rec["status"] == "ok", key
        assert rec["memory"]["fits_hbm"], key
        if arch.startswith("seamless"):
            # the encoder, the causal self and the cross attention through
            # the flash kernel; decode's self attention through the decode
            # kernel, its cross attention plain, as the reference's
            want = {"train_4k": {"flash_attention", "flash_attention_bwd"},
                    "prefill_32k": {"flash_attention"},
                    "decode_32k": {"decode_attention"}}[shape]
            assert set(rec["kernels"]) == want, key
            continue
        kernel = "ssd_chunk" if arch.startswith("mamba2") else "rglru_scan"
        want = {"train_4k": {kernel, kernel + "_bwd"},
                "prefill_32k": {kernel}}.get(shape, set())
        assert set(rec["kernels"]) == want, key

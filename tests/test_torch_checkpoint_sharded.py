"""Sharded checkpoints: a DTensor train state saved whole in the reference's
one-file format and restored onto a mesh (``restore(shardings=)``), held on
gloo worlds started in subprocesses (``tests/_torch_dist_cases.py``,
OMP_NUM_THREADS=1); this process never joins a process group and no JAX
runs inside a world.

* The production launcher on a 2x2 mesh (standing in for the 16x16 one),
  qwen3-moe-30b-a3b's smoke state: 2 steps saved, 2 resumed from the
  checkpoint equal 4 uninterrupted steps bit for bit (losses, every
  gathered leaf of params, m, v and the step), the data cursor resumes at
  2, and the resume plans from a ``meta`` state and restores straight into
  the plan's layout (no state drawn and replaced).
* The elastic restart, recurrentgemma-2b's smoke state (the hybrid's tuple
  of layers): the reference's checkpoint of it (written by
  ``repro.training.checkpoint.save``) restored onto the 2x2 mesh bit for
  bit; one step there, saved; then of the four ranks rank 3 fails,
  ``remesh_after_failure`` keeps 2 on a (1, 2) mesh, and the checkpoint
  restores onto it and with no mesh bit for bit; the next step on that mesh
  is the unsharded port's from the same checkpoint by the test files' rule
  (m, v within 1e-5 of each leaf's largest, each leaf's update within 2e-3
  of its norm); the reference's ``restore`` reads the port's sharded
  checkpoint bit for bit; a session moved with ``transfer(dst_shardings=)``
  (its cache DTensors on the mesh) fingerprints as the source and as a
  plain import.
* Without a world: a flipped byte still raises ``IOError`` under
  ``shardings``, a shardings tree that differs from ``tree_like`` raises
  naming the leaf, and the shard's hash, taken in chunks, is the whole
  file's sha256."""

import dataclasses
import hashlib
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models.transformer import LM as JaxLM
from repro.training import checkpoint as jax_ckpt
from repro.training import train_step as jax_ts
from repro_torch import bridge
from repro_torch.models.transformer import LM
from repro_torch.sharding import make_plan
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import train_step as ts
from tests._torch_dist_cases import _step_errs, elastic_run, same_bits
from tests._torch_pairs import configs
from tests.test_torch_distributed import _run

TOL = 1e-5          # m, v: of each leaf's largest
STEP_REL = 2e-3     # each leaf's update: of its norm
RUN_S = 120
RESUME = {"arch": "qwen3-moe-30b-a3b", "steps": 2, "batch": 4, "seq": 64}


@pytest.fixture(scope="module")
def resume(tmp_path_factory):
    folder = tmp_path_factory.mktemp("resume")
    out = _run("ckpt_resume", RESUME, folder, timeout=RUN_S)
    out["cursors"] = [json.loads((folder / "resumed" / f"step_{k:08d}" /
                                  "manifest.json").read_text())["extra"]
                      ["data_step"] for k in (2, 4)]
    return out


def test_resumed_losses_equal_uninterrupted_steps(resume):
    assert len(resume["losses"]) == 2 * RESUME["steps"]
    assert all(np.isfinite(resume["losses"]))
    assert resume["losses"] == resume["whole_losses"]


def test_resumed_state_equals_uninterrupted_state(resume):
    """Every gathered leaf of params, m, v and the step, bit for bit."""
    assert int(resume["state"]["step"]) == 2 * RESUME["steps"]
    assert same_bits(resume["state"], resume["whole_state"]) == []


def test_resume_restores_into_the_plan_from_meta(resume):
    """The data cursor resumes at 2; the resume plans from a ``meta``
    state and restores into the 2x2 plan's layout (experts split over
    model, their ZeRO-3 dim over data) with no state drawn."""
    assert resume["cursors"] == [2, 4]
    assert resume["first_production"] == 1
    assert resume["resume_production"] == 0
    assert resume["restores"] == [{"step": 2, "like": "meta",
                                   "mesh": (2, 2)}]
    assert resume["placements"]["w_gate"] == [2, 1]


def _ref_tree(jstate) -> dict:
    """A reference train state in ``_state_tree``'s form."""
    s = bridge.train_state_to_numpy(jstate)
    return {"params": s["params"], "m": s["opt"]["m"], "v": s["opt"]["v"],
            "step": s["opt"]["step"]}


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    folder = tmp_path_factory.mktemp("elastic")
    jcfg, tcfg = configs("recurrentgemma-2b", smoke=True)
    jstate = jax_ts.init_train_state(JaxLM(jcfg), jax.random.key(0))
    jax_ckpt.save(str(folder / "ref"), 0, jstate)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(np.roll(tokens, -1, 1))}

    def spawn(case, inp, folder_, world):
        return _run(case, inp, Path(folder_), world=world, timeout=RUN_S)
    saved, out, (want, loss), before = elastic_run(
        spawn, tcfg, bridge.train_state_to_torch(jstate, "cpu"), batch,
        str(folder), ref_dir=str(folder / "ref"))
    jlike = jax.eval_shape(lambda k: jax_ts.init_train_state(JaxLM(jcfg),
                                                             k),
                           jax.random.key(0))
    back, extra = jax_ckpt.restore(str(folder / "elastic"), 1, jlike)
    return {"saved": saved, "out": out, "want": want, "loss": loss,
            "before": before,
            "ref": _ref_tree(jstate), "ref_back": _ref_tree(back),
            "ref_extra": extra}


def test_reference_checkpoint_restores_onto_2x2_mesh(elastic):
    saved = elastic["saved"]
    assert same_bits(saved["ref_restored"], elastic["ref"]) == []
    assert saved["ref_layouts"]["embed"] == [None, 0]   # vocab over model


def test_2x2_checkpoint_restores_onto_the_remeshed_world(elastic):
    """``remesh_after_failure(range(4), {3}, 2)``'s (1, 2) mesh: every
    restored leaf (gathered) is the saved one, split as the new plan
    says; the data cursor comes back."""
    out = elastic["out"]
    assert out["mesh"] == (1, 2) and out["extra"] == {"data_step": 1}
    assert same_bits(out["restored"], elastic["saved"]["saved"]) == []
    assert out["layouts"]["layers"][0]["rec"]["w_x"] == [None, 1]


def test_2x2_checkpoint_restores_with_no_mesh(elastic):
    assert same_bits(elastic["out"]["plain"],
                     elastic["saved"]["saved"]) == []


def test_step_after_elastic_restore_matches_unsharded(elastic):
    e = _step_errs(elastic["out"], elastic["want"], elastic["before"])
    assert max(e["m"], e["v"]) <= TOL, e
    assert e["update"] <= STEP_REL, e
    want = elastic["loss"]
    assert abs(elastic["out"]["loss"] - want) <= TOL * max(1.0, abs(want))


def test_reference_restores_the_port_sharded_checkpoint(elastic):
    assert elastic["ref_extra"] == {"data_step": 1}
    assert same_bits(elastic["ref_back"], elastic["saved"]["saved"]) == []


def test_transfer_with_dst_shardings_keeps_fingerprint(elastic):
    """The wire payload's cache arrives as DTensors on the (1, 2) mesh;
    the destination's export, and a plain import's, fingerprint as the
    source, and the three engines decode the same next tokens."""
    t = elastic["out"]["transfer"]
    assert t["dtensors"] == t["leaves"] > 0
    assert t["src"] == t["dst"] == t["plain"]
    assert t["tokens"][0] == t["tokens"][1] == t["tokens"][2]


# ---------------------------------------------------------------------------
# without a world: the checks before any leaf is placed
# ---------------------------------------------------------------------------

def _saved(tmp_path):
    """A port checkpoint of recurrentgemma-2b's smoke state, its
    ``meta`` tree and the 2x2 plan's shardings (the rules need only a
    mesh-like object)."""
    _, tcfg = configs("recurrentgemma-2b", smoke=True)
    lm = LM(tcfg)
    path = ckpt.save(str(tmp_path), 3, ts.init_train_state(lm, 0,
                                                           device="cpu"))
    like = ts.init_train_state(lm, 0, device="meta")
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    plan = make_plan(tcfg, mesh, "train", batch=4, seq=32,
                     param_tree=like.params)
    return path, like, (mesh, ts.train_state_specs(plan, like))


def test_corrupt_shard_raises_under_shardings(tmp_path):
    path, like, shardings = _saved(tmp_path)
    shard = f"{path}/shard_0.npz"
    raw = bytearray(open(shard, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(shard, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        ckpt.restore(str(tmp_path), 3, like, shardings=shardings)


@pytest.mark.parametrize("drift", ["missing", "extra"])
def test_mismatched_shardings_tree_names_the_leaf(tmp_path, drift):
    _, like, (mesh, specs) = _saved(tmp_path)
    layer = dict(specs.params["layers"][1]["rec"])
    if drift == "missing":
        del layer["lambda"]
    else:
        layer["mu"] = layer["lambda"]
    layers = list(specs.params["layers"])
    layers[1] = dict(layers[1], rec=layer)
    params = dict(specs.params, layers=tuple(layers))
    bad = specs._replace(params=params)
    want = "params/layers/1/rec/" + ("lambda" if drift == "missing"
                                     else "mu")
    with pytest.raises(ValueError, match=want):
        ckpt.restore(str(tmp_path), 3, like, shardings=(mesh, bad))


def test_chunked_hash_is_the_whole_file_hash(tmp_path, monkeypatch):
    """Hashed in chunks smaller than the shard, the digest is the whole
    file's (the reference hashes the file in one read)."""
    path, _, _ = _saved(tmp_path)
    shard = f"{path}/shard_0.npz"
    monkeypatch.setattr(ckpt, "_HASH_CHUNK", 4096)
    whole = hashlib.sha256(open(shard, "rb").read()).hexdigest()
    assert ckpt._sha256(shard) == whole
    manifest = json.loads(open(f"{path}/manifest.json").read())
    assert manifest["shards"]["0"]["sha256"] == whole
    assert len(open(shard, "rb").read()) > 4 * 4096


def test_wider_tree_is_refused_by_shape_under_shardings(tmp_path):
    """Under ``shardings`` too, a leaf whose shape differs from the saved
    one raises before any leaf is placed."""
    _saved(tmp_path)
    _, tcfg = configs("recurrentgemma-2b", smoke=True)
    wide = dataclasses.replace(tcfg, d_model=2 * tcfg.d_model)
    like = ts.init_train_state(LM(wide), 0, device="meta")
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    plan = make_plan(wide, mesh, "train", batch=4, seq=32,
                     param_tree=like.params)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 3, like,
                     shardings=(mesh, ts.train_state_specs(plan, like)))

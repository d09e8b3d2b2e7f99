"""Multi-pod dry run: prove the distribution config is coherent, the port of
the reference's ``repro.launch.dryrun``.

For each (architecture × input shape) cell, on the single-pod 16×16 mesh
or the 2×16×16 multi-pod mesh, one process stands up a fake world of 256 or
512 ranks (``launch.mesh.fake_world``) and, as rank 0, runs one step
(train, prefill or decode) at full scale under ``FakeTensorMode``: the
state and inputs are DTensors laid out by the plan, every op runs on
rank 0's shards with shapes and no data, and every collective returns at
once. ``launch.step_analysis`` counts what the step costs a device, in
place of the reference's compiled-HLO analysis, and the cell's record
lands in ``artifacts/dryrun/<arch>__<shape>__<mesh>.json`` with the
reference's keys. The figures are estimates from a fake-tensor run and the
H100 data sheet's constants, not measurements.

Every family is distributed here: the dense GQA, MoE, hybrid, SSM and
encoder-decoder ones. A cell is written with ``"status": "skipped"`` only
by the sub-quadratic rule (``sharding.specs.cell_runnable``): long_500k of
a full-attention model.

``init_process_group`` is process-wide, so the dry run takes a process of
its own (it refuses to start beside another group).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # single-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import step_analysis as H
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.transformer import LM
from repro_torch.sharding import SHAPES, cell_runnable, input_specs, make_plan
from repro_torch.sharding.ctx import use_mesh
from repro_torch.sharding.planner import Spec, axis_sizes, distribute_tree
from repro_torch.training.train_step import (abstract_train_state,
                                             make_train_step,
                                             train_state_specs)

ASSIGNED = tuple(a for a in ARCH_IDS if a != "edge-tiny")


def _batch(mesh, plan, specs):
    """The cell's inputs as DTensors by the plan's batch specs."""
    return {k: distribute_tree(v, plan.batch_specs.get(
        k, Spec(*([None] * v.dim()))), mesh) for k, v in specs.items()}


def lower_cell(arch: str, shape_name: str, mesh, *, scale: float = 1.0,
               overrides=None):
    """Plan, distribute and run one cell's step under ``FakeTensorMode``
    on ``mesh`` (a fake world's rank 0). Returns (record, None) — the
    reference returns its compiled executable second."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ok, reason = cell_runnable(cfg, shape_name)
    if not ok:
        return {"status": "skipped", "reason": reason}, None

    n_dev = mesh.size()
    lm = LM(cfg)
    t0 = time.time()
    with FakeTensorMode(), use_mesh(mesh):
        cell, batch, seq, specs = input_specs(cfg, shape_name, scale=scale)
        if cell.kind == "train":
            state_abs = abstract_train_state(lm)
            plan = make_plan(cfg, mesh, "train", batch=batch, seq=seq,
                             param_tree=state_abs.params)
            step = make_train_step(lm, microbatches=plan.microbatches)
            state = distribute_tree(state_abs,
                                    train_state_specs(plan, state_abs), mesh)
            inputs = _batch(mesh, plan, specs)
            args = (state, inputs)

            def run():
                return step(state, inputs)
        elif cell.kind == "prefill":
            params_abs = lm.param_specs()
            cache_abs = lm.init_cache(batch, seq, device="meta")
            plan = make_plan(cfg, mesh, "prefill", batch=batch, seq=seq,
                             param_tree=params_abs, cache_tree=cache_abs)
            params = distribute_tree(params_abs, plan.param_specs, mesh)
            inputs = _batch(mesh, plan, specs)
            args = (params, inputs)

            def run():
                with torch.no_grad():
                    return lm.prefill(params, inputs, seq)
        else:  # decode / serve step
            params_abs = lm.param_specs()
            if cfg.serve_weight_dtype == "int8":
                from repro_torch.models.quant import abstract_quantize_tree
                params_abs = abstract_quantize_tree(params_abs)
            cache_abs = lm.init_cache(batch, seq, device="meta")
            plan = make_plan(cfg, mesh, "decode", batch=batch, seq=seq,
                             param_tree=params_abs, cache_tree=cache_abs)
            params = distribute_tree(params_abs, plan.param_specs, mesh)
            cache = distribute_tree(cache_abs, plan.cache_specs, mesh)
            tokens = distribute_tree(specs["tokens"],
                                     plan.batch_specs["tokens"], mesh)
            args = (params, cache, tokens)

            def run():
                with torch.no_grad():
                    return lm.decode_step(params, cache, tokens)
        lower_s = time.time() - t0
        rec, _ = H.analyze(run, args, n_dev)

    mf = H.model_flops(cfg, cell.kind, batch, seq)
    roof = rec["roofline"]
    record = {
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "kind": cell.kind,
        "mesh": {"shape": list(axis_sizes(mesh).values()),
                 "axes": list(axis_sizes(mesh)), "devices": int(n_dev)},
        "batch": batch,
        "seq": seq,
        "scale": scale,
        "microbatches": plan.microbatches,
        "plan_notes": plan.notes,
        # the reference's lower / compile times: here the plan and the
        # distribution of the state, then the traced step
        "lower_s": round(lower_s, 2),
        "compile_s": round(rec["step_s"], 2),
        "memory": rec["memory"],
        "cost_analysis": rec["cost_analysis"],
        "collectives": rec["collectives"],
        "roofline": roof,
        # an eager step counts each op as it runs: the reference's
        # body-once HLO count has no counterpart, so it is the same count
        "roofline_naive_bodyonce": roof,
        "kernels": rec["kernels"],
        "model_flops": mf,
        "useful_flops_ratio": (mf / roof["flops_global"]
                               if roof["flops_global"] else 0.0),
        "estimate": "fake-tensor run; H100 SXM5 data-sheet constants",
    }
    return record, None


def run_cell(arch, shape_name, *, multi_pod=False, scale=1.0, out_dir=None,
             force=False, overrides=None, tag=""):
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_dir = out_dir or "artifacts/dryrun"
    os.makedirs(out_dir, exist_ok=True)
    stem = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, stem + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    fake_world(512 if multi_pod else 256)      # unless one is up already
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    try:
        record, _ = lower_cell(arch, shape_name, mesh, scale=scale,
                               overrides=overrides)
    except Exception as e:  # a failure here is a bug in the system
        record = {"status": "error", "arch": arch, "shape": shape_name,
                  "mesh": mesh_name, "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    record.setdefault("arch", arch)
    record.setdefault("shape", shape_name)
    record["mesh_name"] = mesh_name
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=float)
    return record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args()

    cells = []
    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    for a in archs:
        for s in shapes:
            cells.append((a, s))
    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    # one fake world for every mesh of the run: the single-pod mesh takes
    # its first 256 ranks
    fake_world(512 if True in meshes else 256)
    failures = 0
    for mp in meshes:
        for a, s in cells:
            t0 = time.time()
            rec = run_cell(a, s, multi_pod=mp, scale=args.scale,
                           out_dir=args.out, force=args.force)
            status = rec["status"]
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f"dom={r['dominant']:<10} "
                         f"bound={r['roofline_bound_s']*1e3:8.2f}ms "
                         f"fit={rec['memory']['fits_hbm']}")
            elif status == "error":
                failures += 1
                extra = rec["error"][:120]
            print(f"[{'2x16x16' if mp else '16x16'}] {a:22s} {s:12s} "
                  f"{status:8s} {time.time()-t0:6.1f}s {extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells FAILED")


if __name__ == "__main__":
    main()

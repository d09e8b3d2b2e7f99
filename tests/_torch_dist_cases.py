"""Rank programs of tests/test_torch_distributed.py: each case runs on a
world of gloo ranks started here (``python -m tests._torch_dist_cases CASE
DIR WORLD``), reads its inputs from DIR/in.pt and rank 0 writes what the
test compares to DIR/out.pt. The test process never joins a process group
itself (``init_process_group`` is process-wide).

``PYTHONPATH=src python tests/_torch_dist_cases.py check`` runs the train
and serve cases against the unsharded port with no JAX (``check``): the
way to hold DTensor's behaviour under another torch, on a machine without
the reference (run by path: an installed ``tests`` package would shadow
``-m tests.``)."""

import os
import socket
import sys
import warnings

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _numpy_tree(tree):
    from repro_torch.bridge import tree_map
    return tree_map(lambda t: _full(t).detach().float().numpy(), tree)


def train(inp, mesh):
    """One ``make_train_step`` step of the 2x2-sharded state: the plan
    from the state, ``train_state_specs``, the batch split on the data
    axis (``distribute_batch``), two microbatches; counts of the qwhole
    path, the sharded MoE layer and the scans' DTensor routes."""
    import repro_torch.models.attention as A
    import repro_torch.models.moe as M
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import make_plan
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.planner import distribute_tree
    from repro_torch.training.optimizer import AdamWHyper
    from repro_torch.training.train_step import (distribute_batch,
                                                 make_train_step,
                                                 train_state_specs)
    cfg, state, batch = inp["cfg"], inp["state"], inp["batch"]
    calls = {}
    _count(A, "qwhole_attention", calls, "qwhole")
    _count(M, "_sharded", calls, "moe")
    _count_scans(calls)
    b, s = batch["tokens"].shape
    plan = make_plan(cfg, mesh, "train", batch=b, seq=s,
                     param_tree=state.params)
    dstate = distribute_tree(state, train_state_specs(plan, state), mesh)
    step = make_train_step(LM(cfg), hyper=AdamWHyper(warmup_steps=1),
                           microbatches=2, compute_dtype=torch.float32)
    with use_mesh(mesh):
        new, metrics = step(dstate, distribute_batch(batch, plan, mesh,
                                                     2))
    layers = dstate.params["layers"]
    moe = layers.get("moe", {}) if isinstance(layers, dict) else {}
    return {"params": _numpy_tree(new.params),
            "m": _numpy_tree(new.opt["m"]), "v": _numpy_tree(new.opt["v"]),
            "loss": float(_full(metrics["loss"])),
            "grad_norm": float(_full(metrics["grad_norm"])),
            "notes": plan.notes, "qwhole": calls["qwhole"],
            "moe": calls["moe"], "calls": calls,
            "placements": {k: _dims(v) for k, v in moe.items()}}


def _count_scans(calls):
    """Count the scan kernels' DTensor routes (forward and backward)."""
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    for mod, name in ((RS, "rglru_scan"), (SC, "ssd_chunk")):
        _count(mod, "_sharded", calls, name)
        _count(mod, "_sharded_bwd", calls, name + "_bwd")


def _dims(t):
    """The tensor dim each mesh dim splits of a DTensor (None: not
    split)."""
    return [p.dim if p.is_shard() else None for p in t.placements]


def _count(module, name, calls, key):
    """Count the calls of ``module.name`` in ``calls[key]``."""
    real = getattr(module, name)
    calls[key] = 0

    def counted(*a, **k):
        calls[key] += 1
        return real(*a, **k)
    setattr(module, name, counted)


def serve(inp, mesh):
    """A prefill and greedy decode steps of the 2x2-sharded model (the
    plan's param and cache layouts); counts of the sequence-sharded
    decode, the sharded MoE layer, banded prefill and ring decode."""
    import repro_torch.models.attention as A
    import repro_torch.models.moe as M
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import make_plan
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.planner import distribute, distribute_tree
    cfg, params, tokens = inp["cfg"], inp["params"], inp["tokens"]
    steps, max_len = inp["steps"], inp["max_len"]
    calls = {}
    _count(A, "seq_sharded_decode", calls, "seq")
    _count(A, "banded_sharded", calls, "banded")
    _count(A, "_ring_attention_sharded", calls, "ring")
    _count(M, "_sharded", calls, "moe")
    lm = LM(cfg)
    b = tokens.shape[0]
    plan = make_plan(cfg, mesh, "decode", batch=b, seq=max_len,
                     param_tree=params,
                     cache_tree=lm.init_cache(b, max_len, device="meta"))
    dparams = distribute_tree(params, plan.param_specs, mesh)
    tok_spec = plan.batch_specs["tokens"]
    logits, toks = [], []
    with torch.no_grad(), use_mesh(mesh):
        lg, cache = lm.prefill(dparams, {"tokens": distribute(
            tokens, tok_spec, mesh)}, max_len)
        layout = [p.dim if p.is_shard() else None
                  for p in cache["layers"]["k"].placements]
        lg = _full(lg)
        logits.append(lg.numpy())
        t = lg.argmax(-1)[:, None].to(torch.int32)
        for _ in range(steps):
            toks.append(t.numpy())
            lg, cache = lm.decode_step(dparams, cache,
                                       distribute(t, tok_spec, mesh))
            lg = _full(lg)[:, 0]
            logits.append(lg.numpy())
            t = lg.argmax(-1)[:, None].to(torch.int32)
    return {"logits": logits, "tokens": toks, "seq_sharded": calls["seq"],
            "calls": calls, "cache_layout": layout, "notes": plan.notes}


def rec_serve(inp, mesh):
    """The recurrent families' serving on the 2x2 mesh: a prefill of a
    right-padded bucket (``length`` < s), then greedy decode steps, row
    ``inactive[0]`` inactive in the steps ``inactive[1]``; the logits,
    tokens, each step's cache (gathered) and the cache's layout."""
    import repro_torch.models.attention as A
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import make_plan
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.planner import distribute, distribute_tree
    cfg, params, tokens = inp["cfg"], inp["params"], inp["tokens"]
    calls = {}
    _count(A, "banded_sharded", calls, "banded")
    _count(A, "_ring_attention_sharded", calls, "ring")
    _count_scans(calls)
    lm = LM(cfg)
    b = tokens.shape[0]
    plan = make_plan(cfg, mesh, "decode", batch=b, seq=inp["max_len"],
                     param_tree=params, cache_tree=lm.init_cache(
                         b, inp["max_len"], device="meta"))
    dparams = distribute_tree(params, plan.param_specs, mesh)
    spec = plan.batch_specs["tokens"]
    out = {"logits": [], "tokens": [], "caches": []}
    with torch.no_grad(), use_mesh(mesh):
        lg, cache = lm.prefill(dparams, {"tokens": distribute(
            tokens, spec, mesh), "length": inp["length"]}, inp["max_len"])
        out["layout"] = _layouts(cache["layers"])
        for i in range(inp["steps"] + 1):
            lg = _full(lg).reshape(b, -1)
            out["logits"].append(lg.numpy())
            out["caches"].append(_numpy_tree(cache["layers"]))
            if i == inp["steps"]:
                break
            t = lg.argmax(-1)[:, None].to(torch.int32)
            out["tokens"].append(t.numpy())
            active = None
            if i in inp["inactive"][1]:
                active = torch.arange(b) != inp["inactive"][0]
            lg, cache = lm.decode_step(dparams, cache,
                                       distribute(t, spec, mesh),
                                       active=active)
    out["calls"] = calls
    return out


def plain_rec_serve(cfg, params, tokens, length, max_len, steps,
                    inactive):
    """``rec_serve``'s prefill and greedy steps on the unsharded port:
    (logits, tokens, each step's cache as numpy)."""
    from repro_torch.bridge import tree_map
    from repro_torch.models.transformer import LM
    lm = LM(cfg)
    b = tokens.shape[0]
    logits, toks, caches = [], [], []
    with torch.no_grad():
        lg, cache = lm.prefill(params, {"tokens": tokens, "length": length},
                               max_len)
        for i in range(steps + 1):
            lg = lg.reshape(b, -1)
            logits.append(lg.numpy())
            caches.append(tree_map(lambda t: t.numpy().copy(),
                                   cache["layers"]))
            if i == steps:
                break
            t = lg.argmax(-1)[:, None].to(torch.int32)
            toks.append(t.numpy())
            active = None
            if i in inactive[1]:
                active = torch.arange(b) != inactive[0]
            lg, cache = lm.decode_step(params, cache, t, active=active)
    return logits, toks, caches


def scans(inp, mesh):
    """The scan kernels' DTensor routes on the 2x2 mesh (batch over data,
    heads or channels over model) against their plain versions, f64: for
    each case of ``inp["ssd"]`` (groups of B and C, heads) ``ssd_chunk``'s
    outputs and, by autograd through it, every input's gradient, then
    ``ssd_chunk_bwd`` called on DTensors; the same for ``rglru_scan``.
    Returns each case's largest absolute difference and the gradients'
    placements."""
    from repro_torch.kernels.rglru_scan import rglru_scan as RS
    from repro_torch.kernels.ssd_chunk import ssd_chunk as SC
    from repro_torch.sharding.planner import Spec, distribute
    g = torch.Generator().manual_seed(0)
    f64 = torch.float64
    out = {}

    def err(got, want):
        return max(float((_full(a) - w).abs().max())
                   for a, w in zip(got, want))

    for ng, nh in inp["ssd"]:
        b, l, hp, n, Q = 2, 40, 4, 8, 16
        t = {"x": torch.randn(b, l, nh, hp, generator=g, dtype=f64),
             "dt": torch.rand(b, l, nh, generator=g, dtype=f64) * 0.5,
             "A": -torch.rand(nh, generator=g, dtype=f64),
             "B": torch.randn(b, l, ng, n, generator=g, dtype=f64),
             "C": torch.randn(b, l, ng, n, generator=g, dtype=f64),
             "S0": torch.randn(b, nh, hp, n, generator=g, dtype=f64)}
        dy = torch.randn(b, l, nh, hp, generator=g, dtype=f64)
        dS = torch.randn(b, nh, hp, n, generator=g, dtype=f64)
        spec = {"x": Spec("data", None, "model", None),
                "dt": Spec("data", None, "model"), "A": Spec(None),
                "B": Spec("data", None, None, None),
                "C": Spec("data", None, None, None),
                "S0": Spec("data", "model", None, None)}
        plain = [v.clone().requires_grad_() for v in t.values()]
        y, Sf = SC.ssd_chunk(*plain, Q)
        ((y * dy).sum() + (Sf * dS).sum()).backward()
        dist_in = [distribute(v, spec[k], mesh).requires_grad_()
                   for k, v in t.items()]
        dyd = distribute(dy, spec["x"], mesh)
        dSd = distribute(dS, spec["S0"], mesh)
        y2, Sf2 = SC.ssd_chunk(*dist_in, Q)
        ((y2 * dyd).sum() + (Sf2 * dSd).sum()).backward()
        bwd = SC.ssd_chunk_bwd(*[v.detach() for v in dist_in], dyd, dSd, Q)
        out[f"ssd g {ng} nh {nh}"] = {
            "forward": err((y2, Sf2), (y, Sf)),
            "grads": err([v.grad for v in dist_in],
                         [v.grad for v in plain]),
            "bwd": err(bwd, SC.ssd_chunk_bwd_ref(*t.values(), dy, dS, Q)),
            "sel": str(SC._layout(dist_in[0], dist_in[3]).group_sel)}
    a = torch.rand(2, 33, 16, generator=g, dtype=f64)
    bb = torch.randn(2, 33, 16, generator=g, dtype=f64)
    h0 = torch.randn(2, 16, generator=g, dtype=f64)
    dh = torch.randn(2, 33, 16, generator=g, dtype=f64)
    plain = [v.clone().requires_grad_() for v in (a, bb, h0)]
    (RS.rglru_scan(*plain) * dh).sum().backward()
    seq = Spec("data", None, "model")
    dist_in = [distribute(a, seq, mesh).requires_grad_(),
               distribute(bb, seq, mesh).requires_grad_(),
               h0.clone().requires_grad_()]
    h2 = RS.rglru_scan(*dist_in)
    (h2 * distribute(dh, seq, mesh)).sum().backward()
    bwd = RS.rglru_scan_bwd(dist_in[0].detach(), h2.detach(),
                            distribute(h0, Spec("data", "model"), mesh),
                            distribute(dh, seq, mesh))
    out["rglru"] = {
        "forward": err((h2,), (RS.rglru_scan(a, bb, h0),)),
        "grads": err([v.grad for v in dist_in], [v.grad for v in plain]),
        "bwd": err(bwd, RS.rglru_scan_bwd_ref(a, RS.rglru_scan(a, bb, h0),
                                              h0, dh))}
    return out


def _layouts(tree):
    """The tensor dim each mesh dim splits of every DTensor of a tree."""
    from repro_torch.bridge import tree_map
    return tree_map(_dims, tree)


def pipeline(inp, mesh):
    """``pipeline_forward`` of the stacked layers over the ``pipe`` dim."""
    from repro_torch.sharding.pipeline import (pipeline_forward,
                                               stage_params_from_stack)
    w, x = inp["w"], inp["x"]
    n = mesh.size(0)

    def stage_fn(stage_w, h):          # stage_w: [L/S, D, D]
        for p in stage_w:
            h = torch.tanh(h @ p)
        return h

    f = pipeline_forward(stage_fn, mesh, num_microbatches=x.shape[0],
                         axis="pipe")
    return {"out": f(stage_params_from_stack(w, n), x).numpy()}


def production(inp, mesh):
    """``launch.train.train(..., production_mesh=True)`` with this 2x2
    mesh standing in for the 16x16 production mesh: the launcher plans
    and distributes the state itself. Returns its losses and the layout
    of the state it ran."""
    import repro_torch.launch.mesh as LMESH
    import repro_torch.launch.train as T
    seen = {}
    real = T._production

    def production_(*a, **k):
        out = real(*a, **k)
        seen["placements"] = {
            k: _dims(v) for k, v in out[2].params["layers"]["moe"].items()}
        return out
    T._production = production_
    LMESH.make_production_mesh = lambda **k: mesh
    _, losses = T.train(inp["arch"], smoke=True, steps=inp["steps"],
                        batch=inp["batch"], seq=inp["seq"],
                        production_mesh=True, device="cpu", log_every=1000)
    return {"losses": losses, "placements": seen["placements"]}


CASES = {"train": (train, (2, 2), ("data", "model")),
         "rec_serve": (rec_serve, (2, 2), ("data", "model")),
         "scans": (scans, (2, 2), ("data", "model")),
         "production": (production, (2, 2), ("data", "model")),
         "serve": (serve, (2, 2), ("data", "model")),
         "pipeline": (pipeline, (4,), ("pipe",))}


def _rank(rank, world, case, folder, port):
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_test_mesh
        fn, shape, axes = CASES[case]
        mesh = make_test_mesh(shape, axes, device_type="cpu")
        inp = torch.load(os.path.join(folder, "in.pt"), weights_only=False)
        out = fn(inp, mesh)
        if rank == 0:
            torch.save(out, os.path.join(folder, "out.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(case, folder, world=4):
    mp.spawn(_rank, args=(world, case, folder, _free_port()), nprocs=world)
    return torch.load(os.path.join(folder, "out.pt"), weights_only=False)


def check(step_tol: float = 5e-5, tol: float = 1e-5,
          loss_tol: float = 2e-2) -> None:
    """The train and serve cases against the unsharded port alone (no
    JAX: seeded port weights), for a machine without the reference whose
    torch differs: ``python tests/_torch_dist_cases.py check``. A step's params within
    ``step_tol`` of each leaf's largest (the port's train-step tolerance,
    PERF.md §2: with other weights than the test's, AdamW's division can
    turn a gradient's last-bit difference into more), logits within
    ``tol``, tokens equal. The dense cases (minitron-8b's smoke config),
    then the MoE ones (qwen3-moe's: expert parallel, expert-TP, flattened
    decode with capacity drops, int8 experts; mixtral's with its ring
    split on S), the recurrent ones (recurrentgemma-2b's and mamba2-1.3b's
    at one and two groups: a train step, then a right-padded prefill and
    decode with an inactive row, ``rec_serve``) and the production
    launcher's bf16 steps, whose losses must be the unsharded launcher's
    within ``loss_tol``. Exits 1 on a mismatch."""
    import dataclasses
    import tempfile
    from repro_torch.bridge import leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import LM
    from repro_torch.training.optimizer import AdamWHyper
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    bad = []
    for name, arch, over, seq, rows, prompt, steps, q8 in (
            ("heads", "minitron-8b", {}, 32, 4, 8, 6, False),
            ("qwhole", "minitron-8b", {"num_heads": 3, "num_kv_heads": 1},
             32, 4, 8, 6, False),
            ("kv_group_split", "minitron-8b", {"num_kv_heads": 1}, 32, 4, 8,
             6, False),
            ("moe_ep", "qwen3-moe-30b-a3b", {}, 32, 4, 8, 6, False),
            ("moe_expert_tp", "qwen3-moe-30b-a3b", {"num_experts": 3}, 32,
             4, 8, 6, False),
            ("moe_ep_rows", "qwen3-moe-30b-a3b", {}, 64, 4, 8, 6, False),
            ("moe_drops", "qwen3-moe-30b-a3b", {"moe_capacity_factor": 0.5},
             0, 16, 8, 6, False),
            ("moe_int8", "qwen3-moe-30b-a3b", {}, 0, 4, 8, 6, True),
            ("mixtral_seq_ring", "mixtral-8x7b", {"num_kv_heads": 1}, 0, 4,
             40, 24, False),
            ("rec_hybrid", "recurrentgemma-2b", {}, 32, 4, 40, 12, False),
            ("rec_ssm", "mamba2-1.3b", {}, 32, 4, 24, 8, False),
            ("rec_ssm_groups", "mamba2-1.3b", {"ssm_ngroups": 2}, 32, 4,
             24, 6, False)):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  dtype="float32", **over)
        g = torch.Generator().manual_seed(3)
        tokens = torch.randint(0, cfg.vocab_size, (rows, max(seq, prompt)),
                               generator=g, dtype=torch.int32)
        serve = _check_rec_serve if name.startswith("rec_") \
            else _check_serve
        if not seq:
            tokens = tokens[:, :prompt].contiguous()
            bad += serve(name, cfg, tokens, steps, q8, tol)
            continue
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        with tempfile.TemporaryDirectory() as d:
            torch.save({"cfg": cfg, "batch": batch,
                        "state": init_train_state(LM(cfg), 0,
                                                  device="cpu")},
                       os.path.join(d, "in.pt"))
            out = _spawn("train", d)
        want, _ = make_train_step(
            LM(cfg), hyper=AdamWHyper(warmup_steps=1), microbatches=2,
            compute_dtype=torch.float32)(
                init_train_state(LM(cfg), 0, device="cpu"), batch)
        err = max(float(abs(torch.tensor(a) - b).max() / b.abs().max())
                  for a, b in zip(leaves(out["params"]),
                                  leaves(want.params)))
        print(f"[check] train {name}: params within {err:.2e} of each "
              f"leaf's largest; qwhole calls {out['qwhole']}", flush=True)
        if err > step_tol:
            bad.append(f"train {name}")
        bad += serve(name, cfg, tokens[:, :prompt].contiguous(), steps, q8,
                     tol)
    from repro_torch.launch.train import train as launch
    inp = {"arch": "qwen3-moe-30b-a3b", "steps": 2, "batch": 4, "seq": 64}
    with tempfile.TemporaryDirectory() as d:
        torch.save(inp, os.path.join(d, "in.pt"))
        out = _spawn("production", d)
    _, want = launch(inp["arch"], smoke=True, steps=inp["steps"],
                     batch=inp["batch"], seq=inp["seq"], device="cpu",
                     log_every=1000)
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], want))
    print(f"[check] production qwen3-moe smoke: losses {out['losses']} vs "
          f"unsharded {want} ({rel:.2e}); w_gate split on dims "
          f"{out['placements']['w_gate']}", flush=True)
    if rel > loss_tol:
        bad.append("production")
    print(f"[check] torch {torch.__version__}: "
          + ("every case matches" if not bad else f"FAILED {bad}"),
          flush=True)
    if bad:
        sys.exit(1)


def _check_serve(name, cfg, prompt, steps, q8, tol) -> list:
    """The serve case of ``cfg`` (int8 weights if ``q8``) against the
    unsharded port: [] if tokens equal and logits within ``tol``."""
    import tempfile
    from repro_torch.models.quant import quantize_tree
    from repro_torch.models.transformer import LM
    lm = LM(cfg)
    params = lm.init(0, device="cpu")
    if q8:
        params = quantize_tree(params)
    max_len = 32 if prompt.shape[1] < 32 else 64
    with tempfile.TemporaryDirectory() as d:
        torch.save({"cfg": cfg, "params": params, "tokens": prompt,
                    "steps": steps, "max_len": max_len},
                   os.path.join(d, "in.pt"))
        out = _spawn("serve", d)
    with torch.no_grad():
        lg, cache = lm.prefill(params, {"tokens": prompt}, max_len)
        errs, same = [abs(torch.tensor(out["logits"][0]) - lg).max()], True
        t = lg.argmax(-1)[:, None].to(torch.int32)
        for i in range(steps):
            same &= bool((torch.tensor(out["tokens"][i]) == t).all())
            lg, cache = lm.decode_step(params, cache, t)
            errs.append(abs(torch.tensor(out["logits"][i + 1])
                            - lg[:, 0]).max())
            t = lg[:, 0].argmax(-1)[:, None].to(torch.int32)
    err = float(max(errs))
    print(f"[check] serve {name}: tokens equal {same}, logits within "
          f"{err:.2e}; sharded calls {out['calls']}; cache layout "
          f"{out['cache_layout']}", flush=True)
    return [] if same and err <= tol else [f"serve {name}"]


def _check_rec_serve(name, cfg, prompt, steps, q8, tol) -> list:
    """The ``rec_serve`` case of a recurrent ``cfg`` against the unsharded
    port: the prompt right-padded (its true length 5 short), row 1
    inactive in steps 2 and 3; [] if tokens equal and logits and every
    step's cache within ``tol`` (of each leaf's largest, at least 1)."""
    import tempfile
    from repro_torch.bridge import leaves
    from repro_torch.models.transformer import LM
    params = LM(cfg).init(0, device="cpu")
    inp = {"cfg": cfg, "params": params, "tokens": prompt,
           "length": prompt.shape[1] - 5, "max_len": 64, "steps": steps,
           "inactive": (1, (2, 3))}
    with tempfile.TemporaryDirectory() as d:
        torch.save(inp, os.path.join(d, "in.pt"))
        out = _spawn("rec_serve", d)
    logits, toks, caches = plain_rec_serve(
        cfg, params, prompt, inp["length"], 64, steps, inp["inactive"])
    same = all((a == b).all() for a, b in zip(out["tokens"], toks))
    err = max(float(abs(a - b).max()) for a, b in zip(out["logits"],
                                                       logits))
    cerr = max(float(abs(g - w).max() / max(float(abs(w).max()), 1.0))
               for got, want in zip(out["caches"], caches)
               for g, w in zip(leaves(got), leaves(want)))
    print(f"[check] serve {name}: tokens equal {same}, logits within "
          f"{err:.2e}, caches within {cerr:.2e}; sharded calls "
          f"{out['calls']}", flush=True)
    return [] if same and max(err, cerr) <= tol else [f"serve {name}"]


def main():
    if sys.argv[1] == "check":
        check()
        return
    case, folder, world = sys.argv[1], sys.argv[2], int(sys.argv[3])
    _spawn(case, folder, world)


if __name__ == "__main__":
    main()

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
    axis, two microbatches; counts of the qwhole path."""
    import repro_torch.models.attention as A
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import make_plan
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.planner import distribute, distribute_tree
    from repro_torch.training.optimizer import AdamWHyper
    from repro_torch.training.train_step import (make_train_step,
                                                 train_state_specs)
    cfg, state, batch = inp["cfg"], inp["state"], inp["batch"]
    calls = {"qwhole": 0}
    real = A.qwhole_attention

    def counted(*a, **k):
        calls["qwhole"] += 1
        return real(*a, **k)
    A.qwhole_attention = counted
    b, s = batch["tokens"].shape
    plan = make_plan(cfg, mesh, "train", batch=b, seq=s,
                     param_tree=state.params)
    dstate = distribute_tree(state, train_state_specs(plan, state), mesh)
    step = make_train_step(LM(cfg), hyper=AdamWHyper(warmup_steps=1),
                           microbatches=2, compute_dtype=torch.float32)
    with use_mesh(mesh):
        new, metrics = step(dstate, {k: distribute(v, plan.batch_specs[k],
                                                   mesh)
                                     for k, v in batch.items()})
    return {"params": _numpy_tree(new.params),
            "m": _numpy_tree(new.opt["m"]), "v": _numpy_tree(new.opt["v"]),
            "loss": float(_full(metrics["loss"])),
            "grad_norm": float(_full(metrics["grad_norm"])),
            "notes": plan.notes, "qwhole": calls["qwhole"]}


def serve(inp, mesh):
    """A prefill and greedy decode steps of the 2x2-sharded model (the
    plan's param and cache layouts); counts of the sequence-sharded
    decode."""
    import repro_torch.models.attention as A
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import make_plan
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.planner import distribute, distribute_tree
    cfg, params, tokens = inp["cfg"], inp["params"], inp["tokens"]
    steps, max_len = inp["steps"], inp["max_len"]
    calls = {"seq": 0}
    real = A.seq_sharded_decode

    def counted(*a, **k):
        calls["seq"] += 1
        return real(*a, **k)
    A.seq_sharded_decode = counted
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
            "cache_layout": layout, "notes": plan.notes}


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


CASES = {"train": (train, (2, 2), ("data", "model")),
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


def check(step_tol: float = 5e-5, tol: float = 1e-5) -> None:
    """The train and serve cases against the unsharded port alone (no
    JAX: seeded port weights), for a machine without the reference whose
    torch differs: ``python tests/_torch_dist_cases.py check``. A step's params within
    ``step_tol`` of each leaf's largest (the port's train-step tolerance,
    PERF.md §2: with other weights than the test's, AdamW's division can
    turn a gradient's last-bit difference into more), logits within
    ``tol``, tokens equal. Exits 1 on a mismatch."""
    import dataclasses
    import tempfile
    from repro_torch.bridge import leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import LM
    from repro_torch.training.optimizer import AdamWHyper
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    bad = []
    for name, over in (("heads", {}),
                       ("qwhole", {"num_heads": 3, "num_kv_heads": 1}),
                       ("kv_group_split", {"num_kv_heads": 1})):
        cfg = dataclasses.replace(get_smoke_config("minitron-8b"),
                                  dtype="float32", **over)
        g = torch.Generator().manual_seed(3)
        tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=g,
                               dtype=torch.int32)
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
        lm = LM(cfg)
        params = lm.init(0, device="cpu")
        prompt = tokens[:, :8].contiguous()
        with tempfile.TemporaryDirectory() as d:
            torch.save({"cfg": cfg, "params": params, "tokens": prompt,
                        "steps": 6, "max_len": 32},
                       os.path.join(d, "in.pt"))
            out = _spawn("serve", d)
        with torch.no_grad():
            lg, cache = lm.prefill(params, {"tokens": prompt}, 32)
            errs, same = [abs(torch.tensor(out["logits"][0]) - lg).max()], \
                True
            t = lg.argmax(-1)[:, None].to(torch.int32)
            for i in range(6):
                same &= bool((torch.tensor(out["tokens"][i]) == t).all())
                lg, cache = lm.decode_step(params, cache, t)
                errs.append(abs(torch.tensor(out["logits"][i + 1])
                                - lg[:, 0]).max())
                t = lg[:, 0].argmax(-1)[:, None].to(torch.int32)
        err = float(max(errs))
        print(f"[check] serve {name}: tokens equal {same}, logits within "
              f"{err:.2e}; sequence-sharded decode calls "
              f"{out['seq_sharded']}", flush=True)
        if not same or err > tol:
            bad.append(f"serve {name}")
    print(f"[check] torch {torch.__version__}: "
          + ("every case matches" if not bad else f"FAILED {bad}"),
          flush=True)
    if bad:
        sys.exit(1)


def main():
    if sys.argv[1] == "check":
        check()
        return
    case, folder, world = sys.argv[1], sys.argv[2], int(sys.argv[3])
    _spawn(case, folder, world)


if __name__ == "__main__":
    main()

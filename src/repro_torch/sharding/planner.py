"""Sharding planner: logical-axis rules -> per-leaf specs per (arch × step),
the port of the reference's ``repro.sharding.planner``.

Parallelism mapping (the reference's):

* ``data`` (and ``pod`` when multi-pod) — data parallelism; for training the
  params/optimizer are additionally sharded over ``data`` (FSDP/ZeRO-3).
* ``model`` — tensor parallelism: attention heads / d_ff / vocab when the
  dimension divides the axis; expert parallelism for MoE when the expert
  count divides; otherwise divisibility-aware fallbacks (e.g. sequence-
  sharded KV caches -> distributed flash-decode softmax).

The planner only states *intent*: a ``Spec`` per leaf, the counterpart of
the reference's ``PartitionSpec``. Where the reference hands its specs to
GSPMD, the port turns each into DTensor placements on a ``DeviceMesh``
(``placements``) and the model's DTensor ops, its ``constrain`` hints and
the kernel wrappers' ``local_map`` carry out the collectives.

A mesh here is a torch ``DeviceMesh`` (axis names from its
``mesh_dim_names``) or any object with ``axis_names`` and a ``shape``
mapping of axis name to size (the pure rules need nothing else).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from typing import TYPE_CHECKING

if TYPE_CHECKING:     # the models package imports this one (constrain)
    from repro_torch.models.config import ModelConfig


class Spec(tuple):
    """Per-dim mesh-axis names of one leaf: each entry is None (not
    sharded), an axis name, or a tuple of axis names (one tensor dim over
    several mesh axes, major first). The port's ``PartitionSpec``."""

    def __new__(cls, *dims):
        # a one-axis tuple is that axis, as PartitionSpec normalises it
        return super().__new__(cls, (d[0] if isinstance(d, tuple)
                                     and len(d) == 1 else d for d in dims))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a mesh-like object."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    return tuple(axis_sizes(mesh))


def data_axes(mesh):
    """The batch-sharding axis (pod+data when multi-pod)."""
    if "pod" in axis_names(mesh):
        return ("pod", "data")
    return ("data",)


def _axis_size(mesh, name) -> int:
    sizes = axis_sizes(mesh)
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= sizes[a]
        return n
    return sizes[name]


def _div(n: int, mesh, axis) -> bool:
    return n > 0 and n % _axis_size(mesh, axis) == 0


def _fit_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop any sharded dim whose size doesn't divide its mesh axes — the
    reference's jit in_shardings require exact divisibility (no implicit
    padding), and DTensor's even sharding keeps the same layout."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for n, d in zip(shape, dims):
        if d is None:
            out.append(None)
        elif n % _axis_size(mesh, d) == 0:
            out.append(d)
        else:
            out.append(None)
    return Spec(*out)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: a mesh dim named in the
    spec's entry for tensor dim d is ``Shard(d)`` (a dim over ("pod",
    "data") is ``Shard(d)`` on both mesh dims, the major one first, as the
    reference lays it out); every other mesh dim, and a mesh dim of one
    rank (where a split is the whole dim, and DTensor would refuse views
    that merge it), is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name, size in axis_sizes(mesh).items():
        pl = Replicate()
        for d, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if name in names and size > 1:
                pl = Shard(d)
        out.append(pl)
    return tuple(out)


def spec_of(placements_, mesh, ndim: int) -> Spec:
    """The inverse of ``placements``: the spec a tensor of rank ``ndim``
    with these DTensor placements on ``mesh`` carries."""
    per = [[] for _ in range(ndim)]
    for name, pl in zip(axis_names(mesh), placements_):
        if pl.is_shard():
            per[pl.dim % ndim].append(name)
    return Spec(*(None if not n else n[0] if len(n) == 1 else tuple(n)
                  for n in per))


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, tuple, list))


def tree_map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and a tree of the same
    structure (dicts by key, tuples and lists in order)."""
    if isinstance(specs, Spec):
        return fn(specs, tree)
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: tree_map_specs(fn, specs[k], tree[k]) for k in specs}
    out = [tree_map_specs(fn, s, t) for s, t in zip(specs, tree)]
    return type(specs)(*out) if hasattr(specs, "_fields") \
        else type(specs)(out)


def _flatten_with_path(tree, prefix=()):
    """(path parts, leaf) of a dict/tuple tree, dict keys sorted (the order
    ``jax.tree_util.tree_flatten_with_path`` walks a dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _flatten_with_path(t, prefix + (str(i),))
    else:
        yield prefix, tree


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def distribute(t, spec: Spec, mesh, *, device=None, dtype=None):
    """``t`` as a DTensor on ``mesh`` laid out by ``spec``, with no
    communication: every rank holds the same whole ``t`` (drawn from one
    seed) and keeps a copy of its own shard (on a mesh of one rank, ``t``
    itself). A tensor on the ``meta`` device, or a
    fake one, becomes a DTensor whose shard is an empty tensor of the
    shard's shape on the mesh's device (the dry run's shapes-only state).
    Dims split unevenly are not taken: ``_fit_spec`` keeps specs even.
    ``device``, ``dtype``: where given, the shard is cut on ``t``'s device
    and only the shard moved and cast (a checkpoint's leaf read on the
    host goes to the card one rank's share at a time)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels.sharded import (contiguous_stride, is_fake,
                                             shard_span)
    pls = placements(spec, mesh)
    shape = tuple(t.shape)
    spans = [shard_span(mesh, pls, d, n) for d, n in enumerate(shape)]
    if t.device.type == "meta" or is_fake(t):
        import torch
        local = torch.empty(tuple(n for _, n in spans), dtype=t.dtype,
                            device=mesh.device_type)
    else:
        local = t
        for d, (start, n) in enumerate(spans):
            if n != shape[d]:
                local = local.narrow(d, start, n)
        if local is not t:          # a shard of its own, not a view of t
            local = local.contiguous()
        if device is not None or dtype is not None:
            local = local.to(device=device, dtype=dtype)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def zeros(shape, dtype, spec: Spec, mesh):
    """A zeroed DTensor of ``shape`` laid out by ``spec``: each rank
    allocates its own shard only."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels.sharded import contiguous_stride, shard_span
    pls = placements(spec, mesh)
    local = torch.zeros(tuple(shard_span(mesh, pls, d, n)[1]
                              for d, n in enumerate(shape)), dtype=dtype,
                        device=mesh.device_type)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=tuple(shape),
                              stride=contiguous_stride(shape))


def distribute_tree(tree, specs, mesh):
    """``distribute`` over a tree and its spec tree (None leaves stay)."""
    return tree_map_specs(lambda s, t: None if t is None
                          else distribute(t, s, mesh), specs, tree)


@dataclass
class ShardingPlan:
    mesh: Any
    cfg: ModelConfig
    step_kind: str                       # train | prefill | decode
    param_specs: Any = None              # tree of Spec
    batch_specs: Any = None              # dict of Spec
    cache_specs: Any = None              # tree of Spec (decode)
    microbatches: int = 1
    notes: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _param_rule(path: str, shape, cfg: ModelConfig, mesh, train: bool,
                notes: list, fsdp=None) -> Spec:
    """Choose a Spec for one param leaf.

    ``path`` is the '/'-joined key path; leading 'layers' dims are the
    layer stack and always unsharded. ``fsdp``: extra axis to shard params
    over (training ZeRO-3, or weight-gathered serving for models too big
    for model-axis shards alone).
    """
    nd = len(shape)
    # hybrid 'layers' is a tuple of per-layer dicts — leaves are NOT stacked
    stacked = ((path.startswith("enc_layers")
                or (path.startswith("layers") and cfg.family != "hybrid"))
               and nd >= 2)

    def spec(*dims):
        if stacked:
            return Spec(None, *dims)
        return Spec(*dims)

    core = shape[1:] if stacked else shape
    parts = path.split("/")
    name = parts[-1]
    if name in ("q", "s") and len(parts) >= 2:
        # int8 weight-only serving: {q, s} inherit the base weight's rule
        # (_fit_spec drops axes the size-1 scale dims can't take)
        name = parts[-2]

    # --- embeddings / unembeddings ------------------------------------
    if name == "embed":
        # vocab-sharded ONLY: a (model, data) 2-D sharding makes the token
        # gather un-partitionable (the reference observed ~25 GB/device of
        # rematerialised table under XLA) — vocab sharding keeps the gather
        # local per shard with a small all-reduce combine. Serving may trade
        # the per-step [b,s,d] all-reduce for a replicated table (lever:
        # serve_embed_replicated).
        if not train and cfg.serve_embed_replicated and not cfg.tie_embeddings:
            return Spec(None, None)
        return Spec("model", None)        # [V, d]
    if name == "lm_head":
        return Spec(fsdp, "model")        # [d, V]
    if name in ("adapter", "vision_adapter"):
        return Spec(fsdp, None)

    # --- MoE experts ------------------------------------------------------
    if name in ("w_gate", "w_up", "w_down") and len(core) == 3:
        E = core[0]
        if _div(E, mesh, "model"):        # expert parallelism
            return spec("model", fsdp, None)
        notes.append(f"{path}: E={E} not divisible by model axis; "
                     f"falling back to expert-TP over d_ff")
        if name == "w_down":              # [E, f, d]
            return spec(None, "model", fsdp)
        return spec(None, fsdp, "model")  # [E, d, f]
    if name == "router":
        return spec(fsdp, None)

    # --- attention projections -------------------------------------------
    if name in ("w_q", "w_k", "w_v"):
        # out dim is heads*hd; shard by model when the head count divides,
        # otherwise shard the d_model INPUT dim (weights stay distributed;
        # the projection output is a partial sum, all-reduced)
        heads = cfg.num_heads if name == "w_q" else cfg.num_kv_heads
        if _div(heads, mesh, "model"):
            return spec(fsdp, "model")
        if f"{name}: head-count fallback" not in " ".join(notes):
            notes.append(f"{name}: head-count fallback — {heads} heads not "
                         f"divisible by model axis; sharding d_model input dim")
        return spec("model", None)
    if name == "w_o":
        if _div(cfg.num_heads, mesh, "model"):
            return spec("model", fsdp)
        return spec(None, "model")

    # --- dense MLP ----------------------------------------------------------
    if name in ("w_gate", "w_up"):        # [d, f]
        return spec(fsdp, "model")
    if name == "w_down":                  # [f, d]
        return spec("model", fsdp)

    # --- SSM -----------------------------------------------------------------
    if name == "in_proj":                 # [d, 2di+2gn+nh]
        return spec(fsdp, "model")
    if name == "out_proj":                # [di, d]
        return spec("model", fsdp)
    if name == "conv":                    # [K, conv_dim]
        return spec(None, "model")

    # --- RG-LRU ---------------------------------------------------------------
    if name in ("w_x",):                  # [d, w]
        return spec(fsdp, "model")
    if name == "w_out":                   # [w, d]
        return spec("model", fsdp)
    if name == "lambda":
        return spec("model")
    if name in ("gate_a", "gate_i"):      # [nb, bs, bs]
        if _div(core[0], mesh, "model"):
            return spec("model", None, None)
        return spec(None, None, None)

    # --- 1-D / small leaves (norms, biases, A_log, D, dt_bias) --------------
    return spec(*([None] * len(core)))


def param_plan(cfg: ModelConfig, param_tree, mesh, *, train: bool,
               notes: list, serve_fsdp: bool = False):
    """Map a param tree (tensors, on ``meta`` or not) to Specs.

    ``serve_fsdp``: weight-gathered serving — when bf16 weights / model-axis
    shards exceed the per-card budget, params additionally shard over the
    data axes and are gathered per layer.
    """
    fsdp = None
    if train:
        fsdp = "data"
    elif serve_fsdp:
        fsdp = data_axes(mesh) if len(data_axes(mesh)) > 1 else "data"
    # notes follow the reference's leaf order (sorted keys), not the
    # tree's insertion order
    specs = {"/".join(kp): _fit_spec(
        _param_rule("/".join(kp), tuple(leaf.shape), cfg, mesh, train, notes,
                    fsdp=fsdp), tuple(leaf.shape), mesh)
        for kp, leaf in _flatten_with_path(param_tree)}
    return _map_with_path(lambda path, _: specs[path], param_tree)


# ---------------------------------------------------------------------------
# cache rules (decode state)
# ---------------------------------------------------------------------------

def cache_plan(cfg: ModelConfig, cache_tree, mesh, batch: int, notes: list):
    dp = data_axes(mesh)
    dp_ok = batch % _axis_size(mesh, dp) == 0

    def rule(path: str, shape) -> Spec:
        name = path.split("/")[-1]
        if name == "pos":
            return Spec()
        bdim = Spec(dp) if dp_ok else Spec(None)
        stacked = path.startswith("layers") and not cfg.family == "hybrid"
        # KV buffers: [L, b, S, kh, hd] (stacked) or [b, S, kh, hd] (hybrid)
        if name in ("k", "v", "cross_k", "cross_v"):
            kh = cfg.num_kv_heads
            want_heads = (cfg.kv_shard == "heads"
                          or (cfg.kv_shard == "auto"
                              and _div(kh, mesh, "model")))
            if want_heads and _div(kh, mesh, "model"):
                spec = (bdim[0] if dp_ok else None, None, "model", None)
            else:
                # sequence-sharded KV -> distributed decode softmax
                spec = (bdim[0] if dp_ok else None, "model", None, None)
                if "seq-sharded KV" not in " ".join(notes):
                    notes.append(f"kv_heads={kh} not divisible by model axis; "
                                 f"sequence-sharded KV cache")
            if stacked or name.startswith("cross"):
                return Spec(None, *spec)
            return Spec(*spec)
        if name == "ssm":                  # [L, b, nh, hp, n]
            nh = cfg.ssm_nheads
            tail = ("model", None, None) if _div(nh, mesh, "model") \
                else (None, None, None)
            return Spec(None, bdim[0] if dp_ok else None, *tail)
        if name == "conv":                 # [L, b, K-1, cd] or [b, K-1, w]
            w = shape[-1]
            tail = "model" if _div(w, mesh, "model") else None
            if cfg.family == "hybrid":
                return Spec(bdim[0] if dp_ok else None, None, tail)
            return Spec(None, bdim[0] if dp_ok else None, None, tail)
        if name == "h":                    # [b, w] (hybrid RG-LRU state)
            w = shape[-1]
            tail = "model" if _div(w, mesh, "model") else None
            return Spec(bdim[0] if dp_ok else None, tail)
        return Spec(*([None] * len(shape)))

    specs = {"/".join(kp): _fit_spec(rule("/".join(kp), tuple(leaf.shape)),
                                     tuple(leaf.shape), mesh)
             for kp, leaf in _flatten_with_path(cache_tree)}
    return _map_with_path(lambda path, _: specs[path], cache_tree)


# ---------------------------------------------------------------------------
# batch rules + microbatching
# ---------------------------------------------------------------------------

def batch_plan(cfg: ModelConfig, mesh, batch: int, notes: list):
    dp = data_axes(mesh)
    dp_ok = batch % _axis_size(mesh, dp) == 0
    b = dp if dp_ok else None
    if not dp_ok:
        notes.append(f"global_batch={batch} smaller than data axes; "
                     f"batch replicated (long-context single-session shape)")
    specs = {"tokens": Spec(b, None), "labels": Spec(b, None)}
    if cfg.frontend == "vision":
        specs["vision_embeds"] = Spec(b, None, None)
    if cfg.family == "encdec":
        specs["frames"] = Spec(b, None, None)
    return specs


def pick_microbatches(cfg: ModelConfig, mesh, batch: int, seq: int,
                      budget_bytes: float = 4e9) -> int:
    """Grad-accumulation factor: keep per-device checkpointed residuals
    (L × bµ_local × s × d × 2B) under ``budget_bytes``."""
    dp = _axis_size(mesh, data_axes(mesh))
    b_loc = max(1, batch // dp)
    L = cfg.num_layers + cfg.encoder_layers
    v_sharded = cfg.padded_vocab // axis_sizes(mesh).get("model", 1)

    def per_mb(mb):
        bmu = max(1, b_loc // mb)
        resid = L * bmu * seq * cfg.d_model * 2          # bf16 checkpoints
        logits = bmu * seq * v_sharded * 4               # f32 loss slab
        if cfg.family == "hybrid":
            # the reference's unrolled hybrid layers keep each layer's
            # backward TP all-reduce buffer live (f32 tuple of
            # residual-sized dx partials); the rule is kept for parity
            resid += L * bmu * seq * cfg.d_model * 8
        return resid + logits

    mb = 1
    while mb < b_loc and per_mb(mb) > budget_bytes:
        mb *= 2
    return min(mb, b_loc)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

#: per-card budget for serving weights before weight-gathered serving
#: kicks in. The reference gives a 16 GB chip 3.5 GB, leaving the rest to
#: the KV cache and temporaries; the H100 SXM5's 80 GB at the same share
#: (80 × 3.5 / 16) is 17.5 GB. The port's eager layers cast one layer's
#: weights at a time, so the reference's second reason, XLA's hoisted f32
#: copy of a whole scan-stacked weight, does not apply here.
SERVE_WEIGHT_BUDGET = 17.5e9


def make_plan(cfg: ModelConfig, mesh, step_kind: str, *, batch: int,
              seq: int, param_tree=None, cache_tree=None) -> ShardingPlan:
    notes: list = []
    plan = ShardingPlan(mesh=mesh, cfg=cfg, step_kind=step_kind)
    train = step_kind == "train"
    serve_fsdp = False
    if not train:
        model = axis_sizes(mesh)["model"]
        per_chip = cfg.param_count() * 2 / model
        if cfg.serve_fsdp_mode == "on":
            serve_fsdp = True
        elif cfg.serve_fsdp_mode == "off":
            serve_fsdp = False
        elif per_chip > SERVE_WEIGHT_BUDGET:
            serve_fsdp = True
            notes.append(
                f"weight-gathered serving: {per_chip/1e9:.1f} GB/chip of bf16 "
                f"weights at TP{model} exceeds the "
                f"{SERVE_WEIGHT_BUDGET/1e9:.0f} GB budget; params also "
                f"sharded over data axes")
    if param_tree is not None:
        plan.param_specs = param_plan(cfg, param_tree, mesh, train=train,
                                      notes=notes, serve_fsdp=serve_fsdp)
    plan.batch_specs = batch_plan(cfg, mesh, batch, notes)
    if cache_tree is not None:
        plan.cache_specs = cache_plan(cfg, cache_tree, mesh, batch, notes)
    if train:
        plan.microbatches = (cfg.train_microbatches or
                             pick_microbatches(cfg, mesh, batch, seq))
    plan.notes = notes
    return plan

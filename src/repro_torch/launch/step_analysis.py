"""What one distributed step costs each device: FLOPs, HBM bytes, wire bytes
of its collectives, peak memory, and the roofline terms they give.

The port's counterpart of the reference's ``repro.launch.hlo_analysis``
(roofline terms and the wire-cost model read off compiled HLO) and
``repro.launch.hlo_loops`` (trip-count multipliers for while-loop bodies,
which XLA's cost analysis counts once). The port has no HLO: its step is
eager PyTorch on DTensors. ``StepCounter`` watches the step run instead,
op by op, as each rank executes it (under ``FakeTensorMode`` in the dry
run, so at full scale without memory):

* FLOPs from ``torch.utils.flop_counter``'s formulas (the registry
  ``FlopCounterMode`` reads) on every local op, so the count is per device
  and includes work a layout repeats on several ranks, as the reference's
  per-device HLO count does. (``FlopCounterMode`` itself sees DTensor ops at
  their global shapes, and what runs inside ``local_map`` at local ones.)
* HBM bytes: each local op's operand and result bytes (views and metadata
  ops move none). Eager ops read and write HBM each time; there is no
  fusion to discount.
* Collectives: each ``_c10d_functional`` op's result bytes and group size,
  priced by the reference's wire-cost model per collective, and its link:
  NVLink for a group inside one 8-GPU node, InfiniBand for the rest.
* Peak memory: the bytes of the storages the step allocates, live at
  once, on top of its arguments (the counterpart of XLA's memory
  analysis; ``torch.distributed._tools.mem_tracker.MemTracker`` counts a
  DTensor's output at its global size, so the counter tracks the local
  storages itself).

The attention kernels are opaque to a dispatch mode: under fake tensors
their wrappers allocate their outputs and report the work the kernel would
do (``kernels.sharded.report_work``), which the counter adds.

An eager run counts every op it executes, loops included, so
``hlo_loops``' trip-count multipliers have no counterpart here.

Hardware constants are the H100 SXM5's, from NVIDIA's data sheet: 989e12
dense bf16 FLOP/s, 3.35e12 B/s of HBM3, 80 GB a card; NVLink 4 at 450 GB/s
a direction inside an 8-GPU node; a 400 Gb/s InfiniBand NDR port (50 GB/s a
direction) a GPU between nodes. Every figure this module gives is an
estimate from those constants, not a measurement.
"""

from __future__ import annotations

import os
import sys
import time
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12          # H100 SXM5 dense bf16 (data sheet)
HBM_BW = 3.35e12             # H100 SXM5 HBM3 (data sheet)
HBM_PER_CHIP = 80e9          # H100 SXM5 (data sheet)
NVLINK_BW = 450e9            # NVLink 4, one direction, inside a node
IB_BW = 50e9                 # InfiniBand NDR 400 Gb/s, one direction
NODE_GPUS = 8                # GPUs a node (HGX H100)

#: the reference's ring-algorithm wire cost per collective (B = result
#: bytes a device, n = participants)
_WIRE_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: float(n - 1),
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
    "collective-broadcast": lambda n: (n - 1) / n,
}

#: functional collective -> the reference's collective name
_COLLECTIVE = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::broadcast": "collective-broadcast",
}

#: DTensor's sharding propagation (its shape inference runs ops at global
#: shapes on fake tensors)
_PROPAGATION = os.path.join("distributed", "tensor", "_sharding_prop.py")

#: ops that move no bytes: views, metadata, allocation without writes
#: (``device``: ``prim::device``, a tensor's device query, which indexing
#: issues under a dispatch mode over fake tensors)
_NO_TRAFFIC = {
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "slice", "select", "as_strided", "alias", "detach",
    "unsqueeze", "squeeze", "unbind", "split", "split_with_sizes", "chunk",
    "narrow", "diagonal", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "_to_copy_noop", "lift_fresh",
    "wait_tensor", "_local_scalar_dense", "sym_size", "sym_stride",
    "is_same_size", "unfold", "view_as_real", "view_as_complex", "device",
}


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Bytes a device sends for one collective of ``kind`` (the
    reference's names) over ``n`` participants."""
    return _WIRE_FACTOR[kind](n) * result_bytes if n > 1 else 0.0


def link_bw(ranks) -> float:
    """The link a group rides: NVLink when every rank is in one node."""
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) <= 1 else IB_BW


@dataclass
class CollectiveStats:
    per_op: dict = field(default_factory=dict)   # kind -> count, bytes, wire
    wire_bytes_per_device: float = 0.0
    wire_seconds: float = 0.0                     # each on its own link

    def add(self, kind: str, result_bytes: float, ranks) -> None:
        n = len(ranks)
        if n <= 1:
            return
        wire = wire_bytes(kind, result_bytes, n)
        rec = self.per_op.setdefault(
            kind, {"count": 0, "result_bytes": 0, "wire_bytes": 0.0})
        rec["count"] += 1
        rec["result_bytes"] += result_bytes
        rec["wire_bytes"] += wire
        self.wire_bytes_per_device += wire
        self.wire_seconds += wire / link_bw(ranks)


@dataclass
class MemoryAnalysis:
    """Per-device bytes, the fields of XLA's memory analysis the
    reference's ``memory_report`` reads."""
    argument_size_in_bytes: float = 0.0
    output_size_in_bytes: float = 0.0
    temp_size_in_bytes: float = 0.0
    alias_size_in_bytes: float = 0.0


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of tensors and DTensors."""
    from torch.distributed.tensor import DTensor
    total = 0
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        if isinstance(leaf, torch.Tensor):
            total += _nbytes(leaf)
    return total


class StepCounter(TorchDispatchMode):
    """Counts a step's per-device FLOPs, HBM bytes, collectives and peak
    memory while it runs (see the module's docstring). DTensor ops are
    passed to DTensor (``NotImplemented``, as DTensor's own
    ``CommDebugMode`` does), so what the counter sees is what every rank
    runs on its local tensors, the collectives DTensor issues included."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives = CollectiveStats()
        self.kernels: dict = {}
        self.live = 0
        self.peak = 0
        self._seen: dict = {}

    # -- kernel wrappers' reports ----------------------------------------
    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        rec = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                             "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops += flops
        self.hbm_bytes += nbytes

    def __enter__(self):
        from repro_torch.kernels import sharded as SH
        SH.KERNEL_WORK_HOOKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import sharded as SH
        SH.KERNEL_WORK_HOOKS.remove(self._kernel)
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------
    def _free(self, key, n) -> None:
        if self._seen.pop(key, None) is not None:
            self.live -= n

    def _track(self, t) -> None:
        if t.device.type == "meta":      # shapes only: no memory
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._foreign(out):
            return out
        name = func._schema.name
        base = name.split("::")[-1]
        if name in _COLLECTIVE:
            self._collective(_COLLECTIVE[name], args, out)
        elif base not in _NO_TRAFFIC:
            ins = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            outs = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
            self.hbm_bytes += sum(_nbytes(a) for a in ins + outs)
            formula = self._formulas.get(func._overloadpacket)
            if formula is not None:
                self.flops += float(formula(*args, **kwargs, out_val=out))
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor):
                self._track(o)
        return out

    @staticmethod
    def _foreign(out) -> bool:
        """Whether the op runs inside DTensor's sharding propagation, which
        infers an op's output layout by running it on fake tensors at
        global shapes: work no rank does."""
        f = sys._getframe(2)
        while f is not None:
            if f.f_code.co_filename.endswith(_PROPAGATION):
                return True
            f = f.f_back
        return False

    def _collective(self, kind: str, args, out) -> None:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = next(a for a in reversed(args) if isinstance(a, str))
        ranks = dist.get_process_group_ranks(_resolve_process_group(group))
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        self.collectives.add(kind, sum(_nbytes(o) for o in outs), ranks)


def roofline_terms(cost: dict, collectives: CollectiveStats,
                   n_devices: int) -> dict:
    """The three roofline terms, in seconds (per step, per device), with
    the reference's keys. ``cost``: {"flops", "bytes accessed"} a device.
    The collective term prices each collective on its own link."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = collectives.wire_seconds
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    bound = max(compute_s, memory_s, collective_s)
    return {
        "flops_per_device": flops_dev,
        "flops_global": flops_dev * n_devices,
        "hbm_bytes_per_device": bytes_dev,
        "wire_bytes_per_device": collectives.wire_bytes_per_device,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "roofline_bound_s": bound,
        # fraction of the bound explained by compute — the "roofline
        # fraction" a perf pass tries to drive toward 1.0
        "compute_fraction_of_bound": (compute_s / bound) if bound > 0 else 0.0,
    }


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference)."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch  # decode: one token per sequence


def memory_report(mem_analysis) -> dict:
    """The reference's memory record from a ``MemoryAnalysis``."""
    g = lambda a: float(getattr(mem_analysis, a, 0) or 0)
    args = g("argument_size_in_bytes")
    temp = g("temp_size_in_bytes")
    out = g("output_size_in_bytes")
    alias = g("alias_size_in_bytes")
    peak = args + temp + out - alias
    return {
        "argument_bytes": args,
        "output_bytes": out,
        "temp_bytes": temp,
        "alias_bytes": alias,
        "peak_bytes_per_device": peak,
        "fits_hbm": bool(peak <= HBM_PER_CHIP),
        "hbm_per_chip": HBM_PER_CHIP,
    }


def analyze(run, arguments, n_devices: int):
    """Run ``run()`` under a ``StepCounter``; ``arguments`` is the tree of
    what the step takes (its bytes are the argument bytes). Returns
    (record pieces, the step's output): {"cost_analysis", "collectives",
    "memory", "roofline", "kernels", "step_s"}."""
    counter = StepCounter()
    t0 = time.time()
    with counter:
        out = run()
        held = counter.live        # what the step's outputs still hold
    step_s = time.time() - t0
    mem = MemoryAnalysis(argument_size_in_bytes=local_bytes(arguments),
                         output_size_in_bytes=held,
                         temp_size_in_bytes=counter.peak - held)
    cost = {"flops": counter.flops, "bytes accessed": counter.hbm_bytes}
    return {"cost_analysis": cost,
            "collectives": counter.collectives.per_op,
            "memory": memory_report(mem),
            "roofline": roofline_terms(cost, counter.collectives, n_devices),
            "kernels": counter.kernels,
            "step_s": step_s}, out

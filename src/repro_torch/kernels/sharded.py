"""DTensor layouts for the attention, expert and scan kernels' wrappers.

A kernel only ever sees local tensors: each wrapper's DTensor branch picks
the placements the kernel can take, redistributes its inputs to them
explicitly, and runs the kernel on every rank's shards through
``torch.distributed.tensor.experimental.local_map``. ``attention_layout``
makes that choice for a query tensor and its K/V, mesh dim by mesh dim:

* batch-sharded q -> K/V sharded on their batch dim the same way;
* head-sharded q (tensor parallelism) -> K/V head-sharded too when their
  heads split evenly, else K/V replicated, and each rank then hands the
  kernel the KV heads of its own query heads (``kv_heads``): under GQA a
  rank boundary may fall inside a KV group (minitron-8b's 32 query heads
  on 16 ranks against 8 KV heads: two query heads a rank, four a group);
* row-sharded q (sequence-parallel ``qwhole`` attention) -> K/V
  replicated, the rank's rows at their own positions (``row0``);
* anything else (a partial sum, a split head_dim, uneven shards) is
  redistributed: q to replicated, K/V to what q's layout needs.

Where K/V are replicated over a mesh dim on which q is split, each rank's
K/V gradient is a part of the whole: ``kv_grad`` says so (``Partial``), so
autograd sums the parts.

``scan_layout`` makes the choice for the sequence scans (``rglru_scan``,
``ssd_chunk``), whose steps run in order along the sequence and
independently across the batch and the heads (the RG-LRU's channels):
batch and head splits stay, and each rank scans its own rows and heads
with no collective; the sequence is taken whole (a sequence split, or a
partial sum, is redistributed to whole first). The SSD's B and C are
shared by the heads of a group: split with the heads where the groups
divide the axis, else replicated, each rank handed the groups of its own
heads (``group_sel``, as GQA's KV heads above) and their gradient a
partial sum.

``expert_layout`` makes the same choice for the MoE layer, whose one
region holds dispatch, the expert kernels and combine
(``models.moe``): the tokens stay on their data shard, the experts split
over the model axis (expert parallelism) or their f columns do
(expert-TP), and the output and the gradients of the tokens and the
router are partial sums over that axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


#: callbacks ``(kernel name, flops, bytes)`` a wrapper's fake route
#: reports its kernel's work to (``launch.step_analysis.StepCounter``)
KERNEL_WORK_HOOKS: list = []


_CLASSES: dict = {}


def _cls(name: str):
    """DTensor or FakeTensor, imported at first use and kept: the checks
    below run on every layer of every step, and an import statement
    costs microseconds a call."""
    c = _CLASSES.get(name)
    if c is None:
        if name == "DTensor":
            from torch.distributed.tensor import DTensor as c
        else:
            from torch._subclasses.fake_tensor import FakeTensor as c
        _CLASSES[name] = c
    return c


def is_fake(x) -> bool:
    """Whether ``x`` is a fake tensor (``FakeTensorMode``: shapes, no
    data). A kernel cannot run on one; its wrapper's fake route allocates
    the outputs and reports the work (``report_work``) instead: the dry
    run's stand-in for the kernel."""
    return isinstance(x, _cls("FakeTensor"))


def report_work(name: str, flops: float, nbytes: float) -> None:
    for hook in KERNEL_WORK_HOOKS:
        hook(name, flops, nbytes)


def causal_pairs(sq: int, skv: int, causal: bool) -> float:
    """(query, key) pairs an attention kernel computes for sq query rows
    over skv keys. Positions are not readable on fake tensors, so causal
    rows are taken as spread evenly over the keys (exact for sq == skv
    with aligned positions; the mean over the ranks for split rows)."""
    return sq * (skv + 1) / 2 if causal else float(sq * skv)


def is_dtensor(x) -> bool:
    return isinstance(x, _cls("DTensor"))


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: itself if it is one, else the same
    values on every rank (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicated_value(x):
    """A plain tensor of ``x``'s whole value (gathered if sharded)."""
    return x.full_tensor() if is_dtensor(x) else x


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor made
    from its shards states its global layout)."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.insert(0, acc)
        acc *= n
    return tuple(stride)


class AttentionLayout(NamedTuple):
    q: tuple                 # placements of q and of the output
    kv: tuple                # placements of k and v
    kv_grad: tuple           # placements of k's and v's gradients
    head0: int               # this rank's first query head
    heads: int               # query heads on this rank
    row0: int                # this rank's first query row
    rows: int                # query rows on this rank
    kv_heads: Optional[slice | torch.Tensor]   # KV heads to hand the kernel


def shard_span(mesh, pls, dim: int, n: int):
    """(first index, count) of tensor dim ``dim`` (size ``n``) on this rank
    under placements ``pls``, the mesh dims that split it taken major
    first, as DTensor nests them (even shards only)."""
    coord = mesh.get_coordinate()
    idx, parts = 0, 1
    for i, pl in enumerate(pls):
        if pl.is_shard(dim):
            idx = idx * mesh.size(i) + coord[i]
            parts *= mesh.size(i)
    return idx * (n // parts), n // parts


def attention_layout(q, k, *, batch: int, q_heads: int, q_rows,
                     kv_heads_dim: int, hq: int, kh: int) -> AttentionLayout:
    """Placements for a kernel that takes q with its batch, head and row
    dims at ``batch``, ``q_heads``, ``q_rows`` (None: one query a row, no
    rows to split) and K/V with their heads at ``kv_heads_dim`` (batch at
    ``batch``); ``hq``/``kh`` are the global head counts."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    qp, kp, kg = [], [], []
    for i, pl in enumerate(q.placements):
        size = mesh.size(i)
        kpl = k.placements[i] if is_dtensor(k) else Replicate()
        if size == 1:                    # nothing to split: free to move
            qp.append(Replicate())
            kp.append(Replicate())
            kg.append(Replicate())
            continue
        if pl.is_shard(batch) and q.shape[batch] % size == 0:
            qp.append(Shard(batch))
            kp.append(Shard(batch))
            kg.append(Shard(batch))
        elif pl.is_shard(q_heads) and hq % size == 0:
            qp.append(Shard(q_heads))
            if kpl.is_shard(kv_heads_dim) and kh % size == 0:
                kp.append(Shard(kv_heads_dim))
                kg.append(Shard(kv_heads_dim))
            else:
                kp.append(Replicate())
                kg.append(Partial())
        elif q_rows is not None and pl.is_shard(q_rows) and \
                q.shape[q_rows] % size == 0:
            qp.append(Shard(q_rows))
            kp.append(Replicate())
            kg.append(Partial())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kg.append(Replicate())
    qp, kp, kg = tuple(qp), tuple(kp), tuple(kg)
    head0, heads = shard_span(mesh, qp, q_heads, hq)
    row0, rows = (0, 0) if q_rows is None else \
        shard_span(mesh, qp, q_rows, q.shape[q_rows])
    kv_heads = None
    if not any(p.is_shard(kv_heads_dim) for p in kp):
        kv_heads = group_select(head0, heads, hq, kh)
    return AttentionLayout(qp, kp, kg, head0, heads, row0, rows, kv_heads)


def group_select(head0: int, heads: int, total: int, groups: int):
    """The groups of heads ``[head0, head0 + heads)`` of ``total`` heads
    in ``groups`` even groups (GQA's KV heads, the SSD's B/C groups), to
    hand a kernel that maps its local heads evenly onto its local groups:
    None where the rank holds every head; a slice where its heads fill a
    run of groups evenly; else one group a head (a tensor of indices,
    where a rank boundary falls inside a group unevenly)."""
    if heads == total:
        return None
    g = total // groups
    want = [(head0 + j) // g for j in range(heads)]
    n = want[-1] - want[0] + 1
    if heads % n == 0 and all(w - want[0] == j // (heads // n)
                              for j, w in enumerate(want)):
        return slice(want[0], want[-1] + 1)
    return torch.tensor(want)


class ScanLayout(NamedTuple):
    seq: tuple          # placements of a scanned tensor [b, l, H, ...] and
    #                     of its output (also dt [b, l, H])
    state: tuple        # of a state [b, H, ...] (h0, S0, the final state)
    heads: tuple        # of a per-head vector [H] (the SSD's A)
    heads_grad: tuple   # of its gradient
    groups: tuple       # of a grouped input [b, l, g, n] (the SSD's B, C)
    groups_grad: tuple  # of their gradients
    group_sel: Optional[slice | torch.Tensor]   # the groups of its heads
    #                     to hand the kernel (None: the groups it holds)


def scan_layout(x, nheads: int, ngroups: int = 0) -> ScanLayout:
    """Placements for a scan kernel on every rank's shards, mesh dim by
    mesh dim, for the DTensor ``x`` [b, l, H, ...] (batch, sequence,
    heads; ``nheads`` = H) and, for the SSD, ``ngroups`` groups of heads
    sharing B and C:

    * x split on its batch: every input and output split the same way,
      and the per-head vector's gradient a partial sum (each rank's rows
      contribute);
    * x split on its heads: the states on their heads, the per-head
      vector on its entries; B and C on their groups where the groups
      divide the axis, else replicated with a partial-sum gradient;
    * anything else (a split sequence or head width, a partial sum): taken
      whole (the caller redistributes explicitly).

    An uneven batch or head split (DTensor's uneven shards) raises: each
    rank's kernel takes whole rows and whole heads of even shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    R, P = Replicate(), Partial()
    cols = {k: [] for k in ScanLayout._fields[:6]}
    groups_split = set()
    for i, pl in enumerate(x.placements):
        size = mesh.size(i)
        if size > 1 and pl.is_shard(0):
            if x.shape[0] % size:
                raise ValueError(f"scan_layout: batch {x.shape[0]} split "
                                 f"unevenly over {size} ranks")
            row = dict(seq=Shard(0), state=Shard(0), heads=R,
                       heads_grad=P, groups=Shard(0), groups_grad=Shard(0))
        elif size > 1 and pl.is_shard(2):
            if nheads % size:
                raise ValueError(f"scan_layout: {nheads} heads split "
                                 f"unevenly over {size} ranks")
            split = bool(ngroups) and ngroups % size == 0
            groups_split.add(split)
            g = Shard(2) if split else R
            row = dict(seq=Shard(2), state=Shard(1), heads=Shard(0),
                       heads_grad=Shard(0), groups=g,
                       groups_grad=g if split else P)
        else:
            row = dict.fromkeys(cols, R)
        for k, v in row.items():
            cols[k].append(v)
    if len(groups_split) > 1:
        raise ValueError("scan_layout: the heads split over mesh dims that "
                         "split the groups and over others that do not")
    cols = {k: tuple(v) for k, v in cols.items()}
    sel = None
    if ngroups and groups_split == {False}:
        sel = group_select(*shard_span(mesh, cols["seq"], 2, nheads),
                           nheads, ngroups)
    return ScanLayout(**cols, group_sel=sel)


class ExpertLayout(NamedTuple):
    x: tuple            # placements of the tokens [b, s, d]
    out: tuple          # of the combined output [b, s, d] and of x's grad
    router_grad: tuple  # of the router's gradient (the router: replicated)
    w_in: tuple         # of w_gate and w_up [E, d, f] (an int8 one's q, s)
    w_in_grad: tuple
    w_out: tuple        # of w_down [E, f, d] (an int8 one's q)
    w_out_grad: tuple
    s_out: tuple        # of an int8 w_down's scales [E, 1, d]
    e0: int             # this rank's first expert
    experts: int        # the experts it runs
    token_groups: tuple  # groups of the mesh dims that split the tokens
    token_rank: int     # this rank's index among their ranks (major first)
    token_parts: int    # how many parts they split the tokens into
    aux_grad: bool      # whether this rank's aux-loss gradient counts


def expert_layout(x, w_gate, w_down, num_experts: int) -> ExpertLayout:
    """Placements for the MoE layer's dispatch, expert FFN and combine on
    every rank's shards (``models.moe``), mesh dim by mesh dim, for the
    DTensor tokens ``x [b, s, d]`` and the expert weights' layout (the
    planner's): ``w_gate [E, d, f]`` and ``w_down [E, f, d]`` (tensors or
    the q of int8 ones; a plain tensor counts as replicated):

    * split on E (expert parallelism): every rank takes the tokens of its
      data shard whole, runs its own experts on them, and its combine is a
      partial sum of the output (``Partial``); so are its gradients of the
      tokens and of the router;
    * w_gate split on f and w_down on its f rows (expert-TP, where E does
      not divide the axis): every expert runs on the rank's f columns, and
      the output and gradients are partial sums again;
    * split on d or f by ZeRO-3, or not split: the weights are gathered
      (their gradients reduce-scattered back, ``Partial``), and the tokens
      split on their batch where they are, or can be (a sequence-split
      input is redistributed), else taken whole;
    * a dim of one rank holds everything whole.

    No all-to-all: tokens stay on their data shard, as in the reference.
    A weight layout of another kind (split on other dims, partial sums,
    w_gate and w_down split unlike each other) raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    whole = (Replicate(),) * mesh.ndim
    g_pl, d_pl = (w.placements if is_dtensor(w) else whole
                  for w in (w_gate, w_down))
    xp = x.placements
    coord = mesh.get_coordinate()
    R, P = Replicate(), Partial()
    cols = {k: [] for k in ExpertLayout._fields[:8]}
    groups, t_rank, t_parts, aux_grad = [], 0, 1, True
    for i in range(mesh.ndim):
        size = mesh.size(i)
        g, dn = g_pl[i], d_pl[i]
        if size == 1:
            role = "none"
        elif g.is_shard(0) and dn.is_shard(0):
            role = "experts"
        elif g.is_shard(2) and dn.is_shard(1):
            role = "ffn"
        elif (g.is_replicate() or g.is_shard(1)) and (
                dn.is_replicate() or dn.is_shard(1) or dn.is_shard(2)):
            split = xp[i].is_shard(0) or (
                not xp[i].is_replicate() and x.shape[0] % size == 0)
            role = "tokens" if split else "none"
        else:
            raise ValueError(
                f"expert_layout: w_gate {g} and w_down {dn} on mesh dim "
                f"{i}: the expert "
                f"weights split on E (expert parallel), on f (expert-TP) "
                f"or by ZeRO-3 on the other dims, not so")
        if role == "experts":
            row = dict(x=R, out=P, router_grad=P, w_in=Shard(0),
                       w_in_grad=Shard(0), w_out=Shard(0),
                       w_out_grad=Shard(0), s_out=Shard(0))
        elif role == "ffn":
            row = dict(x=R, out=P, router_grad=P, w_in=Shard(2),
                       w_in_grad=Shard(2), w_out=Shard(1),
                       w_out_grad=Shard(1), s_out=R)
        elif role == "tokens":
            row = dict(x=Shard(0), out=Shard(0), router_grad=P, w_in=R,
                       w_in_grad=P, w_out=R, w_out_grad=P, s_out=R)
            groups.append(mesh.get_group(i))
            t_rank, t_parts = t_rank * size + coord[i], t_parts * size
        else:
            row = dict.fromkeys(cols, R)
        if role in ("experts", "ffn"):
            aux_grad = aux_grad and coord[i] == 0
        for k, pl in row.items():
            cols[k].append(pl)
    cols = {k: tuple(v) for k, v in cols.items()}
    e0, experts = shard_span(mesh, cols["w_in"], 0, num_experts)
    return ExpertLayout(**cols, e0=e0, experts=experts,
                        token_groups=tuple(groups), token_rank=t_rank,
                        token_parts=t_parts, aux_grad=aux_grad)


def select_kv_heads(t, layout: AttentionLayout, dim: int):
    """The KV heads of this rank's query heads, along ``dim``."""
    return select_groups(t, layout.kv_heads, dim)


def select_groups(t, sel, dim: int):
    """``t``'s groups ``sel`` (``group_select``) along ``dim``."""
    if sel is None:
        return t
    if isinstance(sel, slice):
        return t.narrow(dim, sel.start, sel.stop - sel.start)
    return t.index_select(dim, sel.to(t.device))


def scatter_groups(t, sel, dim: int, n: int):
    """The transpose of ``select_groups``: ``t``'s groups summed into
    their places among ``n`` along ``dim``, zeros elsewhere."""
    if sel is None:
        return t
    shape = list(t.shape)
    shape[dim] = n
    out = t.new_zeros(shape)
    if isinstance(sel, slice):
        out.narrow(dim, sel.start, sel.stop - sel.start).copy_(t)
        return out
    return out.index_add_(dim, sel.to(t.device), t)


class _SumOver(torch.autograd.Function):
    """The sum of every rank's ``x`` over ``groups``, which each rank then
    holds whole; each part's gradient is the sum's (a replicated result
    takes the same gradient on every rank)."""

    @staticmethod
    def forward(ctx, x, groups):
        from torch.distributed import _functional_collectives as funcol
        for grp in groups:
            x = funcol.all_reduce(x, "sum", grp)
        return x.wait() if hasattr(x, "wait") else x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(x, groups):
    """``_SumOver``: all-reduce (sum) over ``groups`` with an identity
    backward; ``x`` itself when there are none."""
    return _SumOver.apply(x, tuple(groups)) if groups else x


def gather_over(x, groups):
    """Every rank's ``x`` [n, ...] stacked over ``groups`` (no gradient):
    [n · Π sizes, ...], ranks in the order of their index over the groups,
    the first group the major one."""
    from torch.distributed import _functional_collectives as funcol
    for grp in reversed(groups):
        x = funcol.all_gather_tensor(x, 0, grp)
        x = x.wait() if hasattr(x, "wait") else x
    return x


class _GradIf(torch.autograd.Function):
    """Identity forward; the gradient passed on, or zeros where ``keep``
    is false."""

    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.keep else torch.zeros_like(grad)), None


def grad_if(x, keep: bool):
    """``x`` whose gradient counts on this rank only where ``keep``: a
    term every rank of a mesh dim computes alike, inside a region whose
    other gradients are that dim's partial sums, enters their sum once."""
    return _GradIf.apply(x, keep)


def redistribute(x, mesh, pls):
    """``x`` (a DTensor or a tensor replicated on every rank) laid out as
    ``pls``, redistributed explicitly when it is not. Where the layouts
    differ only on mesh dims of one rank, where every placement holds the
    whole dim, the local tensor is kept as it is (DTensor would move it
    through a one-rank collective, a copy)."""
    from torch.distributed.tensor import DTensor
    x = as_dtensor(x, mesh)
    pls = tuple(pls)
    have = tuple(x.placements)
    if have == pls:
        return x
    if all(mesh.size(i) == 1 for i, (a, b) in enumerate(zip(have, pls))
           if a != b):
        return DTensor.from_local(x.to_local(), mesh, pls, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return x.redistribute(mesh, pls)

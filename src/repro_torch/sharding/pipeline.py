"""Pipeline parallelism (GPipe-style) over a ``pipe`` mesh dim, the port of
the reference's ``repro.sharding.pipeline``.

The reference's 40-cell baseline uses DP×TP (+pod); pipelining is for the
regime where a model's layers exceed what one pod holds even at full TP:
stages split the layer stack, microbatches stream through the stages, and
the bubble is the usual (S−1)/(S−1+M). Where the reference moves
activations with ``jax.lax.ppermute`` inside ``shard_map``, each rank here
runs its own stage and passes its activations to the next stage's rank by
point-to-point send/recv; the last stage's outputs are then broadcast to
every pipe rank (the reference's ``psum`` of the masked buffer).

Held against the sequential loop on four gloo ranks in
``tests/test_torch_distributed.py``; compose with the planner by carving
``pipe`` out of the ``data`` axis (a mesh of dims ("pipe", "data",
"model")).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.bridge import tree_map


def _stage_of(p, idx: int):
    """This rank's stage of a stage-stacked leaf [S, ...]: the local shard
    of a DTensor split over the pipe dim, else row ``idx``."""
    from repro_torch.kernels.sharded import is_dtensor
    if is_dtensor(p):
        return p.to_local()[0]
    return p[idx]


def pipeline_forward(stage_fn: Callable, mesh, *, num_microbatches: int,
                     axis: str = "pipe"):
    """Build a pipelined forward: x -> the stages applied in sequence.

    ``stage_fn(stage_params, x)`` applies ONE stage's layers. Stage params
    are a tree of stage-stacked leaves [S, ...] (S = the ``axis`` dim's
    size): DTensors split over ``axis``, or the whole stack on every rank.
    Returns ``f(stage_params, x)`` for x [M, mb, ...] microbatches, the
    same on every pipe rank; the result is on every pipe rank too."""
    dim = mesh.mesh_dim_names.index(axis)
    n_stages = mesh.size(dim)
    group = mesh.get_group(dim)
    ranks = dist.get_process_group_ranks(group)
    idx = mesh.get_local_rank(axis)

    def pipelined(stage_params, x):
        M = x.shape[0]
        if M != num_microbatches:
            raise ValueError(f"x holds {M} microbatches, the pipeline was "
                             f"built for {num_microbatches}")
        steps = M + n_stages - 1
        local = tree_map(lambda p: _stage_of(p, idx), stage_params)
        buf = torch.zeros_like(x[0])
        outs = torch.zeros_like(x)
        nxt, prv = ranks[(idx + 1) % n_stages], ranks[(idx - 1) % n_stages]
        for t in range(steps):
            # stage 0 injects microbatch t; the others take what arrived
            cur = x[min(t, M - 1)] if idx == 0 else buf
            cur = stage_fn(local, cur)
            # the last stage keeps its output for microbatch t - (S - 1)
            out_t = t - (n_stages - 1)
            if idx == n_stages - 1 and 0 <= out_t < M:
                outs[out_t] = cur
            # push to the next stage (a ring, as the reference's ppermute)
            if n_stages > 1:
                recv = torch.empty_like(cur)
                for req in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, cur.contiguous(), nxt, group),
                        dist.P2POp(dist.irecv, recv, prv, group)]):
                    req.wait()
                buf = recv
        # every pipe rank gets the last stage's outputs
        if n_stages > 1:
            dist.broadcast(outs, src=ranks[-1], group=group)
        return outs

    return pipelined


def stage_params_from_stack(stacked, n_stages: int):
    """Reshape layer-stacked params [L, ...] into [S, L/S, ...] stages."""
    return tree_map(
        lambda p: p.reshape((n_stages, p.shape[0] // n_stages)
                            + tuple(p.shape[1:])), stacked)

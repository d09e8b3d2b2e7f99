"""Production meshes on torch ``DeviceMesh``, the port of the reference's
``repro.launch.mesh``.

The reference's production target is TPU pods: one pod of 16×16 = 256
chips (axes data×model) and two pods of 2×16×16 = 512 (pod×data×model).
The port keeps those shapes and axis names, so that its plans compare
with the reference's leaf for leaf; here each mesh position is one rank of
``torch.distributed`` (one GPU under ``torchrun``). The functions build a
mesh over the ranks already launched and never start a process group
themselves, so importing this module touches no device or network state.

``fake_world`` stands up a process-wide fake group for the dry run: every
collective returns at once and no other rank exists, which with
``FakeTensorMode`` lets one process plan and trace a 256- or 512-rank step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, axes, device_type):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world == n:
        return init_device_mesh(_device_type(device_type), tuple(shape),
                                mesh_dim_names=tuple(axes))
    # the first n ranks, as the reference takes its first n devices
    return DeviceMesh(_device_type(device_type),
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The 16×16 data×model mesh, or 2×16×16 pod×data×model, over the
    ranks of the default process group. Raises when there are too few."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for the {'multi-pod' if multi_pod else 'single-pod'} "
            f"mesh, have {have} — launch {n} ranks, e.g. `torchrun "
            f"--nnodes={n // 8} --nproc-per-node=8 ... -m repro_torch.launch."
            f"train --production`, or for the dry run "
            f"`python -m repro_torch.launch.dryrun` (a fake world of {n})")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device_type=None):
    """Small mesh over the default group's ranks (tests, one card)."""
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(f"need {n} ranks for a {tuple(shape)} mesh, "
                           f"have {have}")
    return _mesh(shape, axes, device_type)


def fake_world(n: int) -> None:
    """Initialise the default group as a fake world of ``n`` ranks in this
    process (rank 0): collectives return at once with their inputs
    untouched. A fake world of at least ``n`` ranks already up is kept.
    Process-wide: a process that holds it can hold no other group, so run
    the dry run in a process of its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() >= n:
            return
        raise RuntimeError("a process group is already initialised; the "
                           "fake world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

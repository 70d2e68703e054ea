"""Rank groups and sharded states (port of tpu_nbody.parallel.mesh).

The JAX package shards bodies over a ``jax.sharding.Mesh`` axis. Here a
:class:`~tpu_nbody_torch.parallel.collectives.Group` of P ranks holds them:
rank r owns the r-th ``capacity / P`` block of body slots, as one
:class:`~tpu_nbody_torch.state.SimState` of that many slots. A sharded
state is the list of the local ranks' states (all P for a ThreadGroup,
this process's one for a DistGroup).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_nbody_torch.parallel.collectives import (DEFAULT_TIMEOUT, DistGroup,
                                                  Group, ThreadGroup,
                                                  init_dist)
from tpu_nbody_torch.state import SimState, check_device

BODY_AXIS = "b"   # the JAX package's mesh axis name; a Group has one axis
BACKENDS = ("thread", "dist")


def make_mesh(n_devices: int | None = None, *, device="cuda",
              backend: str = "thread", timeout: float = DEFAULT_TIMEOUT,
              init_method: str | None = None) -> Group:
    """A group of ``n_devices`` ranks on ``device`` (the card unless the
    caller asks for the CPU; raises without a card).

    ``backend="thread"``: the ranks are threads of this process on the one
    device (default one rank). ``backend="dist"``: this process is one rank
    of ``torch.distributed`` (launch with ``torchrun``; NCCL for CUDA, gloo
    for the CPU), initialised here from the environment if the caller has
    not (``init_method``: see :func:`~tpu_nbody_torch.parallel.
    collectives.init_dist`); ``n_devices`` defaults to the world size and
    must equal it.
    """
    dev = check_device(device)
    if backend == "thread":
        return ThreadGroup(n_devices or 1, dev, timeout)
    if backend == "dist":
        owns = not dist.is_initialized()
        group = DistGroup(init_dist(dev, timeout, init_method), timeout,
                          owns=owns)
        if n_devices and n_devices != group.size:
            raise ValueError(f"{n_devices} ranks asked for, the process "
                             f"group has {group.size}")
        return group
    raise ValueError(f"unknown backend {backend!r}: expected one of "
                     f"{BACKENDS}")


def _slots_per_rank(capacity: int, group: Group) -> int:
    if capacity % group.size:
        raise ValueError(f"capacity {capacity} does not split over "
                         f"{group.size} ranks")
    return capacity // group.size


def shard_state(state: SimState, group: Group) -> list:
    """The local ranks' blocks of a global ``state`` (new tensors on the
    group's device); raises unless P divides the capacity."""
    c = _slots_per_rank(state.capacity, group)

    def block(x, r):
        return x[r * c:(r + 1) * c].to(group.device).clone()

    return [SimState(pos=block(state.pos, r), vel=block(state.vel, r),
                     mass=block(state.mass, r), alive=block(state.alive, r),
                     step=state.step.to(group.device).clone())
            for r in group.local_ranks]


def gather_state(local: list, group: Group) -> SimState:
    """The global state of a sharded one: the ranks' blocks in rank order
    (an ``all_gather`` where this process holds one rank of several)."""
    if len(local) == group.size:
        return SimState(*(torch.cat([s[i] for s in local]) for i in range(4)),
                        step=local[0].step)
    (s,) = local
    return SimState(*(group.all_gather(x, tiled=True) for x in s[:4]),
                    step=s.step)

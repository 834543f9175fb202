"""Data parallelism over ranks with `torch.distributed`: the counterpart of
the JAX package's `parallel/mesh.py`.

The JAX package lays a 1-D mesh over its devices and runs the step under
`shard_map`, the ray data sharded along the mesh and the state replicated.
Here each rank is a process with one device: it holds a replica of the
state and a block of the rays, and the step averages the gradients over
the ranks with one all-reduce (`train/loop.py`).

Ranks come from the launcher's environment, as `torchrun` sets it (RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT): the
counterpart of `jax.distributed.initialize()`. A process started without
a launcher is rank 0 of a world of 1, its process group on an in-process
store.

The backend is NCCL where every rank of a host has a card of its own, and
Gloo on the CPU and where ranks share a card (NCCL refuses two ranks on
one GPU). Rank r takes cuda:(LOCAL_RANK mod the cards visible). Gloo's
collectives on CUDA tensors are broadcast and all-reduce, so the mesh uses
only those two (and a barrier).
"""

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0  # a collective that waits longer than this raises


@dataclass(frozen=True)
class DataMesh:
    """This rank's place in the mesh: its rank, the world size, the
    process group, its backend and this rank's device."""

    rank: int
    world: int
    group: object
    backend: str
    device: torch.device

    @property
    def is_main(self):
        """Rank 0, the one that writes the run's files."""
        return self.rank == 0

    def _on_backend(self, t):
        """`t` where the backend can reduce it (NCCL: on the card)."""
        if self.backend == "nccl" and t.device.type != "cuda":
            return t.to(self.device)
        return t

    def all_reduce_(self, t, mean=False):
        """Sum (or average) `t` over the ranks, in place."""
        buf = self._on_backend(t)
        dist.all_reduce(buf, group=self.group)
        if mean and self.world > 1:
            buf.div_(self.world)
        if buf is not t:
            t.copy_(buf)
        return t

    def broadcast_(self, t, src=0):
        """Rank `src`'s `t` on every rank, in place."""
        buf = self._on_backend(t)
        dist.broadcast(buf, src=src, group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def broadcast_object(self, obj, src=0):
        """Rank `src`'s picklable `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(
            box, src=src, group=self.group,
            device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def close(self):
        """Destroy the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()


def device_count(device_type="cuda"):
    """Devices a mesh may span on this host: the visible CUDA cards, or 1
    on the CPU."""
    return 1 if device_type == "cpu" else torch.cuda.device_count()


def launcher_world():
    """WORLD_SIZE of the launcher that started this process, or None."""
    world = os.environ.get("WORLD_SIZE")
    return None if world is None else int(world)


def data_mesh(n_devices=None, device_type="cuda", init_method=None,
              timeout_s=TIMEOUT_S):
    """This rank's `DataMesh` over `n_devices` ranks (None: the launcher's
    world), initialising the default process group unless one exists.

    device_type: "cuda" (raises without CUDA) or "cpu". init_method: a
    torch.distributed init URL ("env://" from the launcher's variables by
    default; a `file://` path needs no port); timeout_s bounds every
    collective."""
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh: no CUDA device is available; pass "
                               "device_type='cpu' to run on the CPU")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"data_mesh: device type {device_type!r}")
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0))
        world = launcher_world() or 1
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(device)
            if local_world <= torch.cuda.device_count():
                backend = "nccl"
        kw = {"init_method": init_method or "env://"}
        if init_method is None and world == 1 and "MASTER_ADDR" not in os.environ:
            kw = {"store": dist.HashStore()}
        dist.init_process_group(backend, rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout_s), **kw)
    elif device.type == "cuda":
        torch.cuda.set_device(device)
    world = dist.get_world_size()
    if n_devices and n_devices != world:
        raise ValueError(f"data_mesh: {n_devices} devices asked for, the "
                         f"process group has {world} ranks")
    return DataMesh(rank=dist.get_rank(), world=world,
                    group=dist.group.WORLD, backend=dist.get_backend(),
                    device=device)


def local_batch(global_batch, mesh):
    """The rays a rank takes of a global batch."""
    n = mesh.world
    if global_batch % n:
        raise ValueError(f"batch size {global_batch} not divisible by {n} "
                         "ranks")
    return global_batch // n

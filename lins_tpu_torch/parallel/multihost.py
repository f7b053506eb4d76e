"""Process enrollment and the port's mesh (port of
`lins_tpu/parallel/multihost.py`; SURVEY.md §5 / C27).

The reference enrolls each host's process through `jax.distributed` and
then runs the same `shard_map` code over every device of the cluster.  The
port enrolls through `torch.distributed.init_process_group` (NCCL when the
process's device is the card, gloo on the CPU) and runs its collectives
through a `Mesh`: this process's devices plus the process group.

Launch recipe (one command per host), with the reference's variables:

    JAX_COORDINATOR=host0:8476 JAX_NUM_PROCESSES=4 JAX_PROCESS_ID=$i \\
        python -m lins_tpu_torch.run_slam --multihost ...

or programmatically:

    from lins_tpu_torch.parallel import multihost
    multihost.initialize()                  # False when single-process
    mesh = multihost.global_mesh()          # this process's shards + group
    rows = multihost.local_batch_slice(mesh, total_batch)

Every process runs the same collectives in the same order.  NCCL cannot put
two ranks on one card, so a one-card machine is a world of one process.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from lins_tpu_torch.utils.device import resolve_device


class Mesh:
    """A 1-D mesh axis: this process's shards (one device each; a CPU
    process may hold several shards of the one CPU device) and the process
    group that joins this process to the others, or None.

    `psum` is the reference's `lax.psum` over the axis: the per-shard
    partials summed in shard order on the first device, then, with a
    group, an `all_reduce` across processes.  Shard s of the whole mesh is
    shard s - offset of process `index`; processes hold equal numbers of
    shards."""

    def __init__(self, devices, group=None, axis: str = "seq"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.axis = axis

    @property
    def process_count(self) -> int:
        return dist.get_world_size(self.group) if self.group else 1

    @property
    def process_index(self) -> int:
        return dist.get_rank(self.group) if self.group else 0

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards of the whole mesh, over every process."""
        return self.local_size * self.process_count

    @property
    def offset(self) -> int:
        """The mesh index of this process's first shard."""
        return self.process_index * self.local_size

    def psum(self, parts):
        """Sum of the per-shard tensors `parts` (one per local shard, in
        shard order) over the whole mesh, on the first device."""
        total = parts[0].to(self.devices[0])
        for p in parts[1:]:
            total = total + p.to(self.devices[0])
        if self.group is not None:
            dist.all_reduce(total, group=self.group)
        return total

    def __repr__(self):
        return (f"Mesh({self.axis}: {self.local_size} local shards on "
                f"{[str(d) for d in self.devices]}, process "
                f"{self.process_index} of {self.process_count})")


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None,
               timeout_s: float = 120.0) -> bool:
    """Enroll this process in a multi-process group.

    Arguments fall back to the reference's JAX_COORDINATOR ("host:port"),
    JAX_NUM_PROCESSES and JAX_PROCESS_ID variables, so launch recipes carry
    over.  The backend is NCCL when `device` (the card unless given) is a
    CUDA device, gloo on the CPU.  Returns True once enrolled (and on later
    calls), False for the single-process fallback when no coordinator is
    set.
    """
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR")
    if coordinator_address is None:
        return False
    num_processes = num_processes or _env_int("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int(
        "JAX_PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator needs the number of "
                         "processes and this process's id "
                         "(JAX_NUM_PROCESSES, JAX_PROCESS_ID)")
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


def shutdown():
    """Leave the process group (a no-op when not enrolled)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(devices=None, axis: str = "seq") -> Mesh:
    """The mesh over this process's devices (the card unless given) and,
    once `initialize()` enrolled it, the whole group."""
    if devices is None:
        devices = [resolve_device(None)]
    return Mesh(devices, dist.group.WORLD if dist.is_initialized() else None,
                axis)


def local_batch_slice(mesh: Mesh, total_batch: int) -> slice:
    """The rows [start, stop) of a batch split over the processes that this
    process holds.  Requires total_batch % process_count == 0."""
    n_proc = mesh.process_count
    if total_batch % n_proc:
        raise ValueError(f"total_batch {total_batch} not divisible by "
                         f"process count {n_proc}")
    per = total_batch // n_proc
    i = mesh.process_index
    return slice(i * per, (i + 1) * per)


def make_global_batch(mesh: Mesh, host_local_arrays):
    """The whole batch on every process, from each process's own rows
    (`local_batch_slice`): each leaf (a numpy array or tensor of this
    process's rows, in a dict, tuple or list) is gathered over the group in
    process order onto the mesh's first device.  Returns the same
    container of tensors."""
    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        t = torch.as_tensor(x).to(mesh.devices[0])
        if mesh.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(mesh.process_count)]
        dist.all_gather(parts, t.contiguous(), group=mesh.group)
        return torch.cat(parts)

    return put(host_local_arrays)

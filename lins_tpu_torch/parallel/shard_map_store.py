"""The keyframe store sharded along the keyframe axis over a mesh (port of
`lins_tpu/parallel/shard_map_store.py`; SURVEY.md §2 P3).

The reference places every per-keyframe array on `NamedSharding(P(axis))`
and lets XLA insert the gathers into unchanged code.  PyTorch has no
counterpart that covers the mapper's indexing, so the port holds explicit
per-shard blocks and gathers them itself:

  * ownership: shard s of the mesh (over every process) owns the slots
    [s*R, (s+1)*R), R = K / n, the reference's contiguous `P(axis)` layout;
    K % n != 0 raises, as `jax.device_put` does;
  * sharded: the six cloud fields (corner, surf, outlier and their valid
    masks), over 99.9% of the store's bytes, each a `ShardedRows`;
  * replicated: pos, quat, time, kf_id and count (36 B a slot), one whole
    copy in each process on its first shard's device.  The loop detector,
    the radius selection and the pose graph read them whole every step.
    This is a layout choice, not a contract.

Reads and writes of sharded rows (`mapping/keyframes.py::take_rows`,
`take_row`, `put_row`) read no index back to the host.  A read takes each
local shard's rows at the slots' local rows and combines them on the
mesh's first device by a select on the owner, so it equals the unsharded
read bit for bit; across processes one `all_reduce` sums the owner-masked
rows (each row has one non-zero contributor: exact, apart from the sign of
zero).  A write copies each shard once, with the new row where the shard
owns the slot and its own current row elsewhere.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from lins_tpu_torch.parallel.multihost import Mesh
from lins_tpu_torch.utils.tree import tree_map

# the store's fields that are split over the mesh
SHARDED_FIELDS = ("corner", "corner_valid", "surf", "surf_valid", "outlier",
                  "outlier_valid")


@dataclasses.dataclass
class ShardedRows:
    """A per-keyframe array split along its first axis: `parts[l]` is this
    process's local shard l (mesh shard `mesh.offset + l`) on
    `mesh.devices[l]`, `rows` slots each.  `utils/tree.tree_map` maps the
    parts and passes the mesh through."""

    parts: list
    mesh: Mesh

    @property
    def rows(self) -> int:
        return self.parts[0].shape[0]

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.rows * self.mesh.size,)
                          + tuple(self.parts[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def local(self):
        """(mesh shard index, part) of each local shard."""
        return enumerate(self.parts, self.mesh.offset)

    def locate(self, slots: torch.Tensor):
        """For a device tensor of slots in [0, K): the mesh shard that owns
        each and its row there.  The row is in range in every shard, so a
        shard that does not own a slot reads a row that is selected away."""
        return (torch.div(slots, self.rows, rounding_mode="floor"),
                torch.remainder(slots, self.rows))

    def gather(self) -> torch.Tensor:
        """The whole (K, ...) array on the mesh's first device (across
        processes an `all_gather` in process order)."""
        dev0 = self.mesh.devices[0]
        whole = torch.cat([p.to(dev0) for p in self.parts])
        if self.mesh.group is None:
            return whole
        wire = whole.to(torch.uint8) if whole.dtype == torch.bool else whole
        out = [torch.empty_like(wire) for _ in range(self.mesh.process_count)]
        dist.all_gather(out, wire.contiguous(), group=self.mesh.group)
        return torch.cat(out).to(whole.dtype)


def to_whole(x):
    """A sharded field gathered whole; anything else unchanged."""
    return x.gather() if isinstance(x, ShardedRows) else x


def unshard_store(store):
    """The store with every sharded field gathered whole."""
    return store._replace(**{f: to_whole(getattr(store, f))
                             for f in SHARDED_FIELDS})


def shard_rows(x, mesh: Mesh) -> ShardedRows:
    """One (K, ...) array split over the mesh; this process keeps only its
    own shards, each a copy on its device.  A field already sharded over
    `mesh` is returned as it is."""
    if isinstance(x, ShardedRows):
        if x.mesh is mesh:
            return x
        x = x.gather()
    K, n = x.shape[0], mesh.size
    if K % n:
        raise ValueError(f"shard_store: {K} keyframe slots do not split "
                         f"over {n} shards")
    R = K // n
    return ShardedRows(
        [x[s * R:(s + 1) * R].to(d, copy=True)
         for s, d in enumerate(mesh.devices, mesh.offset)], mesh)


def shard_store(store, mesh: Mesh, axis: str = "seq"):
    """The store with its cloud fields split along the keyframe axis over
    `mesh` and the rest replicated (`replicate`).  `axis` names the mesh
    axis, as in the reference; the port's mesh has one."""
    if axis != mesh.axis:
        raise ValueError(f"shard_store: the mesh's axis is {mesh.axis!r}, "
                         f"not {axis!r}")
    whole = replicate(store._replace(**{f: None for f in SHARDED_FIELDS}),
                      mesh)
    return whole._replace(**{f: shard_rows(getattr(store, f), mesh)
                             for f in SHARDED_FIELDS})


def replicate(tree, mesh: Mesh):
    """Every tensor of `tree` whole on the mesh's first device (one copy in
    each process)."""
    return tree_map(lambda x: x.to(mesh.devices[0]), tree)

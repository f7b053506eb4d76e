"""Checkpoint / resume and the global-map export (port of
`lins_tpu/utils/checkpoint.py`).

The whole engine state (the odometry's filter state, nominal state and
association reference sets; the mapper's keyframe store, pose graph and
correction) goes into one uncompressed .npz, under the reference
package's key names: each container's leaves in the order JAX flattens
them (NamedTuple fields in order, dict keys sorted) as `<prefix>/<i>`,
their number as `<prefix>/__len__`, and a JSON `__meta__`.  So a
checkpoint written by either package loads into the other.  The mapper's
local map is derived state (the voxel maps and eviction deltas of the
window, a function of the keyframe store): it is not saved, and is rebuilt
on load (`LinsMapper.rebuild_local_map`).
"""
from __future__ import annotations

import json

import numpy as np

from lins_tpu_torch.utils.lazy import to_numpy

# archive layout version, the reference package's: v2 leaves the derived
# local map out of mapper_state
_FORMAT = 2


def _named_leaves(tree, name=""):
    """(field path, leaf) of each tensor leaf of a state container, in
    JAX's flattening order; None holds no leaf.  The path joins NamedTuple
    field names, dict keys and tuple indices with dots."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, dict)):
        items = (sorted(tree.items()) if isinstance(tree, dict) else
                 zip(getattr(tree, "_fields", range(len(tree))), tree))
        return [x for k, v in items
                for x in _named_leaves(v, f"{name}.{k}" if name else str(k))]
    return [(name, tree)]


def _leaves(tree):
    """The tensor leaves of a state container, in JAX's flattening order."""
    return [leaf for _, leaf in _named_leaves(tree)]


def _rebuild(tree, leaves):
    """`tree` with its leaves replaced, in `_leaves` order, from the
    iterator `leaves`."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_rebuild(f, leaves) for f in tree))
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _flatten(tree, prefix, out):
    leaves = _leaves(tree)
    out[f"{prefix}/__len__"] = np.asarray(len(leaves))
    for i, leaf in enumerate(leaves):
        out[f"{prefix}/{i}"] = to_numpy(leaf)


def _unflatten(data, prefix, template):
    """The archive's `prefix` leaves as numpy arrays in `template`'s
    structure.  Raises ValueError when the archive's leaf count or any
    leaf's shape differs from the template's: a run whose capacities
    differ from the saved run's cannot take its state."""
    n = int(data[f"{prefix}/__len__"])
    named = _named_leaves(template)
    if n != len(named):
        raise ValueError(
            f"checkpoint '{prefix}' has {n} leaves but the current state "
            f"layout expects {len(named)}: an archive of an incompatible "
            f"layout (format {_FORMAT} expected)")
    arrays = []
    for i, (field, leaf) in enumerate(named):
        a = np.array(data[f"{prefix}/{i}"])
        want = tuple(np.shape(leaf))
        if a.shape != want:
            raise ValueError(
                f"checkpoint leaf '{prefix}/{i}' ({field}) has shape "
                f"{a.shape} but the current state expects {want}: the "
                f"run's capacities (--feature-scale, max_keyframes, the "
                f"map caps) must match the saved run's")
        arrays.append(a)
    return _rebuild(template, iter(arrays))


def _load_like(data, prefix, template):
    """`_unflatten` as tensors, each with its template leaf's dtype and
    device."""
    import torch

    from lins_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t, a: torch.as_tensor(a).to(dtype=t.dtype,
                                                       device=t.device),
                    template, _unflatten(data, prefix, template))


def save_state(path: str, odometry=None, mapper=None, extra=None):
    """Save the odometry and mapper state to an npz file."""
    out = {}
    meta = {"format": _FORMAT}
    if odometry is not None:
        meta["odo"] = dict(status=odometry.status, time=odometry.time)
        if odometry.filter_state is not None:
            _flatten(odometry.filter_state, "filter_state", out)
        if odometry.global_state is not None:
            _flatten(odometry.global_state, "global_state", out)
        if odometry.last_surf is not None:
            _flatten(odometry.last_surf, "last_surf", out)
            _flatten(odometry.last_corner, "last_corner", out)
    if mapper is not None:
        from lins_tpu_torch.parallel.shard_map_store import unshard_store

        # the local map is derived from the store: left out; a store
        # sharded over a mesh is written whole, as an unsharded one
        _flatten(mapper.state._replace(
            lmap=None, store=unshard_store(mapper.state.store)),
            "mapper_state", out)
        meta["mapper"] = dict(last_time=mapper.last_time,
                              last_loop_time=mapper.last_loop_time)
    if extra:
        for k, v in extra.items():
            out[f"extra/{k}"] = to_numpy(v)
    out["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **out)


def load_state(path: str, odometry=None, mapper=None):
    """Restore the odometry and mapper state in place, on their devices and
    in their dtypes; the mapper's local map is rebuilt.  Returns the parsed
    meta."""
    from lins_tpu_torch.imu import eskf
    from lins_tpu_torch.odometry.estimator import dummy_feature_ref

    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    if odometry is not None and "odo" in meta:
        odometry.status = meta["odo"]["status"]
        odometry.time = meta["odo"]["time"]
        dt, dev = odometry.dtype, odometry.device
        if "filter_state/__len__" in data:
            if odometry.filter_state is None:
                odometry.filter_state = eskf.initial_state(
                    odometry.cfg, dtype=dt, device=dev)
            odometry.filter_state = _load_like(data, "filter_state",
                                               odometry.filter_state)
            odometry.global_state = _load_like(data, "global_state",
                                               odometry.global_state)
        if "last_surf/__len__" in data:
            if odometry.last_surf is None:
                odometry.last_surf = dummy_feature_ref(
                    odometry.cfg.max_less_flat, dt, dev)
                odometry.last_corner = dummy_feature_ref(
                    odometry.cfg.max_less_sharp, dt, dev)
            odometry.last_surf = _load_like(data, "last_surf",
                                            odometry.last_surf)
            odometry.last_corner = _load_like(data, "last_corner",
                                              odometry.last_corner)
    if mapper is not None and "mapper_state/__len__" in data:
        # the mapper state without its local map, handed over as the
        # reference package's is (`LinsMapper.load_numpy_state`, which
        # re-shards the store of a mapper sharded over a mesh)
        mapper.load_numpy_state(
            _unflatten(data, "mapper_state",
                       mapper.state._replace(lmap=None)),
            last_time=meta["mapper"]["last_time"])
        mapper.last_loop_time = meta["mapper"]["last_loop_time"]
    return meta


def global_map_cloud(mapper):
    """Every live keyframe's surf, corner and outlier points at its pose,
    on the mapper's device, before the voxel filter: (xyz (R, 3), ok
    (R,))."""
    import torch

    from lins_tpu_torch.geom import so3
    from lins_tpu_torch.mapping import keyframes as kfm
    from lins_tpu_torch.parallel.shard_map_store import unshard_store

    store = unshard_store(mapper.state.store)
    keep = kfm.live_mask(store)[:, None]

    def to_world(cloud, valid):
        return (so3.quat_rotate(store.quat[:, None, :], cloud)
                + store.pos[:, None, :], valid & keep)

    parts = [to_world(store.surf, store.surf_valid),
             to_world(store.corner, store.corner_valid),
             to_world(store.outlier, store.outlier_valid)]
    return (torch.cat([w.reshape(-1, 3) for w, _ in parts]),
            torch.cat([v.reshape(-1) for _, v in parts]))


def global_map_points(mapper, leaf: float = 0.4, cap: int = 1 << 20):
    """The keyframe map as one world-frame cloud: `global_map_cloud`
    voxel-filtered at `leaf` on the mapper's device.  Returns host numpy
    (N, 3)."""
    from lins_tpu_torch.ops.voxel import voxel_downsample

    xyz, ok = global_map_cloud(mapper)
    ds, ds_ok = voxel_downsample(xyz, ok, leaf, min(cap, xyz.shape[0]))
    return to_numpy(ds)[to_numpy(ds_ok)]


def export_global_map(path: str, mapper, leaf: float = 0.4,
                      cap: int = 1 << 20):
    """Export the keyframe map (`global_map_points`) as a .ply or .npz
    cloud (reference C24: the offline form of visualizeGlobalMapThread's
    publishing).  Returns the number of points."""
    pts = global_map_points(mapper, leaf, cap)
    if path.endswith(".ply"):
        write_ply(path, pts)
    else:
        np.savez_compressed(path, points=pts)
    return pts.shape[0]


def write_ply(path: str, points: np.ndarray):
    """Write an (N,3) cloud as binary little-endian PLY (for PCL and
    CloudCompare)."""
    points = np.ascontiguousarray(points, np.float32)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(points)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(points.tobytes())

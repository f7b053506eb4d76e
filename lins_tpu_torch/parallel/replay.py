"""Multi-stream replay over a mesh (port of `lins_tpu/parallel/replay.py`;
SURVEY.md §2 P4).

The reference is a single-stream pipeline; the replay drivers here run a
batch of B independent scan streams.  Every state is batch-leading (a
(B, ...) stack of each field), as in the reference package.  The B streams
are split into one block per mesh shard, and each shard runs its block's
streams one after another, each through the single-stream program: the
reference's own schedule under `shard_map` (a `lax.scan` over the shard's
sub-batch), which gives each stream exactly its single-stream result.
Blocks of different cards are issued in turn from this process's one host
thread, each on its own card's stream.  A batch dimension through the
kernels is left for later.

The mapping and loop cadence flags are shared by every stream (the
reference's restriction: the streams share one scan clock); each stream
keeps its own scan times.
"""
from __future__ import annotations

import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.frontend.pipeline import process_cloud
from lins_tpu_torch.imu import eskf
from lins_tpu_torch.mapping import local_map as lmn
from lins_tpu_torch.mapping import mapper as mp
from lins_tpu_torch.odometry import estimator as est
from lins_tpu_torch.parallel.multihost import Mesh
from lins_tpu_torch.utils.device import resolve_device, resolve_dtype
from lins_tpu_torch.utils.metrics import trace_scope
from lins_tpu_torch.utils.tree import tree_map


def make_mesh(n_devices: int | None = None, axis: str = "seq",
              device=None) -> Mesh:
    """A mesh of this process's first `n_devices` cards (all of them by
    default), or with device="cpu" of `n_devices` shards of the CPU (one by
    default)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = n_devices or torch.cuda.device_count()
        return Mesh([torch.device("cuda", i) for i in range(n)], axis=axis)
    return Mesh([dev] * (n_devices or 1), axis=axis)


def lane(tree, b: int):
    """Stream b of a batch-leading container."""
    return tree_map(lambda x: x[b], tree)


def stack_lanes(lanes, device=None):
    """A batch-leading container from a list of per-stream ones."""
    return tree_map(lambda *xs: torch.stack([x.to(device or xs[0].device)
                                             for x in xs]), *lanes)


def _blocks(mesh: Mesh, batch: int):
    """The streams of each local shard: equal contiguous blocks, in shard
    order."""
    if batch % mesh.local_size:
        raise ValueError(f"batch {batch} not divisible by the mesh's "
                         f"{mesh.local_size} local shards")
    per = batch // mesh.local_size
    return [(dev, range(d * per, (d + 1) * per))
            for d, dev in enumerate(mesh.devices)]


def _run_blocks(mesh: Mesh, batch: int, one, *args):
    """`one(device, *stream_args)` for every stream, each on its shard's
    device, outputs stacked (batch-leading) on the mesh's first device."""
    outs = []
    for dev, block in _blocks(mesh, batch):
        for b in block:
            outs.append(one(dev, *tree_map(lambda x: x.to(dev),
                                           lane(args, b))))
    return stack_lanes(outs, mesh.devices[0])


def _put(mesh: Mesh):
    def put(tree):
        """A batch-leading container on the mesh's first device (each
        block moves to its shard's device when it runs)."""
        return tree_map(lambda x: torch.as_tensor(x).to(mesh.devices[0]),
                        tree)
    return put


def batched_scan_step(cfg: SlamConfig, mesh: Mesh | None = None):
    """The full per-scan RUNNING step (front end + IESKF) over a batch:
    fn(filter_states, global_states, last_surfs, last_corners, xyz,
    n_points, dts, accs, gyrs, imu_valid) -> (filter_states, global_states,
    surfs, corners, rel_rn, rel_qbn), every argument and output
    batch-leading.  On a one-shard mesh of the inputs' device unless given."""
    def one(dev, fs, gs, surf, corner, xyz, n, dts, accs, gyrs, ok):
        _, _, feats = process_cloud(xyz, n, cfg)
        out = est.running_step_impl(fs, gs, feats, surf, corner, dts, accs,
                                    gyrs, ok, cfg)
        return out[:6]

    def step(*args):
        m = mesh or Mesh([args[4].device])
        return _run_blocks(m, args[4].shape[0], one, *args)

    return step


def make_sharded_step(cfg: SlamConfig, mesh: Mesh):
    """`batched_scan_step` over the mesh; returns (step, put), put moving a
    batch-leading container to the mesh."""
    return batched_scan_step(cfg, mesh), _put(mesh)


def make_sharded_chunk_replay(cfg: SlamConfig, mesh: Mesh):
    """Chunked multi-stream odometry replay over the mesh.

    Returns (step, put): step(states, xyz (B,K,P,3), n (B,K), dts, accs,
    gyrs, valid (B,K,...)) -> (states', (rn (B,K,3), qbn (B,K,4))), states =
    (filter states, global states, last surfs, last corners) batch-leading;
    each stream runs `estimator.odometry_chunk_impl`, the chunk of
    `LinsOdometry.add_scan_chunk`."""
    def one(dev, state, xyz, n, dts, accs, gyrs, ok):
        state, outs = est.odometry_chunk_impl(tuple(state), xyz, n, dts,
                                              accs, gyrs, ok, cfg)
        return state, (outs[0], outs[1])

    def step(states, xyz, n, dts, accs, gyrs, valid):
        return _run_blocks(mesh, xyz.shape[0], one, states, xyz, n, dts,
                           accs, gyrs, valid)

    return step, _put(mesh)


def make_sharded_slam_replay(cfg: SlamConfig, mesh: Mesh,
                             n_window: int | None = None,
                             submap_cap: int | None = None,
                             cloud_cap: int | None = None,
                             opt_iters: int = 8):
    """Full-pipeline multi-stream replay over the mesh: per stream the
    odometry chunk, then the mapping cadence, loop attempts and fused
    poses (`mapper._mapping_chunk_impl`, the chunk of
    `LinsMapper.process_chunk`) with the caps `LinsMapper` derives.

    Returns (step, put):
      step(odo_states, map_states, xyz, n, dts, accs, gyrs, valid, ts, rp,
           mf, lf, has_map=False) -> (odo_states', map_states', (pos, quat)
           fused per scan, each (B, K, ...))
    with every argument batch-leading except mf / lf, the (K,) host bools
    of `LinsMapper.plan_chunk` shared by every stream, and `has_map`:
    whether the streams' maps already hold a keyframe (False for
    `batched_mapper_state`'s fresh states; after a chunk, `has_map or
    any(mf)`).  Each call is the span `parallel.chunk` (streams, K), with
    each stream's `odometry.chunk` and `mapper.chunk` inside."""
    caps = mp.derive_caps(cfg)
    corner_cap, surf_cap = caps[:2]
    submap_cap = submap_cap or min(16384, 4 * (corner_cap + surf_cap))
    cloud_cap = cloud_cap or min(8192, 2 * (corner_cap + surf_cap))
    gp = lmn.grid_params(cfg)
    nw = n_window or cfg.surrounding_keyframe_search_num

    def step(odo_states, map_states, xyz, n, dts, accs, gyrs, valid, ts, rp,
             mf, lf, has_map=False):
        def one(dev, odo, ms, xyz, n, dts, accs, gyrs, ok, ts, rp):
            odo, outs = est.odometry_chunk_impl(tuple(odo), xyz, n, dts,
                                                accs, gyrs, ok, cfg)
            rns, qbns, _, _, _, c = outs
            ms, pos, quat, _, _, _ = mp._mapping_chunk_impl(
                ms, rns, qbns, ts, c["cxyz"], c["cval"], c["sxyz"],
                c["sval"], c["oxyz"], c["oval"], rp, mf, lf, cfg, *caps, nw,
                gp, submap_cap, cloud_cap, opt_iters, has_map)
            return odo, ms, (pos, quat)

        with trace_scope("parallel.chunk", streams=xyz.shape[0],
                         K=xyz.shape[1]):
            return _run_blocks(mesh, xyz.shape[0], one, odo_states,
                               map_states, xyz, n, dts, accs, gyrs, valid, ts,
                               rp)

    return step, _put(mesh)


def batched_mapper_state(cfg: SlamConfig, batch: int,
                         n_window: int | None = None, dtype=None,
                         device=None):
    """A batch-leading stack of `batch` fresh mapper states (the caps
    `LinsMapper` derives)."""
    dev = resolve_device(device)
    st = mp.init_mapper(cfg, *mp.derive_caps(cfg),
                        n_window or cfg.surrounding_keyframe_search_num,
                        dtype=resolve_dtype(dtype), device=dev)
    return tree_map(lambda a: a[None].expand((batch,) + a.shape).clone(),
                    st)


def batched_initial_states(cfg: SlamConfig, batch: int, dtype=None,
                           device=None):
    """Batch-leading (filter states, global states, last surfs, last
    corners) of `batch` streams at rest, with empty reference sets."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def rep(x):
        return x[None].expand((batch,) + x.shape).clone()

    fs = eskf.initial_state(cfg, acc=[0, 0, cfg.gravity], dtype=dtype,
                            device=dev)
    gs = est.identity_nominal(cfg, dtype, dev)
    surf = est.dummy_feature_ref(cfg.max_less_flat, dtype, dev)
    corner = est.dummy_feature_ref(cfg.max_less_sharp, dtype, dev)
    return tree_map(rep, (fs, gs, surf, corner))

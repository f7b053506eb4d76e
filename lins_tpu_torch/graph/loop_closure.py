"""Loop-closure detection and ICP (port of `lins_tpu/graph/loop_closure.py`;
reference C23, lidar_mapping_node.cpp:1033-1186).

Detection: the nearest live keyframe within history_keyframe_search_radius
(5 m) that is older than loop_time_gate.  Alignment: point-to-point ICP of
the current keyframe's cloud against a ±history_keyframe_search_num
keyframe submap (the PCL ICP call, :1127-1138, as a coarse-to-fine Umeyama
loop on chunked brute-force nearest neighbours), then a point-to-plane
polish through the scan-to-map machinery (and kernel K3).  An edge is
accepted when fitness < 0.3 and its implied correction is consistent with
the odometry's drift.

The host decides both on every device: it reads whether a candidate was
found and issues the alignment only then (utils/tree.cond), and it reads
the ICP's `active` flag once its gate is the finest and issues no trip
once the loop has converged (utils/device.may_stop).  An attempt with
no candidate costs one host read here and issues no alignment.
"""
from __future__ import annotations

import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.geom import so3
from lins_tpu_torch.mapping import keyframes as kf
from lins_tpu_torch.mapping.keyframes import take_row, take_rows
from lins_tpu_torch.mapping.scan2map import scan_to_map_grids
from lins_tpu_torch.ops.grid_nn import build_grid
from lins_tpu_torch.ops.lin3 import eigh_sym3x3
from lins_tpu_torch.ops.voxel import top_k_nn, voxel_downsample
from lins_tpu_torch.utils.device import may_stop
from lins_tpu_torch.utils.metrics import host_read, trace_scope
from lins_tpu_torch.utils.tree import cond


def detect_loop(store: kf.KeyframeStore, cur, cur_time, cfg: SlamConfig):
    """Nearest old live keyframe within the search radius
    (detectLoopClosure, :1043-1112).  `cur` is an absolute keyframe id;
    returns (matched absolute id int32, found)."""
    cur_slot = torch.remainder(cur, store.capacity)
    d = torch.linalg.vector_norm(store.pos - take_row(store.pos, cur_slot),
                                 dim=1)
    old = (kf.live_mask(store)
           & (cur_time - store.time > cfg.loop_time_gate)
           & (store.kf_id != cur))
    d = torch.where(old, d, torch.inf)
    slot = torch.argmin(d)
    found = take_row(d, slot) < cfg.history_keyframe_search_radius
    return take_row(store.kf_id, slot).to(torch.int32), found


def path_length(store: kf.KeyframeStore, id_a, id_b):
    """Arc length of the keyframe chain id_a -> id_b (absolute ids) at the
    store's current poses; evicted segments count nothing."""
    ids = store.kf_id
    nxt = torch.remainder(ids + 1, store.capacity).long()
    seg = torch.linalg.vector_norm(store.pos[nxt] - store.pos, dim=1)
    ok = (kf.live_mask(store) & (ids >= id_a) & (ids < id_b)
          & (ids[nxt] == ids + 1))
    return torch.sum(torch.where(ok, seg, 0.0))


def consistency_bound(store: kf.KeyframeStore, idx, cur, cfg: SlamConfig):
    """Largest plausible drift between the loop pair's estimates: a
    drift-rate fraction of their arc length, floored at a constant."""
    return torch.clamp(cfg.loop_consistency_frac
                       * path_length(store, idx, cur),
                       min=cfg.loop_consistency_min_m)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)


def rotation_of(S):
    """The proper rotation R maximising tr(Rᵀ S) of a 3x3 cross-covariance:
    U diag(1, 1, sign det(UVᵀ)) Vᵀ of S's SVD (the reference's Kabsch
    step), in elementwise tensor ops: `torch.linalg.svd` checks its status
    on the host.  With v2, v1 the unit eigenvectors of SᵀS of its two
    largest eigenvalues (ops/lin3.eigh_sym3x3, on S scaled to unit norm)
    and u2, u1 the orthonormalised S v2, S v1,
        R = u2 v2ᵀ + u1 v1ᵀ + (u2 × u1)(v2 × v1)ᵀ,
    which is the SVD's R, and does not depend on the eigenvectors' signs or
    on the basis chosen inside a repeated singular value.  S = 0 gives
    the identity, as the SVD's U = V = I does."""
    n = torch.linalg.vector_norm(S)
    Sn = S / torch.clamp(n, min=1e-30)
    _, V = eigh_sym3x3(Sn.T @ Sn)
    v1, v2 = V[:, 1], V[:, 2]
    u2 = _unit(Sn @ v2)
    a1 = Sn @ v1
    u1 = _unit(a1 - torch.sum(a1 * u2) * u2)
    R = (u2[:, None] * v2[None, :] + u1[:, None] * v1[None, :]
         + _cross(u2, u1)[:, None] * _cross(v2, v1)[None, :])
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    return torch.where(n > 1e-30, R, eye)


def _umeyama(src, dst, w):
    """Weighted rigid alignment src -> dst (closed form, no scaling)."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    mu_s = torch.sum(src * w[:, None], dim=0) / wsum
    mu_d = torch.sum(dst * w[:, None], dim=0) / wsum
    S = ((dst - mu_d) * w[:, None]).T @ (src - mu_s) / wsum
    R = rotation_of(S)
    return R, mu_d - R @ mu_s


def icp_align(src, src_valid, dst, dst_valid, iters: int = 40,
              max_corr: float = 25.0, final_corr: float = 1.0):
    """Point-to-point ICP: (R, t, fitness) aligning src onto dst.

    The correspondence gate follows a geometric schedule max_corr ->
    final_corr, reaching the finest gate a few trips before the last, where
    a transformation-epsilon test ends the loop (the reference's
    `while_loop`: the host reads `active` before each trip that follows
    one at the finest gate, the only trips that can end the loop, and the
    carry stays frozen on the device where it is false).
    fitness = mean squared correspondence distance at the result (PCL's
    getFitnessScore, :1139-1141).  Recorded as the span `loop.icp`:
    `trips` issued, `live` the active ones, `reads` the host reads and
    `read_ns` their wait."""
    with trace_scope("loop.icp") as span:
        dtype, dev = src.dtype, src.device
        tight = 6
        decay = (final_corr / max_corr) ** (
            1.0 / max(iters - 1 - min(tight, iters // 2), 1))
        R = torch.eye(3, dtype=dtype, device=dev)
        t = torch.zeros(3, dtype=dtype, device=dev)
        active = torch.ones((), dtype=torch.bool, device=dev)
        live = torch.zeros((), dtype=torch.int32, device=dev)
        span.update(reads=0, read_ns=0)
        gated = True     # the last trip, at a coarse gate, could not stop
        for i in range(iters):
            if not gated:
                with host_read(span):
                    stop = may_stop(active)
                if stop:
                    break
            span["trips"] = i + 1
            corr = max(max_corr * decay ** i, final_corr)
            moved = src @ R.T + t[None, :]
            idx, d2 = top_k_nn(moved, src_valid, dst, dst_valid, k=1)
            n1, d1 = idx[:, 0].long(), d2[:, 0]
            w = (src_valid & (d1 < corr * corr)
                 & torch.isfinite(d1)).to(dtype)
            Rn, tn = _umeyama(src, dst[n1], w)
            done = ((torch.linalg.vector_norm(tn - t) < 1e-4)
                    & (torch.linalg.vector_norm(Rn - R) < 1e-5))
            gated = corr > final_corr * 1.001
            if gated:
                done = torch.zeros_like(done)
            R = torch.where(active, Rn, R)
            t = torch.where(active, tn, t)
            live = live + active.to(torch.int32)
            active = active & ~done
        span["live"] = live

        moved = src @ R.T + t[None, :]
        _, d2 = top_k_nn(moved, src_valid, dst, dst_valid, k=1)
        ok = src_valid & torch.isfinite(d2[:, 0])
        fitness = (torch.sum(torch.where(ok, d2[:, 0], 0.0))
                   / torch.clamp(torch.sum(ok), min=1))
        return R, t, fitness


def loop_points(store: kf.KeyframeStore, idx, cur, cur_time,
                cfg: SlamConfig):
    """The world-frame points of one loop candidate's alignment, before
    the voxel filter: the surf and corner clouds of the
    ±history_keyframe_search_num ids around the candidate that are live and
    from the old pass (older than the time gate), and the current
    keyframe's at its current estimate.  Returns (sub_xyz, sub_ok, cloud,
    cloud_ok)."""
    dev = store.pos.device
    K = store.capacity
    n_half = cfg.history_keyframe_search_num
    win = (torch.arange(2 * n_half + 1, dtype=torch.int32, device=dev)
           - n_half + idx)
    oldest = torch.clamp(store.count - K, min=0)
    ok_win = (win >= 0) & (win >= oldest) & (win < store.count)
    win_c = torch.remainder(torch.clamp(win, min=0), K).long()
    ok_w = ok_win & (cur_time - store.time[win_c] > cfg.loop_time_gate)
    p_w, q_w = store.pos[win_c][:, None, :], store.quat[win_c][:, None, :]
    keep = ok_w[:, None]
    # the clouds may be sharded over a mesh: read through take_rows
    sw = so3.quat_rotate(q_w, take_rows(store.surf, win_c)) + p_w
    cw = so3.quat_rotate(q_w, take_rows(store.corner, win_c)) + p_w
    sub_xyz = torch.cat([sw.reshape(-1, 3), cw.reshape(-1, 3)])
    sub_ok = torch.cat([
        (take_rows(store.surf_valid, win_c) & keep).reshape(-1),
        (take_rows(store.corner_valid, win_c) & keep).reshape(-1)])

    cur_i = torch.remainder(torch.clamp(cur, min=0), K)
    p_c, q_c = take_row(store.pos, cur_i), take_row(store.quat, cur_i)
    cloud = torch.cat([take_row(store.surf, cur_i),
                       take_row(store.corner, cur_i)])
    cloud_ok = torch.cat([take_row(store.surf_valid, cur_i),
                          take_row(store.corner_valid, cur_i)])
    cloud_w = so3.quat_rotate(q_c[None, :], cloud) + p_c[None, :]
    return sub_xyz, sub_ok, cloud_w, cloud_ok


def loop_clouds(store: kf.KeyframeStore, idx, cur, cur_time,
                cfg: SlamConfig, submap_cap: int, cloud_cap: int):
    """The inputs of one loop candidate's alignment, in the world: the
    submap and the current keyframe's cloud of `loop_points`, both
    voxel-downsampled.  Returns (submap, submap_ok, cloud, cloud_ok)."""
    sub_xyz, sub_ok, cloud_w, cloud_ok = loop_points(store, idx, cur,
                                                     cur_time, cfg)
    submap, submap_ok = voxel_downsample(sub_xyz, sub_ok, cfg.map_surf_leaf,
                                         submap_cap)
    cloud_ds, cloud_ds_ok = voxel_downsample(cloud_w, cloud_ok,
                                             cfg.map_surf_leaf, cloud_cap)
    return submap, submap_ok, cloud_ds, cloud_ds_ok


def polish_grid(submap, submap_ok):
    """The point-to-plane polish's map (the reference package's round-4
    addition; PCL's ICP has none): a 27-cell grid of 1.2 m cells, 64 slots
    each."""
    return build_grid(submap, submap_ok, cell=1.2, table=8192, cap=64)


def _align(store: kf.KeyframeStore, idx, cur, cur_time, cfg: SlamConfig,
           submap_cap: int, cloud_cap: int):
    """Submap + ICP + polish of one loop candidate (the `align` branch of
    the reference's try_close_loop).  Returns (t_rel, q_rel, fitness,
    corr_t, corr_rot)."""
    dtype, dev = store.pos.dtype, store.pos.device
    K = store.capacity
    submap, submap_ok, cloud_ds, cloud_ds_ok = loop_clouds(
        store, idx, cur, cur_time, cfg, submap_cap, cloud_cap)
    R, t, fitness = icp_align(cloud_ds, cloud_ds_ok, submap, submap_ok,
                              iters=cfg.loop_icp_iters,
                              max_corr=cfg.loop_icp_max_corr)
    q_icp = so3.mat_to_quat(R)

    # point-to-plane polish of the ICP result against the same submap
    src = so3.quat_rotate(q_icp[None, :], cloud_ds) + t[None, :]
    grid = polish_grid(submap, submap_ok)
    n_sub = torch.sum(submap_ok)
    t_ref, q_ref, _, _, _ = scan_to_map_grids(
        torch.zeros(3, dtype=dtype, device=dev),
        so3.quat_identity(dtype, device=dev),
        torch.zeros((8, 3), dtype=dtype, device=dev),
        torch.zeros(8, dtype=torch.bool, device=dev), src, cloud_ds_ok,
        grid, grid, n_sub, n_sub, cfg)
    # keep the raw ICP edge if the polish went non-finite
    ok_ref = torch.all(torch.isfinite(t_ref)) & torch.all(
        torch.isfinite(q_ref))
    t_ref = torch.where(ok_ref, t_ref, 0.0)
    q_ref = torch.where(ok_ref, q_ref, so3.quat_identity(dtype, device=dev))
    # total correction T_ref ∘ T_icp, then the corrected current pose
    cur_i = torch.remainder(torch.clamp(cur, min=0), K)
    p_c, q_c = take_row(store.pos, cur_i), take_row(store.quat, cur_i)
    t = so3.quat_rotate(q_ref, t) + t_ref
    q_icp = so3.quat_normalize(so3.quat_mul(q_ref, q_icp))
    p_corr = so3.quat_rotate(q_icp, p_c) + t
    q_corr = so3.quat_normalize(so3.quat_mul(q_icp, q_c))

    # measured relative transform matched -> corrected current, and the
    # correction it implies for the current pose
    m_slot = torch.remainder(torch.clamp(idx, min=0), K)
    p_m, q_m = take_row(store.pos, m_slot), take_row(store.quat, m_slot)
    q_rel = so3.quat_normalize(so3.quat_mul(so3.quat_inv(q_m), q_corr))
    t_rel = so3.quat_rotate_inv(q_m, p_corr - p_m)
    corr_t = torch.linalg.vector_norm(p_corr - p_c)
    corr_rot = torch.linalg.vector_norm(so3.log_quat(q_icp))
    return t_rel, q_rel, fitness, corr_t, corr_rot


def try_close_loop(store: kf.KeyframeStore, cur, cur_time, cfg: SlamConfig,
                   submap_cap: int = 16384, cloud_cap: int = 8192):
    """Detect and align one loop candidate (performLoopClosure,
    :1114-1186).  Returns (matched id, found, accepted, t_rel, q_rel,
    fitness, corr_t): absolute ids; (t_rel, q_rel) the measured transform
    from the matched keyframe to the corrected current keyframe; corr_t the
    correction the edge implies for the current pose."""
    dtype, dev = store.pos.dtype, store.pos.device
    idx, found = detect_loop(store, cur, cur_time, cfg)

    def skip():
        def s(v):
            return torch.full((), v, dtype=dtype, device=dev)
        return (torch.zeros(3, dtype=dtype, device=dev),
                so3.quat_identity(dtype, device=dev), s(torch.inf), s(0.0),
                s(0.0))

    t_rel, q_rel, fitness, corr_t, corr_rot = cond(
        found, lambda: _align(store, idx, cur, cur_time, cfg, submap_cap,
                              cloud_cap), skip(), "loop.align")
    consistent = ((corr_t <= consistency_bound(store, idx, cur, cfg))
                  & (corr_rot <= cfg.loop_consistency_rot_max))
    accepted = (found & (fitness < cfg.history_keyframe_fitness_score)
                & consistent)
    return idx, found, accepted, t_rel, q_rel, fitness, corr_t

"""LINS odometry estimator: state machine + per-scan steps (port of
`lins_tpu/odometry/estimator.py`; reference StateEstimator.hpp:279-463 +
Estimator.cpp:204-284).

A host-side driver streams pre-decoded arrays.  The RUNNING-state step
(propagation -> IESKF -> GN fallback -> composition -> re-anchoring) reads
back to the host only the flags of its data-dependent control flow: the
IESKF's and the GN's stop before each trip (odometry/ieskf.py, gn_icp.py),
and with the IESKF's last flags whether it diverged, so the GN fallback is
issued only on the scans that take it.  On the card each read waits for
the work before it; a frozen trip or a fallback never kept would cost
milliseconds of host issue, a read tens of µs.  Everything else stays on
the device: the feature-count gate and the re-anchoring are selected
there.  The whole engine stays in XYZ.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.frontend import ScanFeatures
from lins_tpu_torch.frontend.pipeline import (
    frontend_post, frontend_pre, process_cloud)
from lins_tpu_torch.geom import so3
from lins_tpu_torch.imu import eskf
from lins_tpu_torch.imu import preintegration as pre
from lins_tpu_torch.odometry import association as assoc
from lins_tpu_torch.odometry import gn_icp, ieskf
from lins_tpu_torch.ops import assoc as assoc_k
from lins_tpu_torch.ops.label import label_components
from lins_tpu_torch.utils.device import resolve_device, resolve_dtype
from lins_tpu_torch.utils.lazy import ChunkMetrics, LazyRows, to_numpy
from lins_tpu_torch.utils.metrics import trace_scope
from lins_tpu_torch.utils.tree import tree_where

STATUS_INIT = 0
STATUS_FIRST_SCAN = 1
STATUS_RUNNING = 3


class NominalState(NamedTuple):
    """Global (world-frame) state (GlobalState without covariance)."""

    rn: torch.Tensor
    vn: torch.Tensor
    qbn: torch.Tensor
    ba: torch.Tensor
    bw: torch.Tensor
    gn: torch.Tensor


def _gravity_vec(cfg: SlamConfig, dtype, device):
    z = torch.zeros((), dtype=dtype, device=device)
    return torch.stack([z, z, z - cfg.gravity])


def identity_nominal(cfg: SlamConfig, dtype=torch.float64,
                     device=None) -> NominalState:
    z = torch.zeros(3, dtype=dtype, device=device)
    return NominalState(rn=z, vn=z, qbn=so3.quat_identity(dtype,
                                                          device=device),
                        ba=z, bw=z, gn=_gravity_vec(cfg, dtype, device))


def dummy_feature_ref(cap: int, dtype=torch.float32, device=None) -> dict:
    """An empty association reference set of `cap` points (the template a
    checkpoint's reference sets load into)."""
    return dict(xyz=torch.zeros((cap, 3), dtype=dtype, device=device),
                ring=torch.zeros(cap, dtype=torch.int32, device=device),
                valid=torch.zeros(cap, dtype=torch.bool, device=device))


def _feature_ref(fc, dtype):
    """Reference-set dict for association."""
    return dict(xyz=fc.xyz.to(dtype), ring=fc.ring, valid=fc.valid)


def _reanchored(fc, rel_rn, rel_qbn, dtype):
    """A feature set de-skewed into its scan's end frame (updatePointCloud,
    StateEstimator.hpp:1116-1161), as an association reference set."""
    return dict(xyz=assoc.transform_to_end(fc.xyz.to(dtype),
                                           fc.rel_time.to(dtype),
                                           rel_rn, rel_qbn),
                ring=fc.ring, valid=fc.valid)


def fallback_or_keep(res: ieskf.IESKFResult, fallback):
    """`fallback()` where the IESKF diverged, else its state, inside the
    span `odometry.fallback` whose `kept` is the divergence.  Decided by
    `res.diverged_read`, the host's copy of the flag that the IESKF's last
    read brought, so it makes no read of its own (`reads` 0)."""
    with trace_scope("odometry.fallback", kept=res.diverged_read, reads=0):
        return fallback() if res.diverged_read else res.state


def running_step_impl(filter_state: eskf.FilterState,
                      global_state: NominalState,
                      feats: ScanFeatures, last_surf, last_corner,
                      dts, accs, gyrs, imu_valid, cfg: SlamConfig):
    """STATUS_RUNNING per-scan step: propagate -> IESKF (-> GN fallback) ->
    global composition -> robocentric reset -> feature re-anchoring.

    Mirrors processPointClouds + processScan (Estimator.cpp:204-252,
    StateEstimator.hpp:435-463).
    """
    dtype = filter_state.rn.dtype

    # 1) IMU propagation across the inter-scan batch
    fs = eskf.propagate(filter_state, dts, accs, gyrs, imu_valid, cfg)

    # 2) insufficient-feature rejection (StateEstimator.hpp:436-439)
    enough = ((torch.sum(feats.less_sharp.valid) > 5)
              & (torch.sum(feats.less_flat.valid) > 10))

    # 3) iterated ESKF update; the reference sets are packed for K4/K5
    #    once, for it and the fallback
    refs = assoc_k.reference_sets(last_surf, last_corner, dtype)
    res = ieskf.update(fs, feats.flat, feats.sharp, last_surf, last_corner,
                       cfg, refs=refs)

    # 4) divergence fallback: GN ICP from the propagated pose
    #    (StateEstimator.hpp:585-592), issued only when the IESKF diverged
    def fallback():
        rn, qbn, _ = gn_icp.estimate_transform(
            fs.rn, fs.qbn, feats.flat, feats.sharp, last_surf, last_corner,
            cfg, refs=refs)
        return res.state._replace(rn=rn, qbn=qbn, P=fs.P)

    upd = fallback_or_keep(res, fallback)
    # if not enough features, skip the measurement update entirely
    upd = tree_where(enough, upd, fs)

    rel_rn, rel_qbn = upd.rn, upd.qbn

    # 5) compose into the global frame (integrateTransformation,
    #    StateEstimator.hpp:608-617) — order matters
    g_qbn_new = so3.quat_normalize(so3.quat_mul(global_state.qbn, rel_qbn))
    g = NominalState(
        rn=so3.quat_rotate(global_state.qbn, rel_rn) + global_state.rn,
        qbn=g_qbn_new,
        vn=so3.quat_rotate(so3.quat_mul(g_qbn_new, so3.quat_inv(rel_qbn)),
                           upd.vn),
        ba=upd.ba, bw=upd.bw,
        gn=so3.quat_rotate(g_qbn_new, upd.gn))

    # 6) robocentric reset + gravity-based roll/pitch correction
    #    (StateEstimator.hpp:444-453)
    fs_reset = eskf.reset_relative(upd, cfg)
    roll, pitch = eskf.calculate_rp_from_gravity(upd.gn, cfg.gravity)
    rpy = so3.quat_to_rpy(g.qbn)
    g = g._replace(qbn=so3.rpy_to_quat(torch.stack([roll, pitch, rpy[2]])))

    # 7) re-anchor current features into this scan's end frame for the next
    #    association; keep the previous reference sets when the new scan is
    #    too sparse (StateEstimator.hpp:1116-1161)
    ls, lf = feats.less_sharp, feats.less_flat
    new_corner = _reanchored(ls, rel_rn, rel_qbn, dtype)
    new_surf = _reanchored(lf, rel_rn, rel_qbn, dtype)
    keep = (torch.sum(ls.valid) >= 5) & (torch.sum(lf.valid) >= 20)

    metrics = dict(iters=res.iters, n_surf=res.n_surf, n_corner=res.n_corner,
                   residual=res.residual_norm, diverged=res.diverged,
                   enough=enough)
    # outlier cloud passed through RAW for the mapping backend — the
    # reference deliberately skips transformToEnd for it
    outl = dict(xyz=feats.outlier.xyz.to(dtype), valid=feats.outlier.valid)
    return (fs_reset, g, tree_where(keep, new_surf, last_surf),
            tree_where(keep, new_corner, last_corner), rel_rn, rel_qbn,
            metrics, outl)


def full_scan_step_impl(filter_state, global_state, last_surf, last_corner,
                        xyz, n_points, dts, accs, gyrs, imu_valid,
                        cfg: SlamConfig):
    """Entire RUNNING-state per-scan path: front end (its labelling is one
    kernel launch) + propagation + IESKF + composition + re-anchoring."""
    with trace_scope("odometry.frontend"):
        _, _, feats = process_cloud(xyz, n_points, cfg)
    return running_step_impl(filter_state, global_state, feats, last_surf,
                             last_corner, dts, accs, gyrs, imu_valid, cfg)


def scan_pre_vmap(xyz_k, n_k, cfg: SlamConfig) -> dict:
    """`frontend_pre` of each scan of a chunk, stacked on a leading (K,)
    axis."""
    pres = [frontend_pre(xyz_k[k], n_k[k], cfg) for k in range(len(xyz_k))]
    return {key: torch.stack([p[key] for p in pres]) for key in pres[0]}


def scan_rest_impl(labels, pre_out, filter_state, global_state, last_surf,
                   last_corner, dts, accs, gyrs, imu_valid, cfg: SlamConfig):
    with trace_scope("odometry.frontend"):
        _, feats = frontend_post(labels, pre_out, cfg)
    return running_step_impl(filter_state, global_state, feats, last_surf,
                             last_corner, dts, accs, gyrs, imu_valid, cfg)


def _chunk_loop(step, state, K):
    """Run `step(state, k) -> (state, per-scan outputs)` over K scans and
    stack the per-scan outputs on a leading (K,) axis: (gs.rn, gs.qbn,
    rel_rn, rel_qbn, metrics, clouds), as the reference package's chunk
    `lax.scan` returns them."""
    outs = []
    for k in range(K):
        with trace_scope("odometry.step", scan=k):
            (fs, gs, lsurf, lcorn, rel_rn, rel_qbn, metrics,
             outl) = step(state, k)
        state = (fs, gs, lsurf, lcorn)
        clouds = dict(cxyz=lcorn["xyz"], cval=lcorn["valid"],
                      sxyz=lsurf["xyz"], sval=lsurf["valid"],
                      oxyz=outl["xyz"], oval=outl["valid"])
        outs.append((gs.rn, gs.qbn, rel_rn, rel_qbn, metrics, clouds))
    rns, qbns, rel_rns, rel_qbns = (torch.stack([o[i] for o in outs])
                                    for i in range(4))
    metrics = {key: torch.stack([o[4][key] for o in outs])
               for key in outs[0][4]}
    clouds = {key: torch.stack([o[5][key] for o in outs])
              for key in outs[0][5]}
    return state, (rns, qbns, rel_rns, rel_qbns, metrics, clouds)


def chunk_scan_step_impl(filter_state, global_state, last_surf, last_corner,
                         xyz_k, n_k, dts_k, accs_k, gyrs_k, imu_valid_k,
                         cfg: SlamConfig):
    """K consecutive RUNNING-state scans, each through `full_scan_step_impl`
    (one label launch per scan)."""
    def step(state, k):
        return full_scan_step_impl(*state, xyz_k[k], n_k[k], dts_k[k],
                                   accs_k[k], gyrs_k[k], imu_valid_k[k], cfg)

    return _chunk_loop(step, (filter_state, global_state, last_surf,
                              last_corner), len(xyz_k))


def chunk_rest_impl(labels_k, pre_k, filter_state, global_state, last_surf,
                    last_corner, dts_k, accs_k, gyrs_k, imu_valid_k,
                    cfg: SlamConfig):
    """Chunked split-pipeline tail: `frontend_post` + running step over K
    pre-labelled scans (pairs with `scan_pre_vmap` and one label launch
    over the whole (K, L, S) chunk)."""
    def step(state, k):
        pre_out = {key: v[k] for key, v in pre_k.items()}
        return scan_rest_impl(labels_k[k], pre_out, *state, dts_k[k],
                              accs_k[k], gyrs_k[k], imu_valid_k[k], cfg)

    return _chunk_loop(step, (filter_state, global_state, last_surf,
                              last_corner), len(labels_k))


def odometry_chunk_impl(state, xyz_k, n_k, dts_k, accs_k, gyrs_k,
                        imu_valid_k, cfg: SlamConfig):
    """K consecutive RUNNING-state scans from `state` = (filter state,
    global state, last surf, last corner).  With `cfg.use_pallas` the chunk
    runs as pre (all K scans) -> one label launch over the (K, L, S) chunk
    -> post + running step per scan; otherwise each scan runs the whole
    front end in turn.  Returns (state, (rns, qbns, rel_rns, rel_qbns,
    metrics, clouds)) stacked per scan."""
    with trace_scope("odometry.chunk", K=len(xyz_k)):
        if cfg.use_pallas:
            with trace_scope("odometry.frontend"):
                pre_k = scan_pre_vmap(xyz_k, n_k, cfg)
                labels_k = label_components(
                    pre_k["e_right"], pre_k["e_down"], pre_k["eligible"])
            return chunk_rest_impl(labels_k, pre_k, *state, dts_k, accs_k,
                                   gyrs_k, imu_valid_k, cfg)
        return chunk_scan_step_impl(*state, xyz_k, n_k, dts_k, accs_k,
                                    gyrs_k, imu_valid_k, cfg)


def second_scan_step(feats: ScanFeatures, last_surf, last_corner,
                     preint: pre.Preintegration, imu_acc, imu_gyr,
                     ba0, bw0, cfg: SlamConfig):
    """Two-scan bootstrap (processSecondScan, StateEstimator.hpp:379-425)."""
    dtype, dev = preint.delta_p.dtype, preint.delta_p.device
    gn = _gravity_vec(cfg, dtype, dev)

    ql = preint.delta_q
    pl = preint.delta_p + 0.5 * gn * preint.sum_dt * preint.sum_dt

    rn, qbn, _ = gn_icp.estimate_transform(
        pl, ql, feats.flat, feats.sharp, last_surf, last_corner, cfg)

    # initial velocity from relative translation (estimateInitialState,
    # StateEstimator.hpp:1408-1419); biases from config or static calibration
    v = rn / torch.clamp(preint.sum_dt, min=1e-6)
    ba0 = torch.as_tensor(ba0, dtype=dtype, device=dev)
    bw0 = torch.as_tensor(bw0, dtype=dtype, device=dev)

    roll, pitch = eskf.calculate_rp_from_gravity(imu_acc - ba0, cfg.gravity)
    g = NominalState(
        rn=rn, vn=v,
        qbn=so3.rpy_to_quat(torch.stack([roll, pitch,
                                         torch.zeros_like(roll)])),
        ba=ba0, bw=bw0, gn=gn)

    # The reference initializes the filter with rn=r1 and qbn=I and performs
    # no robocentric reset until the *next* scan (StateEstimator.hpp:404-406);
    # as in the reference package, the relative filter is anchored at
    # identity right away: init with the refined (rn, qbn), then reset(1).
    fs = eskf.initial_state(cfg, rn=rn, vn=v, qbn=qbn, ba=ba0, bw=bw0,
                            acc=imu_acc, gyr=imu_gyr, dtype=dtype, device=dev)
    fs = eskf.reset_relative(fs, cfg)

    new_corner = _reanchored(feats.less_sharp, rn, qbn, dtype)
    new_surf = _reanchored(feats.less_flat, rn, qbn, dtype)
    return fs, g, new_surf, new_corner, rn, qbn


def first_frontend(xyz, n_points, cfg: SlamConfig):
    """Front end + the feature-count gate values."""
    with trace_scope("odometry.frontend"):
        _, _, feats = process_cloud(xyz, n_points, cfg)
    counts = torch.stack([torch.sum(feats.less_sharp.valid),
                          torch.sum(feats.less_flat.valid)]).to(torch.int32)
    return feats, counts


def first_scan_init(feats: ScanFeatures, t, acc0, gyr0, ba, bw, dtype,
                    device, cfg: SlamConfig):
    """Filter/preintegration init + reference feature sets
    (processFirstPointCloud, Estimator.cpp:145-175)."""
    fs = eskf.initial_state(cfg, time=t, acc=acc0, gyr=gyr0, dtype=dtype,
                            device=device)
    preint = pre.init_preintegration(acc0, gyr0, ba, bw, dtype=dtype,
                                     device=device)
    return (fs, preint, _feature_ref(feats.less_flat, dtype),
            _feature_ref(feats.less_sharp, dtype))


def second_scan_full(feats: ScanFeatures, last_surf, last_corner, preint,
                     dts, accs, gyrs, valid, acc_l, gyr_l, ba0, bw0, t,
                     cfg: SlamConfig):
    """Preintegration + the two-scan bootstrap + time stamping."""
    preint = pre.preintegrate(preint, dts, accs, gyrs, valid)
    fs, g, new_surf, new_corner, rn, qbn = second_scan_step(
        feats, last_surf, last_corner, preint, acc_l, gyr_l, ba0, bw0, cfg)
    return (fs._replace(time=t), g, new_surf, new_corner, rn, qbn)


def state_from_numpy(d: dict, device, dtype) -> dict:
    """The odometry state of the reference package as the port's tensors.

    `d` holds numpy arrays (or scalars) keyed by field name:
      filter_state: {rn, vn, qbn, ba, bw, gn, P, time, acc_last, gyr_last}
      global_state: {rn, vn, qbn, ba, bw, gn}
      last_surf, last_corner: {xyz, ring, valid}; last_outlier: {xyz, valid}
      status, time; imu_t (n,), imu_a (n,3), imu_g (n,3); last_imu
      (acc, gyr) or None.
    Returns the same keys with FilterState / NominalState / dicts of tensors
    on `device` (floating fields in `dtype`, rings int32, masks bool).
    """
    def tensor(x):
        a = np.array(x)        # a writable copy: JAX hands out read-only views
        if a.dtype == bool:
            return torch.as_tensor(a, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int32), device=device)
        return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)

    def fields(src, keys):
        return {k: tensor(src[k]) for k in keys}

    return dict(
        filter_state=eskf.FilterState(**fields(d["filter_state"],
                                               eskf.FilterState._fields)),
        global_state=NominalState(**fields(d["global_state"],
                                           NominalState._fields)),
        last_surf=fields(d["last_surf"], ("xyz", "ring", "valid")),
        last_corner=fields(d["last_corner"], ("xyz", "ring", "valid")),
        last_outlier=(fields(d["last_outlier"], ("xyz", "valid"))
                      if d.get("last_outlier") is not None else None),
        status=int(d["status"]), time=float(d["time"]),
        imu_t=[float(t) for t in np.asarray(d["imu_t"])],
        imu_a=[np.asarray(a, float) for a in np.asarray(d["imu_a"])],
        imu_g=[np.asarray(g, float) for g in np.asarray(d["imu_g"])],
        last_imu=(None if d.get("last_imu") is None else
                  tuple(np.asarray(v, float) for v in d["last_imu"])),
    )


class LinsOdometry:
    """Host-side odometry driver (replaces LinsFusion, Estimator.cpp:24-348).

    device: the card unless given ("cpu" runs the plain label version; the
    port never falls back to the CPU by itself).  dtype: the filter dtype,
    float32 unless given.
    """

    def __init__(self, cfg: SlamConfig, dtype=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.status = STATUS_INIT
        self.filter_state = None
        self.global_state = identity_nominal(cfg, self.dtype, self.device)
        self.last_surf = None
        self.last_corner = None
        self.last_outlier = None
        self.preint = None
        self.rel_pose = None
        # imu buffer (host lists)
        self._imu_t, self._imu_a, self._imu_g = [], [], []
        self._last_imu = None
        self.time = -np.inf
        self.trajectory = []   # (t, pos(3), quat wxyz(4)) per processed scan
        self.metrics = []

        mis = np.deg2rad(cfg.imu_misalign_angle)
        c, s = np.cos(mis), np.sin(mis)
        # alignIMUtoVehicle: out = R(0,0,yaw)ᵀ in (Estimator.cpp:286-292)
        self._R_mis_T = np.asarray([[c, s, 0], [-s, c, 0], [0, 0, 1]])

        # static IMU bias calibration (Estimator.cpp:322-348, as intended)
        self._calib_sum_a = np.zeros(3)
        self._calib_sum_g = np.zeros(3)
        self._calib_n = 0
        self.estimated_ba = np.asarray(cfg.init_ba, float)
        self.estimated_bw = np.asarray(cfg.init_bw, float)
        self.imu_calibrated = not cfg.calibrate_imu

    # ------------------------------------------------------------ transfers
    def _dev(self, x, dtype):
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

    def _scan_tensors(self, xyz, n_points):
        """A scan (or a chunk of scans) as float32 points and int32 counts
        on the device; tensors already there pass through."""
        xyz = (xyz if isinstance(xyz, torch.Tensor)
               else self._dev(np.asarray(xyz, np.float32), torch.float32))
        if isinstance(n_points, torch.Tensor):
            n = n_points
        elif np.ndim(n_points) == 0:
            # a fill, not a host->device copy
            n = torch.full((), int(n_points), dtype=torch.int32,
                           device=self.device)
        else:
            n = self._dev(np.asarray(n_points, np.int32), torch.int32)
        return xyz, n

    # ------------------------------------------------------------------ IMU
    def add_imu(self, t: float, acc, gyr):
        acc = self._R_mis_T @ np.asarray(acc, float)
        gyr = self._R_mis_T @ np.asarray(gyr, float)
        if not self.imu_calibrated:
            self._calib_sum_a += acc - np.asarray([0.0, 0.0, self.cfg.gravity])
            self._calib_sum_g += gyr
            self._calib_n += 1
            if self._calib_n >= self.cfg.average_nums:
                self.estimated_ba = self._calib_sum_a / self._calib_n
                self.estimated_bw = self._calib_sum_g / self._calib_n
                self.imu_calibrated = True
        self._imu_t.append(float(t))
        self._imu_a.append(acc)
        self._imu_g.append(gyr)
        self._last_imu = (acc, gyr)

    def _imu_tensors(self, d, a, g, v):
        return (self._dev(d, self.dtype), self._dev(a, self.dtype),
                self._dev(g, self.dtype), self._dev(v, torch.bool))

    def _imu_batch_np(self, t_end: float):
        """Propagation steps covering (self.time, t_end], padded, as host
        numpy (mirrors the drain loop, Estimator.cpp:228-236)."""
        K = self.cfg.max_imu_per_scan
        dts = np.zeros(K)
        accs = np.zeros((K, 3))
        gyrs = np.zeros((K, 3))
        valid = np.zeros(K, bool)
        cur = self.time
        i = 0
        for t, a, g in zip(self._imu_t, self._imu_a, self._imu_g):
            if t <= cur or i >= K:
                continue
            if cur >= t_end:
                break
            step_end = min(t, t_end)
            dts[i] = step_end - cur
            accs[i] = a
            gyrs[i] = g
            valid[i] = dts[i] > 0
            cur = step_end
            i += 1
        # drop consumed imu samples
        self._drop_imu_before(min(cur, t_end) - 1e-9)
        return dts, accs, gyrs, valid

    def _drop_imu_before(self, t: float):
        keep = [k for k, tt in enumerate(self._imu_t) if tt > t]
        self._imu_t = [self._imu_t[k] for k in keep]
        self._imu_a = [self._imu_a[k] for k in keep]
        self._imu_g = [self._imu_g[k] for k in keep]

    def _imu_chunk_np(self, ts):
        """Per-scan padded IMU batches for a chunk of scan-end times (host
        numpy); consumes the IMU buffer and advances self.time."""
        K = len(ts)
        M = self.cfg.max_imu_per_scan
        dts, accs = np.zeros((K, M)), np.zeros((K, M, 3))
        gyrs, valid = np.zeros((K, M, 3)), np.zeros((K, M), bool)
        for k in range(K):
            dts[k], accs[k], gyrs[k], valid[k] = self._imu_batch_np(
                float(ts[k]))
            self.time = float(ts[k])
        return dts, accs, gyrs, valid

    # ----------------------------------------------------------------- scans
    def add_scan(self, t: float, xyz, n_points):
        """Process one raw scan; returns the global pose (pos, quat)
        tensors, or None while initializing.

        In the RUNNING state the host reads only the odometry's loop and
        fallback flags (`running_step_impl`), so the fused pose stays on the
        card; read `.trajectory` (or call `trajectory_arrays`) to
        materialize results.
        """
        cfg = self.cfg
        xyz_t, n_t = self._scan_tensors(xyz, n_points)
        if self.status == STATUS_RUNNING:
            imu = self._imu_tensors(*self._imu_batch_np(t))
            state = (self.filter_state, self.global_state, self.last_surf,
                     self.last_corner)
            if cfg.use_pallas:
                # split per-scan pipeline: pre -> label kernel -> rest
                with trace_scope("odometry.frontend"):
                    pre_out = frontend_pre(xyz_t, n_t, cfg)
                    labels = label_components(pre_out["e_right"],
                                              pre_out["e_down"],
                                              pre_out["eligible"])
                out = scan_rest_impl(labels, pre_out, *state, *imu, cfg)
            else:
                out = full_scan_step_impl(*state, xyz_t, n_t, *imu, cfg)
            (self.filter_state, self.global_state, self.last_surf,
             self.last_corner, rel_rn, rel_qbn, metrics,
             self.last_outlier) = out
            self.time = t
            self.rel_pose = (rel_rn, rel_qbn)
            self.metrics.append(metrics)  # device tensors; lazy
            self._record(t)
            return self.global_state.rn, self.global_state.qbn

        # bootstrap path: one host read per scan (the feature-count gate)
        feats, counts = first_frontend(xyz_t, n_t, cfg)
        n_corner, n_surf = (int(v) for v in counts.tolist())
        d, dev = self.dtype, self.device

        if self.status == STATUS_INIT:
            if n_corner < 10 or n_surf < 100:
                return None
            if self._last_imu is None or not self.imu_calibrated:
                return None
            acc0, gyr0 = self._last_imu
            (self.filter_state, self.preint, self.last_surf,
             self.last_corner) = first_scan_init(
                feats, t, acc0, gyr0, self.estimated_ba, self.estimated_bw,
                d, dev, cfg)
            self.time = t
            self._drop_imu_before(t)
            self.status = STATUS_FIRST_SCAN
            return None

        if self.status == STATUS_FIRST_SCAN:
            if n_corner < 10 or n_surf < 100:
                self.status = STATUS_INIT
                return None
            imu = self._imu_tensors(*self._imu_batch_np(t))
            acc_l, gyr_l = (self._dev(v, d) for v in self._last_imu)
            (self.filter_state, self.global_state, self.last_surf,
             self.last_corner, rel_rn, rel_qbn) = second_scan_full(
                feats, self.last_surf, self.last_corner, self.preint, *imu,
                acc_l, gyr_l, self.estimated_ba, self.estimated_bw,
                self._dev(t, d), cfg)
            self.time = t
            self.rel_pose = (rel_rn, rel_qbn)
            self.last_outlier = dict(xyz=feats.outlier.xyz.to(d),
                                     valid=feats.outlier.valid)
            self.status = STATUS_RUNNING
            self._record(t)
            return self._pose()

        return None  # unreachable

    def add_scan_chunk(self, ts, xyzs, n_points, imu=None):
        """Process K consecutive scans, reading back only the odometry's
        loop and fallback flags (`running_step_impl`).  Requires
        STATUS_RUNNING — feed the first scans through add_scan until it
        returns a pose, then switch to chunks.

        ts: (K,) scan-end times; xyzs: (K, max_points, 3); n_points: (K,).
        imu: optional prebuilt (dts, accs, gyrs, valid) device blocks from
        `prefetch_chunks(..., with_imu=True)` — with them this method issues
        no host->device transfer.  The chunk runs through
        `odometry_chunk_impl`.
        Appends K trajectory/metrics entries; returns the last global pose.
        """
        if self.status != STATUS_RUNNING:
            raise RuntimeError("add_scan_chunk needs the RUNNING state: feed "
                               "scans through add_scan until it returns a "
                               "pose")
        K = len(ts)
        if imu is None:
            imu = self._imu_tensors(*self._imu_chunk_np(ts))
        else:
            self.time = float(ts[-1])
        xyz_k, n_k = self._scan_tensors(xyzs, n_points)
        state, outs = odometry_chunk_impl(
            (self.filter_state, self.global_state, self.last_surf,
             self.last_corner), xyz_k, n_k, *imu, self.cfg)
        rns, qbns, rel_rns, rel_qbns, metrics, clouds = outs
        (self.filter_state, self.global_state, self.last_surf,
         self.last_corner) = state
        self.rel_pose = (rel_rns[-1], rel_qbns[-1])
        # whole-chunk per-scan pose/cloud blocks (LinsSlam.run_replay)
        self.last_chunk_poses = (rns, qbns)
        self.last_chunk_clouds = clouds
        rn_rows, qbn_rows = LazyRows(rns), LazyRows(qbns)
        metric_blocks = {key: LazyRows(val) for key, val in metrics.items()}
        for k in range(K):
            self.trajectory.append((float(ts[k]), rn_rows.row(k),
                                    qbn_rows.row(k)))
            self.metrics.append(ChunkMetrics(metric_blocks, k))
        return self.global_state.rn, self.global_state.qbn

    def warmup(self, chunk: int | None = None):
        """On the card, build and load every kernel library of the port
        (ops/build.py: the nvcc processes started together; a library
        newer than its source is reused), so that no build lands inside a
        run; the reference package's warmup compiles its programs ahead of
        time in the same place.  Nothing to do on the CPU."""
        if self.device.type != "cuda":
            return
        from lins_tpu_torch.ops import build

        build.build_all()
        for name in build.KERNELS:
            build.load(name)
        torch.cuda.synchronize(self.device)

    def prefetch_chunks(self, scan_times, xyzs, n_points, chunk: int,
                        with_imu: bool = False):
        """Stage a replay sequence on the device as chunk-shaped buffers:
        (ts, xyz (K,P,3) float32, n (K,) int32) per chunk, plus with
        `with_imu` the drained IMU stream as a 4-tuple `imu=(dts, accs, gyrs,
        valid)` for `add_scan_chunk(..., imu=imu)`.  The hot loop then issues
        no host->device transfer.  Requires all IMU up to the last scan to
        be buffered when `with_imu`; consumes it and advances self.time.
        """
        n = len(scan_times)
        out = []
        for s in range(0, n - n % chunk, chunk):
            ts = np.asarray(scan_times[s:s + chunk], float)
            xs, ns = self._scan_tensors(
                np.asarray(xyzs[s:s + chunk], np.float32),
                np.asarray(n_points[s:s + chunk], np.int32))
            if with_imu:
                out.append((ts, xs, ns,
                            self._imu_tensors(*self._imu_chunk_np(ts))))
            else:
                out.append((ts, xs, ns))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    # ----------------------------------------------------------- state I/O
    def load_numpy_state(self, d: dict):
        """Take over an odometry state given as numpy arrays keyed by field
        name (`state_from_numpy`), e.g. the reference package's after its
        bootstrap."""
        s = state_from_numpy(d, self.device, self.dtype)
        self.filter_state = s["filter_state"]
        self.global_state = s["global_state"]
        self.last_surf, self.last_corner = s["last_surf"], s["last_corner"]
        self.last_outlier = s["last_outlier"]
        self.status, self.time = s["status"], s["time"]
        self._imu_t, self._imu_a, self._imu_g = (s["imu_t"], s["imu_a"],
                                                 s["imu_g"])
        self._last_imu = s["last_imu"]
        return self

    def _pose(self):
        return (to_numpy(self.global_state.rn),
                to_numpy(self.global_state.qbn))

    def _record(self, t):
        # store device tensors without synchronizing; materialize on demand
        self.trajectory.append((t, self.global_state.rn,
                                self.global_state.qbn))

    def trajectory_arrays(self):
        """(times (N,), pos (N,3), quat (N,4)) as host numpy arrays."""
        ts = np.asarray([t for t, _, _ in self.trajectory])
        ps = np.stack([to_numpy(p) for _, p, _ in self.trajectory])
        qs = np.stack([to_numpy(q) for _, _, q in self.trajectory])
        return ts, ps, qs

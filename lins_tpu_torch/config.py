"""Typed, frozen configuration for the PyTorch/CUDA port of LINS.

A copy of `lins_tpu/config.py` with every field name kept, so one
`to_dict()` drives both packages in the parity tests.  In the port,
`use_pallas` only picks the split per-chunk driver shape (pre -> label ->
rest); on the card the connected-components labelling always runs as the
CUDA kernel in `lins_tpu_torch/ops/label.py`.  Likewise the scan-to-map
candidate selection always runs as the CUDA kernel in
`lins_tpu_torch/ops/select.py`; `use_pallas_select` only picks its prune
bound (ops/grid_nn.gather_candidates).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    # --- sensor geometry (exp_port.yaml:9-11; parameters.h:82-85) ---
    line_num: int = 16               # vertical rings
    scan_num: int = 1800             # azimuth columns
    scan_period: float = 0.1         # seconds per sweep
    ang_res_x: float = 0.2           # deg, azimuth resolution
    ang_res_y: float = 2.0           # deg, vertical resolution
    ang_bottom: float = 15.0 + 0.1   # deg, lowest beam elevation magnitude
    ground_scan_ind: int = 5         # rings considered for ground extraction
    sensor_mount_angle: float = 0.0  # deg

    # --- segmentation (parameters.h:88-92) ---
    segment_theta: float = 1.0472        # rad, region-growing angle threshold
    segment_valid_point_num: int = 5
    segment_valid_line_num: int = 3

    # --- feature extraction (exp_port.yaml:12-13; parameters.h:93-95) ---
    edge_threshold: float = 0.5
    surf_threshold: float = 0.5
    # feature picking mode: "exact" replays the reference's sequential greedy
    # suppression loops (StateEstimator.hpp:719-827); "fast" picks curvature
    # local extrema in ±5-point windows — the same spacing the greedy
    # suppression enforces — in a handful of vector ops.
    feature_mode: str = "fast"
    # split per-chunk driver (pre -> label kernel -> rest); see module doc
    use_pallas: bool = False
    # prune bound of the mapping backend's candidate selection: the first
    # dropped distance (True) or the C-th kept one; see module doc
    use_pallas_select: bool = False
    edge_feature_num: int = 2        # sharp corners per sector
    edge_less_feature_num: int = 20  # less-sharp corners per sector
    surf_feature_num: int = 4        # flat surf per sector
    sections_total: int = 6          # sectors per ring
    surf_leaf_size: float = 0.2      # less-flat voxel filter (StateEstimator.hpp:189)

    # --- odometry / IESKF (exp_port.yaml:14-20) ---
    nearest_feature_search_sq_dist: float = 25.0
    icp_freq: int = 1
    num_iter: int = 30
    lidar_scale: float = 1.0
    lidar_std: float = 0.01

    # --- IMU noise (exp_port.yaml:29-32; scaled in KalmanFilter.hpp:263-266) ---
    acc_n: float = 70000.0   # * ug
    gyr_n: float = 0.1       # * dph
    acc_w: float = 500.0     # * ugpsHz
    gyr_w: float = 0.05      # * dpsh

    # --- initial stds (exp_port.yaml:34-62) ---
    init_pos_std: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    init_vel_std: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    init_att_std: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # deg
    init_acc_std: Tuple[float, float, float] = (0.01, 0.01, 0.02)
    init_gyr_std: Tuple[float, float, float] = (0.002, 0.002, 0.002)

    # --- initial biases / extrinsics (exp_port.yaml:64-90) ---
    init_ba: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    init_bw: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # static IMU bias calibration (exp_port.yaml:4-6; the reference's
    # performImuBiasEstimation is vestigial/commented, Estimator.cpp:322-348 —
    # implemented here as intended: average the first `average_nums` samples
    # at rest, ba = mean(acc) - (0,0,g), bw = mean(gyr))
    calibrate_imu: bool = False
    average_nums: int = 100
    imu_lidar_extrinsic_angle: float = 0.0   # deg, yaw lidar->vehicle
    imu_misalign_angle: float = 0.0          # deg, yaw imu->vehicle

    # --- mapping (parameters.h:80-101) ---
    mapping_process_interval: float = 0.3
    surrounding_keyframe_search_radius: float = 50.0
    surrounding_keyframe_search_num: int = 50
    history_keyframe_search_radius: float = 5.0
    history_keyframe_search_num: int = 25
    history_keyframe_fitness_score: float = 0.3
    loop_closure_enabled: bool = True
    # With loop_closure_enabled=True but loop_attempts=False the mapper keeps
    # the recent-keyframe window (the reference's loop-closure-mode local map,
    # lidar_mapping_node.cpp:1205-1246) but never fires the 1 Hz loop thread —
    # the "window, no loops" baseline of the LC necessity matrix.  The
    # reference couples both to one flag (loopClosureEnableFlag).
    loop_attempts: bool = True
    loop_time_gate: float = 30.0             # min age of loop candidates (s)
    # Local-map selection while loop closure is enabled: "recent" follows
    # the reference (last n_window keyframes,
    # lidar_mapping_node.cpp:1205-1246); "radius" uses the 50 m-radius
    # nearest-keyframe selection in LC mode too, so on a revisit the
    # scan-to-map GN relocalizes directly against the (loop-corrected) old
    # map instead of only the trailing window — the round-5 matrix showed
    # the radius map is what made the no-LC radius mode causally strongest
    # on multi-lap courses (bigloop2: 0.362 vs LC-recent 0.426).
    lc_map_mode: str = "recent"
    # loop ICP budget: coarse-to-fine gate max_corr -> 1 m over `iters`
    # (the reference's PCL ICP runs 100 m / 100 iters,
    # lidar_mapping_node.cpp:1127-1138; candidates sit within the 5 m
    # detection radius, so 25 m covers its practical recovery envelope)
    loop_icp_iters: int = 40
    loop_icp_max_corr: float = 25.0
    # Odometry-consistency gate on proposed loop edges (absent from the
    # reference — its fitness-only gate admits self-similar-submap
    # misalignments): the edge's implied pose correction must not exceed
    # frac x (odometry arc length between the two keyframes), floored at
    # min_m, and its rotation correction must stay under rot_max rad.
    loop_consistency_frac: float = 0.05      # ~2x a pessimistic LIO drift rate
    loop_consistency_min_m: float = 2.0
    loop_consistency_rot_max: float = 0.5    # rad (~29 deg)
    # Pose-graph edge variances.  The reference feeds gtsam 1e-6/1e-8
    # odometry variances (lidar_mapping_node.cpp:383-385) which, against
    # fitness-weighted loop factors, lets a loop edge correct only ~2% of
    # accumulated drift; we default to realistic scan-to-map uncertainty so
    # accepted loops actually close (deviation documented in README).
    pg_odom_rot_var: float = 1e-4            # rad^2
    pg_odom_pos_var: float = 4e-4            # m^2  (2 cm std)
    # Loop-edge variance = fitness * pg_loop_var_scale.  Raw ICP fitness is
    # mean squared point distance, floored by map voxel discretization
    # (~0.1-0.3 m RMS at 0.4 m leaves) even for mm-accurate pose alignment;
    # the scale converts it into a pose-uncertainty-like variance.
    pg_loop_var_scale: float = 0.01
    # Robust (Huber) loss on LOOP edges in the pose-graph solve, in
    # SOLVE-WEIGHT Mahalanobis-sigma units (0 disables).  A loop edge whose
    # weighted residual norm exceeds this is IRLS-downweighted by
    # delta/||r||_W each GN iteration, so a bad edge that slips past the
    # fitness+consistency gates degrades gracefully instead of entering
    # least squares at full weight.  Units: the solve weight w=1/(fitness *
    # pg_loop_var_scale) implies a sigma 1/sqrt(pg_loop_var_scale) = 10x
    # TIGHTER than the honest ICP alignment sigma sqrt(fitness); 15 here
    # = 1.5 honest sigmas, which keeps genuine drift corrections (a few
    # honest sigmas at their first solve) essentially quadratic while
    # multi-sigma misalignments saturate.  (Measured: delta=1.5 in solve
    # units capped a constructed 0.58 m true closure at 28% corrected —
    # the Huber force balance, not slow convergence.)  Odometry edges
    # (j == i+1) stay quadratic — chain-redundant and self-consistent.
    # The reference has no robust loss (gtsam noise models are plain
    # Gaussian, lidar_mapping_node.cpp:1160-1184).
    pg_loop_huber: float = 15.0
    # Only run the pose-graph solve + keyframe/window rewrite when the loop
    # edge's implied correction of the current pose exceeds this (meters);
    # smaller accepted edges are still ADDED to the graph (they stiffen it
    # and are incorporated by the next triggered or final solve) but don't
    # churn the live map.  This is iSAM2's relinearizeThreshold idea
    # (lidar_mapping_node.cpp:248-250, 0.01 rad/m there): the round-4
    # 2.2-lap bigloop ran 55 solves whose re-rewrites put 26 >5 cm jumps
    # (2.8 m total) into the causal stream and 2 local-jitter spikes, while
    # the post-first-closure corrections were mostly sub-5 cm.  0 = solve
    # on every accepted loop (round-4 behavior).
    loop_rewrite_min_m: float = 0.05
    keyframe_gate_meters: float = 0.3        # lidar_mapping_node.cpp:1660-1667
    map_corner_leaf: float = 0.2             # lidar_mapping_node.cpp:283-291
    map_surf_leaf: float = 0.4
    map_outlier_leaf: float = 0.4
    scan2map_iters: int = 10                 # lidar_mapping_node.cpp:1640
    # full local-map compaction rebuild every N keyframe inserts (bounds
    # voxel-map tombstone leak + f32 sum drift; ops/voxel_map.py). The
    # reference has no equivalent — it rebuilds every step.
    map_rebuild_interval: int = 64
    # Static slot counts of the scan-to-map GN QUERY sets (the gather/sort/
    # re-rank cost of mapping/scan2map.py is paid on the PADDED size, and
    # the voxel-downsampled queries compact valid entries to the front, so a
    # tighter cap is a free proportional speedup).  None = the keyframe
    # store cloud capacities (mapper.derive_caps).  Per-sensor presets set
    # these from measured occupancy (tools/r4_query_counts.py); queries
    # beyond the cap are dropped — the mapper logs a `query_overflow`
    # metric when a scan saturates its cap.
    map_query_corner: int | None = None
    map_query_surf: int | None = None        # merged surf+outlier query set
    # Candidate-cache width C of the scan-to-map 5-NN (mapping/scan2map.py):
    # the per-mapping-step gather prunes each query's neighborhood to its
    # nearest C points and every GN iteration re-ranks that (Q, C) cache.
    # Cost of BOTH the selection (C+1 min/extract passes in the Pallas
    # kernel) and the re-rank is linear in C; correctness is C-independent —
    # the d2C staleness bound triggers an in-loop re-gather whenever pruning
    # could hide a true neighbor, so accepted matches always equal brute
    # force.  Smaller C trades cheaper iterations for a tighter bound (more
    # re-gathers).
    s2m_cand: int = 64

    # --- fixed capacities (static shapes) ---
    max_imu_per_scan: int = 64       # IMU samples padded per scan interval (400Hz * 0.1s + slack)
    max_sharp: int = 192             # 16 rings * 6 sectors * 2
    max_less_sharp: int = 2048       # >= 16 * 6 * 20
    max_flat: int = 512              # >= 16 * 6 * 4
    max_less_flat: int = 6144        # voxel-downsampled ground/unlabeled points
    max_outlier: int = 4096
    max_points: int = 60000          # raw cloud capacity
    max_keyframes: int = 512         # mapping backend capacity (dense-PGO
                                     # friendly; raise with the sharded solver)
    max_map_corner: int = 32768      # assembled local corner map capacity
    max_map_surf: int = 65536        # assembled local surf map capacity

    # --- physical constants (parameters.h:63-71) ---
    gravity: float = 9.81

    # convenience -----------------------------------------------------------
    @property
    def grid_size(self) -> int:
        return self.line_num * self.scan_num

    @property
    def segment_alpha_x(self) -> float:
        return self.ang_res_x * math.pi / 180.0

    @property
    def segment_alpha_y(self) -> float:
        return self.ang_res_y * math.pi / 180.0

    # scaled continuous-time noise densities (KalmanFilter.hpp:263-266)
    @property
    def acc_noise(self) -> float:
        ug = self.gravity / 1e6
        return (self.acc_n * ug) ** 2

    @property
    def gyr_noise(self) -> float:
        dph = (math.pi / 180.0) / 3600.0
        return (self.gyr_n * dph) ** 2

    @property
    def acc_walk(self) -> float:
        ug = self.gravity / 1e6
        return (self.acc_w * ug) ** 2

    @property
    def gyr_walk(self) -> float:
        dpsh = (math.pi / 180.0) / math.sqrt(3600.0)
        return (self.gyr_w * dpsh) ** 2

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    # serialisation ---------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SlamConfig":
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k not in fields:
                continue
            ftype = fields[k].type
            try:
                if isinstance(v, (list, tuple)):
                    v = tuple(float(x) for x in v)
                elif ftype in ("int", int):
                    v = int(v)
                elif ftype in ("float", float):
                    v = float(v)
                elif ftype in ("bool", bool):
                    v = bool(v)
            except (TypeError, ValueError) as e:
                raise ValueError(f"config field {k!r}: cannot coerce {v!r}") from e
            kw[k] = v
        return cls(**kw)

    @classmethod
    def from_yaml(cls, path: str) -> "SlamConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(_normalize_reference_yaml(raw))

    @classmethod
    def from_json(cls, path: str) -> "SlamConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def _normalize_reference_yaml(raw: dict) -> dict:
    """Accept both our field names and the reference exp_port.yaml schema."""
    out = {}
    alias = {
        "max_lidar_nums": "max_points",
    }
    for k, v in raw.items():
        k = alias.get(k, k)
        if isinstance(v, dict) and "data" in v:  # opencv-matrix blobs
            v = v["data"]
        out[k] = v
    return out


# --- sensor presets (replace utility.h's #ifdef dual constants) ------------

# Preset values are the reference package's (lins_tpu/config.py), where
# their sizing is explained.
VLP16 = SlamConfig(map_query_corner=512, map_query_surf=4096, s2m_cand=32)

OS1_64 = SlamConfig(
    line_num=64,
    scan_num=1024,
    ang_res_x=360.0 / 1024,
    ang_res_y=33.2 / 63,
    ang_bottom=16.6 + 0.1,
    ground_scan_ind=15,
)

HDL64 = SlamConfig(  # KITTI-style HDL-64E
    line_num=64,
    scan_num=1800,
    ang_res_x=0.2,
    ang_res_y=26.9 / 63,
    ang_bottom=24.9,
    ground_scan_ind=50,
    max_points=150000,
    map_query_corner=512,
    map_query_surf=4096,
    s2m_cand=32,
)

# Reduced-resolution sensor for fast CPU integration tests and long-horizon
# golden runs (8 rings x 450 cols keeps every pipeline stage semantically
# identical while shrinking grid work ~8x)
TINY = SlamConfig(
    line_num=8,
    scan_num=450,
    ang_res_x=0.8,
    ang_res_y=4.0,
    ang_bottom=15.1,
    ground_scan_ind=3,
    segment_valid_line_num=2,
    max_points=3600,
    max_sharp=96,
    max_less_sharp=512,
    max_flat=192,
    max_less_flat=1536,
    max_outlier=512,
    max_keyframes=128,
)

PRESETS = {"vlp16": VLP16, "os1_64": OS1_64, "hdl64": HDL64, "tiny": TINY}

"""On-card check of the PyTorch/CUDA port `lins_tpu_torch` on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device      the card's name and power limit (nvidia-smi), TF32 flags
  2. build       nvcc of every kernel source, all started together
  3. kernels     each hand-written kernel against its plain PyTorch version
                 on the card, exactly: K1 (one launch, a thread-block
                 cluster a scan, one union-find) on random graphs, edge
                 cases, cases across its piece seams (a snake, a comb, runs
                 wrapping on the pieces' first and last rows, every edge
                 on), 13x1800, TINY's 8x450, one scan, no scan, a real
                 VLP-16 chunk and one real scan, with its layout, one
                 launch a call and faster than its previous body (the
                 chunk, three timings, and one scan); K2 (one launch, a
                 thread-block cluster a scan) on random 64x1800 graphs,
                 seam and wrap cases,
                 empty and full grids at 64x1800 and 64x1024, a 64x1024
                 OS1-64 grid and a real HDL-64 chunk, with the clusters the
                 card holds at once, one launch a call (K1's and K2's in
                 one profiler session) and faster than the previous
                 two-launch design; K3 (the bucket gather, the
                 selection and the finishing ops in one launch) bit for bit
                 on random grids with lattice ties, colliding buckets,
                 tombstones, short and empty buckets, invalid queries and
                 short rows at the mapping shapes and the loop polish's;
                 K6 on the canary's
                 shapes and on rows of 1000, rows of one value, signed
                 zeros and infinities, a lattice of ties and the longest
                 rows, C from 1 to B (bit for bit against its plain
                 version, and against torch.topk's values), faster than
                 torch.topk at (6144, 1728); K4 and K5 at the odometry's
                 shapes (512 x 6144 and 192 x 2048) in both row forms and
                 weight states, on random clouds with exact ties, invalid
                 rows with NaN coordinates, empty sets, far queries,
                 references on two or five rings, on the first and last
                 rings (the +-2 window clipped), on one ring and a single
                 valid reference, and on the real trip inputs of one
                 RUNNING VLP-16 scan and one HDL-64 scan
  4. odometry    LinsSlam(VLP16, max_points=28800, use_pallas=True,
                 enable_mapping=False).run_replay over a synthetic gentle
                 sequence (6 + 2x32 scans at 1.5 m/s): label launches (and
                 K1's by scans a launch, for its lost time),
                 K4 and K5 launches (one per trip the odometry's spans
                 issued, at least one per RUNNING scan), finite poses, odometry
                 ATE <= 0.25 m, no plain labelling or association (on every
                 path);
                 in the same run, scans/s timed as bench.py times it
                 (chunks 1-3 after a warm chunk 0, synchronize fences), the
                 warm chunk's host syncs by site (PyTorch's sync debug
                 mode), peak memory
  5. mapping     window, no loop attempts: the same with the mapping
                 backend (use_pallas_select=True, loop_attempts=False) over
                 the same scans: K3 launches (>= 2 per mapping
                 step), no plain selection, fused ATE <= the odometry ATE of
                 the same scans and <= 0.25 m, SLAM scans/s, the warm
                 chunk's host syncs only at the read sites (as many as its
                 spans' `reads`), peak;
                 then K3 against its plain version on real gathers of the
                 final map, bit for bit for both d2C rules, with kernel,
                 plain and library times, both bounds and the previous
                 route's parts; the pair faster than the previous kernel;
                 then the fused voxel-grid build (grid_nn.
                 build_grid_voxelized) over the raw window points at the
                 last keyframe at the mapper's grid geometry: its voxels
                 the voxel map build's slot for slot and voxel_downsample's
                 count, the centroids of all three within 1e-4 m of the
                 float64 means; K3 through
                 gather_candidates on it (one launch, counted with K3's)
                 bit for bit against its plain version and its kept
                 distances within 1e-5 relative of the voxel map grid's;
                 K3 on a supercell grid (leaf 0.4 m, m
                 5, cap 128) and the dense corner cell (216 voxels, cap
                 224); grid_knn against top_k_nn under the 1 m gate (rtol
                 1e-3, atol 2e-3, >= 50 queries) and a CPU float64 copy;
                 build and K3 times; then the incremental window map (its
                 running sums added and subtracted in float32 since the
                 last compaction rebuild): every live slot's voxel and count
                 those of the window's points, its centroid within 1e-4 m
                 of their float64 mean
     path V      bench.py's main cell: the same with loop attempts on, over
                 the same 70 scans (no revisit, so no loop is found and no
                 attempt's alignment is issued): fused ATE <= 0.25 m, SLAM
                 scans/s, the warm chunk's host syncs only at the read
                 sites, peak, no K3 launch inside an attempt whose
                 `loop.align` was not kept
     path H      HDL-64 (64x1800, max_points=150000, use_pallas=True,
                 use_pallas_select=True, loop_time_gate=4 s) full SLAM over
                 107 scans of the synthetic revisiting circuit: K2 on every
                 chunk and streamed scan and no plain labelling, K3 in each
                 attempt that found a candidate and in no other, the warm
                 chunk's host syncs only at the read sites, at least one
                 loop with fitness < 0.3, edges =
                 keyframes - 1 + loops, fused ATE <= the JAX package's on the
                 same sequence + 0.05 m, SLAM scans/s, syncs, peak
     path R      the radius-selected map with loop closure off (run_slam.py
                 --no-loop-closure): path V's config with
                 loop_closure_enabled=False over the same scans:
                 the selection changed and the window was rebuilt at least
                 twice (each step's selection recorded on the card), no
                 loop attempt, K1, K3 and K4/K5 launches, the warm chunk's
                 host syncs only at the read sites (as many as its spans'
                 `reads`: the odometry's and the mapper's; none in the front
                 end), fused ATE <= the odometry ATE of the same
                 scans and <= 0.25 m
     path H-radius  path H with lc_map_mode="radius": the same checks as
                 path H against the JAX package's ATE over the radius map
     path E      the window path in the "exact" feature mode (the
                 reference's greedy picking): the odometry ATE of the same
                 run <= 0.25 m, fused ATE <= it and <= the JAX package's
                 exact-mode fused ATE + 0.05 m, the warm chunk's host syncs
                 only at the read sites, scans/s beside the window
                 path's
     path H-sparse  path H with max_keyframes=2048: every solve a loop
                 attempt kept is the sparse optimize_cg, one a kept
                 `loop.solve`, and no dense optimize runs; path H's gates
                 against the JAX package's ATE at 2048 slots; the store's
                 bytes
     path HS-shard  path H-sparse with slam.mapper.shard_store_over(a mesh
                 of 4 parts of the card): path H-sparse's gates, the same
                 loops, keyframes and edges, every fused pose within 1e-5 m
                 and 1e-6 of |dot| of path H-sparse's, the warm chunk's host
                 syncs only at the read sites, each cloud field in 4
                 parts of 512 rows; then
                 the seams at full width: a 2048-slot HDL-64 store filled
                 past the ring's wrap, sharded over 4 parts of the card,
                 whose assemble_local_map, rebuild_window and loop_clouds
                 across each seam and the wrap equal the unsharded ones
                 bit for bit; then the map builders' centroids within
                 1e-4 m of the float64 means of their voxels: the loop
                 submap and the current cloud of loop_clouds at path H's
                 final loop candidate, and global_map_points (the runner's
                 global map) on path H-sparse's final state
     multi-stream  parallel/replay.make_sharded_slam_replay on a one-card
                 mesh: 4 distinct VLP-16 streams (the gentle trajectory at
                 four speeds) in path V's config, 6 streamed + 32 scans
                 each, each stream's fused poses within 1e-4 m of its own
                 LinsSlam chunk in this process, host syncs only at the
                 read sites (batched and each stream's own), batched
                 scans/s beside one stream at a time, peak memory
  6. profiles    under torch.profiler, after every timing: one streamed
                 RUNNING scan and each of its stages; one mapping step and
                 each of its stages; one loop-closure attempt and one
                 pose-graph solve on path H's final state (device launches,
                 busy time, idle share, top kernels); one RUNNING scan in
                 the exact mode; one sparse solve on path H-sparse's final
                 state, then against a CPU float64 copy (1 mm, 0.001 rad);
                 then K3 against its plain version on the loop polish's
                 real gathers there; one mapping step and one loop attempt
                 on the final states of paths H-sparse and HS-shard
  7. CPU checks  the first 8 scans again on the CPU in float64: odometry
                 positions within 1 cm; with mapping (the window path and
                 path H), positions within 5 cm and per-step matches within
                 10%; path H's final state copied to the CPU in float64:
                 the profiled loop attempt (flags and matched id equal,
                 fitness within 10%, edge within 1 cm and 0.01 rad), the
                 profiled solve and LinsMapper.final_solve (keyframe
                 positions within 1 mm, rotations within 0.001 rad); path
                 R's first 8 scans as the window path's; final_solve on path
                 H-radius's state on the card (keyframes moved and finite,
                 the radius selection rebuilt); path E's first 8 scans as
                 the window path's; the exact mode's greedy picks of the
                 first 6 scans' segmented scans equal the CPU float32
                 picks of the same scans (the whole front end's differing
                 picks from the raw points counted); the edge-sharded dense
                 and sparse solves in an NCCL world of one (TCP on
                 127.0.0.1) within 1e-5 m of the one-device solves on path
                 H's final graph, and path H's final store sharded over
                 that world (its reads through all_reduce): the window
                 assembly equal bit for bit; parallel.dryrun.entry() and
                 dryrun_multichip(the card count), its four parts run
  8. runner      `python -m lins_tpu_torch.run_slam --synthetic gentle
                 --scans 40 --no-loop-closure --checkpoint-every 20
                 --map-format ply` into chiprun_out/runner, then the same
                 resumed from its ckpt_00020.npz: both exit 0 and write
                 every output, the summary has the JAX runner's keys,
                 trajectory.tum one row a scan with a pose, ATE <= 0.25 m;
                 then `--multihost` enrolled through JAX_COORDINATOR /
                 JAX_NUM_PROCESSES=1 / JAX_PROCESS_ID=0 over 20 scans: exit
                 0, the enrollment line, the summary's keys
Then one JSON line of kernel numbers, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.  Without a card, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

K_CHUNK = 32
WARMUP_SCANS = 6
N_SCANS = WARMUP_SCANS + 4 * K_CHUNK          # the gentle VLP-16 sequence
N_SCANS_WINDOW = WARMUP_SCANS + 2 * K_CHUNK   # the window path's share
ATE_LIMIT_M = 0.25
# path H: the revisiting circuit of tests/test_slam_integration.py at HDL-64
# size, and the JAX package's fused ATE on it (float32 on a CPU, its kernels
# off: PYTHONPATH=. python tests/test_torch_loop.py H)
N_SCANS_H = 107
SEQ_H = dict(kind="loop", speed=2.2, loop_scale=0.32, acc_noise=0.02,
             gyr_noise=0.002, ba=(0.05, -0.03, 0.02),
             bw=(0.002, -0.001, 0.0015))
REF_FUSED_ATE_H_M = 0.04789136468507596
ATE_MARGIN_H_M = 0.05
# path H-radius: path H over the radius-selected map (lc_map_mode="radius"),
# and the JAX package's fused ATE on it, made the same way
# (PYTHONPATH=. python tests/test_torch_loop.py HR)
REF_FUSED_ATE_HR_M = 0.0468685702843051
# path E: the window path in the "exact" feature mode, and the JAX package's
# fused ATE on it, made the same way (PYTHONPATH=. python
# tests/test_torch_loop.py E)
REF_FUSED_ATE_E_M = 0.009689267535506679
EXACT_LABEL_SCANS = 6
# when the whole front end runs from the raw points on the card and on the
# CPU, the labels may differ only where the projection's float32 ranges
# differ, and in at most this share of the CPU's picks (6 of 1,715 measured
# on an NVIDIA H100 80GB HBM3, 700.00 W; about 3x headroom)
EXACT_E2E_MAX_SHARE = 0.01
# path H-sparse: path H with max_keyframes=2048, where every solve is the
# sparse one (optimize_cg), and the JAX package's fused ATE on it, made the
# same way (PYTHONPATH=. python tests/test_torch_loop.py HS)
REF_FUSED_ATE_HS_M = 0.04789136468507596
# path HS-shard: path H-sparse with its keyframe store split along the
# keyframe axis over 4 parts of the one card (a 4-card mesh's code path,
# apart from the peer copies), against path H-sparse in the same call at
# the reference's own tolerances (tests/test_parallel.py:281-285)
STORE_SHARDS = 4
SHARD_POS_TOL_M = 1e-5
SHARD_QUAT_TOL = 1e-6
# the seam check: a 2048-slot store at HDL-64 caps filled directly as if
# 2100 keyframes had been added, so its windows cross the three seams of 4
# shards of 512 slots and the ring's wrap; the windows end at these ids
SEAM_COUNT = 2100
SEAM_CENTERS = (530, 1040, 1560, 2060, 2099)
# the edge-sharded solves on a one-card NCCL world against the one-device
# solves on the same card
DIST_TOL_M = 1e-5
# the multi-stream replay: path V's config over B distinct streams (the
# gentle trajectory at four speeds), 6 streamed + one 32-scan chunk each,
# against each stream's own LinsSlam chunk in the same process
STREAM_SPEEDS = (1.2, 1.5, 1.8, 2.1)
STREAM_TOL_M = 1e-4
# the fused voxel-grid build on the window path's final map: the centroids
# of every map builder (all sum their runs in float64) against the float64
# means of their voxels, K3's kept distances on it against the voxel map
# grid's; grid_knn against brute force under the 1 m gate at the
# reference's limits (tests/test_mapping.py:84-86) on at least
# KNN_MIN_GATED queries, and the card's float32 against a CPU float64 copy.
# GRID_CENT_TOL_M also holds the incremental window map, the loop clouds
# and the global map
GRID_CENT_TOL_M = 1e-4
GRID_D2_RTOL = 1e-5
KNN_RTOL, KNN_ATOL, KNN_MIN_GATED = 1e-3, 2e-3, 50
KNN_CPU_RTOL, KNN_CPU_ATOL = 1e-5, 1e-5
# the runner enrolled through the reference's variables in a world of one
MULTIHOST_SCANS = 20
# the runner on the card: a radius run of the gentle sequence with a
# checkpoint every RUNNER_CKPT scans, then a run resumed from the first
RUNNER_SCANS = 40
RUNNER_CKPT = 20
RUNNER_TIMEOUT_S = 400
RUNNER_OUTPUTS = {"trajectory.tum", "trajectory_kf.tum", "metrics.jsonl",
                  "global_map.ply", "final_state.npz", "summary.json",
                  "spans.jsonl"}
# the keys of the JAX package's runner's summary.json with mapping, a
# ground truth and the state dump (run_slam.py:268-321)
RUNNER_SUMMARY_KEYS = {"scans", "elapsed_s", "compile_s", "scans_per_sec",
                       "keyframes", "loops", "loops_applied",
                       "state_save_s", "ate_rmse_m", "rpe_m", "ate_kf_m"}
CPU_CHECK_SCANS = 8
CPU_CHECK_LIMIT_M = 0.01
# mapping, card float32 vs CPU float64: the reference's own cross-backend
# gates (tools/selfcheck.py POS_TOL_M, N_MATCH_TOL), calibrated there on a
# benign floor of 1.0-1.5 cm and up to 3.7% of matches, which comes from
# float32 reassociation in the map build feeding tie-sensitive 5-NN
# selection
MAP_CPU_POS_TOL_M = 0.05
MAP_CPU_MATCH_TOL = 0.10
# path H's final state, card float32 vs a CPU float64 copy: one loop
# attempt (its edge, correction and fitness) and the pose-graph solve
LOOP_CPU_TOL_M = 0.01
LOOP_CPU_TOL_RAD = 0.01
LOOP_FIT_TOL = 0.10
SOLVE_CPU_TOL_M = 1e-3
SOLVE_CPU_TOL_RAD = 1e-3
# K4/K5, card vs plain: counts equal; each entry (a, b) of the 8x8 Gram
# G of the rows [J6 | r] (JtJ, Jtr, sum r^2) within K45_TOL of its own
# scale sqrt(G_aa * G_bb), by Cauchy-Schwarz a bound of that entry's sum of
# |terms|: each of two float32 sums of up to 512 rows, in different orders,
# errs by at most about 512 * 2^-24 of it
K45_TOL = 2 * 512 * 2.0 ** -24
# the previous designs' times, logged beside this run's and gates where
# named so (milliseconds by CUDA events on an NVIDIA H100 80GB HBM3 at
# 700.00 W): the association kernel of one warp a query over the padded
# reference set, the K4+K5 pair on the real VLP-16 trip, and K6 of one
# block a row taking C minima in turn at (6144, 1728), C = 64, both with
# the calls enqueued while the card slept (gates); K3 of one block a row
# over the gathered block, per corner + surf pair of the window map's
# final gathers (gate), and its whole wrapper with the finishing ops; K2
# of two launches, per 32-scan HDL-64 chunk (gate); K1 of one block a scan
# (hook + jump rounds), per 32-scan VLP-16 chunk (gate) and on one real
# scan (with the card asleep while the host enqueues)
PREVIOUS_MS = {"K4+K5 pair": 0.04998, "K6": 0.36348, "K3 pair": 0.1957,
               "K3 wrapper pair": 0.3433, "K2": 0.3206, "K1": 0.0716,
               "K1 scan": 0.0544}
# the previous K3 route on the card, part by part, per gather (ms; the
# bucket ids alone were paced by the host's enqueue and are left out): the
# duplicate mask, cells[bb], cnt[bb] and ok; the kernel; the finishing ops
# (the same card and power limit)
PREVIOUS_K3_PARTS_MS = {
    "surf": {"mask + gather": 0.0981, "kernel": 0.1556, "finish": 0.0203},
    "corner": {"mask + gather": 0.0652, "kernel": 0.0382, "finish": 0.0188},
    "polish surf": {"mask + gather": 0.1922, "kernel": 0.1845,
                    "finish": 0.0204}}
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, and the float32
# rate outside the tensor cores, used for the kernels' scalar operations
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


_T0 = time.perf_counter()


def log(msg):
    """Print a line; a phase's heading carries the script's elapsed time."""
    if msg.startswith("=="):
        msg = f"{msg} [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")
    log(f"  ok: {msg}")


def cuda_ms(fn, reps):
    """Mean milliseconds of `fn()` on the card, by CUDA events over `reps`
    calls after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, sleep_cycles=int(2e8)):
    """Mean milliseconds of `fn()` on the card over `reps` calls enqueued
    while the card sleeps (torch.cuda._sleep), so that the calls run back
    to back and the host's enqueue rate is not what is timed; fails when
    the enqueue outlasted the sleep (a call that waits for the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    s0, s1, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s0.record()
    torch.cuda._sleep(sleep_cycles)
    s1.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    e1.record()
    torch.cuda.synchronize()
    sleep_ms = s0.elapsed_time(s1)
    check(host_ms < sleep_ms, f"{reps} calls enqueued in {host_ms:.1f} ms, "
          f"inside the card's {sleep_ms:.1f} ms sleep")
    return s1.elapsed_time(e1) / reps


def bound(bytes_moved, ops):
    """(least milliseconds, what bounds it) at the card's published
    peaks."""
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def profile_call(fn):
    """Device activity of one call of `fn`, by torch.profiler: the kernels
    and copies it ran on the card, the card's busy time (the union of their
    intervals), the host's wall time under the profiler, and the five
    kernels with the most device time.  Returns (that dict, fn's result)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    by_name = collections.Counter()
    for s, e, name in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
        by_name[name[:50]] += e - s
    return dict(launches=len(spans), busy_ms=busy_us / 1e3, wall_ms=wall_ms,
                top=by_name.most_common(5)), out


def log_profile(what, prof):
    if not prof["launches"]:
        log(f"  {what}: the profiler recorded no device activity; not "
            f"measured")
        return
    log(f"  {what} under the profiler: {prof['launches']} device launches, "
        f"card busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms "
        f"wall (idle share {1 - prof['busy_ms'] / prof['wall_ms']:.4f})")
    for name, us in prof["top"]:
        log(f"    {us / 1e3:9.3f} ms  {name}")


def log_stages(title, rows):
    log(f"  {title}, each alone under the profiler:")
    for name, p in rows:
        log(f"    {name:34s} {p['launches']:6d} launches, card busy "
            f"{p['busy_ms']:8.3f} ms, wall {p['wall_ms']:9.3f} ms")


def stage_breakdown(odo, xyz, n_points):
    """Device launches and busy time of each stage of one RUNNING scan,
    each stage profiled alone on the odometry's current state (nothing is
    written back to it), with a level 400 Hz IMU batch."""
    import torch

    from lins_tpu_torch.frontend.pipeline import frontend_post, frontend_pre
    from lins_tpu_torch.imu import eskf
    from lins_tpu_torch.odometry import gn_icp, ieskf
    from lins_tpu_torch.odometry.estimator import running_step_impl
    from lins_tpu_torch.ops import assoc
    from lins_tpu_torch.ops.label import label_components

    cfg, dev, dt = odo.cfg, odo.device, odo.dtype
    M = cfg.max_imu_per_scan
    acc = torch.zeros((M, 3), dtype=dt, device=dev)
    acc[:, 2] = cfg.gravity
    imu = (torch.full((M,), 0.0025, dtype=dt, device=dev), acc,
           torch.zeros((M, 3), dtype=dt, device=dev),
           torch.arange(M, device=dev) < 40)
    xyz_t, n_t = odo._scan_tensors(xyz, n_points)
    fs, gs = odo.filter_state, odo.global_state
    ls, lc = odo.last_surf, odo.last_corner
    rows = []

    def stage(name, fn):
        prof, out = profile_call(fn)
        rows.append((name, prof))
        return out

    pre = stage("frontend_pre", lambda: frontend_pre(xyz_t, n_t, cfg))
    labels = stage("K1 label, one scan", lambda: label_components(
        pre["e_right"], pre["e_down"], pre["eligible"]))
    _, feats = stage("frontend_post", lambda: frontend_post(labels, pre, cfg))
    prop = stage("IMU propagate", lambda: eskf.propagate(fs, *imu, cfg))
    flat, sharp = assoc.queries(feats.flat, dt), assoc.queries(feats.sharp,
                                                               dt)
    refs = stage("pack the reference sets", lambda: assoc.reference_sets(
        ls, lc, dt))
    stage("K4 + K5, one IESKF trip", lambda: assoc.scan_normal_equations(
        flat, sharp, *refs, prop.rn, prop.qbn, 1, cfg, "ieskf"))
    stage("ieskf.update, to its stop", lambda: ieskf.update(
        prop, feats.flat, feats.sharp, ls, lc, cfg))
    stage("GN fallback, to its stop",
          lambda: gn_icp.estimate_transform(prop.rn, prop.qbn, feats.flat,
                                            feats.sharp, ls, lc, cfg))
    stage("running step, whole", lambda: running_step_impl(
        fs, gs, feats, ls, lc, *imu, cfg))
    log_stages("stages of one RUNNING scan", rows)


def _mapping_inputs(slam):
    """The final mapper state of a mapping run and the last chunked scan's
    odometry pose and clouds, as one more mapping step would take them."""
    import torch

    mapper = slam.mapper
    rns, qbns = slam.odometry.last_chunk_poses
    clouds = slam.odometry.last_chunk_clouds
    dt, dev = mapper.dtype, mapper.device
    args = (rns[-1].to(dt), qbns[-1].to(dt),
            torch.full((), float(slam.trajectory[-1][0]), dtype=dt,
                       device=dev),
            clouds["cxyz"][-1], clouds["cval"][-1], clouds["sxyz"][-1],
            clouds["sval"][-1], clouds["oxyz"][-1], clouds["oval"][-1],
            torch.full((2,), math.nan, dtype=dt, device=dev))
    return mapper, args


def mapping_stage_breakdown(slam):
    """Device launches and busy time of one mapping step on the final map
    of the mapping run and of each of its stages, each profiled alone
    (nothing is written back to the mapper)."""
    import torch

    from lins_tpu_torch.geom import so3
    from lins_tpu_torch.mapping import local_map as lmn
    from lins_tpu_torch.mapping.mapper import (_mapping_step_impl,
                                               downsample_scan)
    from lins_tpu_torch.mapping.scan2map import (
        _gn_normal_eqs, corner_residuals, scan_to_map_grids, surf_residuals)
    from lins_tpu_torch.ops.grid_nn import (gather_candidates,
                                            knn_from_candidates)

    mapper, args = _mapping_inputs(slam)
    cfg, st, gp = mapper.cfg, mapper.state, mapper.gp
    lm = st.lmap
    C = cfg.s2m_cand
    rows = []

    def stage(name, fn):
        prof, out = profile_call(fn)
        rows.append((name, prof))
        return out

    prof, _ = profile_call(lambda: _mapping_step_impl(
        st, *args, cfg, *mapper.caps, mapper.n_window, gp, True))
    log_profile("one mapping step", prof)
    sc = stage("downsample the scan", lambda: downsample_scan(
        *args[3:9], cfg, *mapper.caps, mapper.dtype))
    t, q = st.aft_pos, st.aft_quat
    pc = so3.quat_rotate(q[None], sc.query_corner) + t
    ps = so3.quat_rotate(q[None], sc.query_surf) + t

    def gathers():
        return (gather_candidates(pc, sc.query_corner_ok, lm.corner_grid, C,
                                  cfg.use_pallas_select),
                gather_candidates(ps, sc.query_surf_ok, lm.surf_grid, C,
                                  cfg.use_pallas_select))

    (cc, cc_ok, _, _), (scn, sc_ok, _, _) = stage(
        "gather + K3, corner and surf", gathers)
    valid = torch.cat([sc.query_corner_ok, sc.query_surf_ok])
    nn, d2 = stage("re-rank (5-NN of the caches)", lambda: knn_from_candidates(
        torch.cat([pc, ps]), valid, torch.cat([cc, scn]),
        torch.cat([cc_ok, sc_ok])))
    Qc = pc.shape[0]

    def residuals():
        c = corner_residuals(pc, nn[:Qc], d2[:Qc], sc.query_corner_ok)
        s = surf_residuals(ps, nn[Qc:], d2[Qc:], sc.query_surf_ok)
        return (_gn_normal_eqs(sc.query_corner, *c, q),
                _gn_normal_eqs(sc.query_surf, *s, q))

    stage("residuals + normal equations", residuals)
    stage(f"scan-to-map, {cfg.scan2map_iters} trips",
          lambda: scan_to_map_grids(t, q, sc.query_corner,
                                    sc.query_corner_ok, sc.query_surf,
                                    sc.query_surf_ok, lm.corner_grid,
                                    lm.surf_grid, lm.n_corner, lm.n_surf,
                                    cfg))
    stage("keyframe push (window map)", lambda: lmn.push_keyframe(
        lm, st.store.count, t, q, *sc[:6], gp))
    stage("rebuild of the window map", lambda: lmn.rebuild_window(
        lm, st.store, *lmn.recent_window_ids(st.store, mapper.n_window),
        gp))
    log_stages("stages of one mapping step", rows)


@contextlib.contextmanager
def count_host_syncs():
    """Count the host synchronisations PyTorch reports in its sync debug
    mode, by the innermost call site in lins_tpu_torch."""
    import torch

    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "lins_tpu_torch" in f.filename]
        sites[(f"{frames[-1].filename.split('lins_tpu_torch')[-1]}:"
               f"{frames[-1].lineno}") if frames else "outside the port"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")


# the sites of the port's host reads in `count_host_syncs`' form: the
# odometry's (its loops' stops, the fallback's flag) and the mapper's (its
# branches' predicates through tree.cond, its loops' stops through
# device.may_stop)
READ_SITES = ("/odometry/ieskf.py:", "/odometry/gn_icp.py:",
              "/odometry/estimator.py:", "/mapping/mapper.py:",
              "/mapping/scan2map.py:", "/graph/loop_closure.py:",
              "/utils/tree.py:", "/utils/device.py:")


@contextlib.contextmanager
def record_spans():
    """The port's spans recorded inside the block in a recorder of its own
    (utils/metrics.RECORDER swapped), as the list yielded, filled with
    their attributes read once the block has ended."""
    from lins_tpu_torch.utils import metrics

    rec = metrics.SpanRecorder(capacity=1 << 20)
    saved, metrics.RECORDER = metrics.RECORDER, rec
    spans = []
    try:
        yield spans
    finally:
        metrics.RECORDER = saved
    check(rec.dropped == 0, "no span dropped")
    spans.extend(rec.spans())


def check_reads(sites, spans, what):
    """The host syncs of `what` (`count_host_syncs`' sites): every one at
    the port's read sites, as many as the `reads` of all its spans (the
    odometry's and the mapper's); the front end makes none."""
    reads = sum(s["attrs"].get("reads", 0) for s in spans)
    mapper = sum(s["attrs"].get("reads", 0) for s in spans
                 if s["name"].startswith(("mapper.", "loop.")))
    syncs = sum(sites.values())
    elsewhere = {site: n for site, n in sites.items()
                 if not site.startswith(READ_SITES)}
    check(not elsewhere and syncs == reads,
          f"{what}: {syncs} host syncs, all at the read sites, as many as "
          f"its spans' {reads} reads ({mapper} the mapper's)"
          + (f"; elsewhere {elsewhere}" if elsewhere else ""))


def odometry_trips(spans):
    """The trips the odometry's IESKF and GN spans issued."""
    return sum(s["attrs"]["trips"] for s in spans
               if s["name"] in ("odometry.ieskf", "odometry.gn_icp"))


def phase_device():
    import torch

    log("== 1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from lins_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    log(f"  card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 off")
    return smi


def phase_build():
    from lins_tpu_torch.ops import build

    log("== 2. build")
    t0 = time.perf_counter()
    outs = build.build_all(verbose=True, force=True)
    log(f"  built {sorted(outs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in outs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")


def _random_graph(rng, shape, masked):
    """Edge masks of a random grid graph; `masked` keeps edges only between
    eligible cells, as the front end produces them."""
    el = rng.random(shape) < 0.7
    er = rng.random(shape) < 0.55
    ed = rng.random(shape) < 0.55
    if masked:
        er &= el & np.roll(el, -1, axis=-1)
        down_ok = np.zeros_like(el)
        down_ok[..., :-1, :] = el[..., 1:, :]
        ed &= el & down_ok
    return er, ed, el


def _edge_cases():
    """The wrap-seam, vertical-chain and zigzag cases of
    tests/test_pallas_label.py, as (name, e_right, e_down, eligible)."""
    cases = []
    L, S = 4, 64
    el = np.zeros((L, S), bool)
    el[1, :10] = el[1, -10:] = True
    er = np.zeros((L, S), bool)
    for j in list(range(0, 9)) + list(range(S - 10, S - 1)) + [S - 1]:
        er[1, j] = True
    cases.append(("wrap_seam", er, np.zeros((L, S), bool), el))
    L, S = 8, 32
    el = np.zeros((L, S), bool)
    el[:, 5] = True
    ed = np.zeros((L, S), bool)
    ed[:-1, 5] = True
    cases.append(("vertical_chain", np.zeros((L, S), bool), ed, el))
    L, S = 6, 16
    el, er, ed = (np.zeros((L, S), bool) for _ in range(3))
    for r in range(L):
        el[r, 2:14] = True
        er[r, 2:13] = True
        if r + 1 < L:
            ed[r, 13 if r % 2 == 0 else 2] = True
    cases.append(("zigzag", er, ed, el))
    return cases


def _k1_seam_cases(S):
    """Cases aimed at K1's piece seams, each (name, e_right, e_down,
    eligible) at 16 x S: a snake of vertical runs through all 16 rows at
    every other column, joined alternately in the last and the first row; a
    comb whose teeth (every third column) join only in the last row; runs
    that wrap from column S-1 to 0 on the first and last rows of K1's
    pieces (of 2 or 4 rows), those of rows 3 and 4 joined down across a
    seam; and every
    cell eligible with every edge on (the last row's e_down included, which
    the contract ignores)."""
    L = 16
    z = np.zeros((L, S), bool)
    cases = []
    el, er, ed = z.copy(), z.copy(), z.copy()
    cols = range(0, S - 1, 2)
    for k, c in enumerate(cols):
        el[:, c] = True
        ed[:-1, c] = True
        if c + 2 < S - 1:
            row = L - 1 if k % 2 == 0 else 0
            el[row, c:c + 3] = True
            er[row, c:c + 2] = True
    cases.append(("snake", er, ed, el))
    el, er, ed = z.copy(), z.copy(), z.copy()
    el[:, ::3] = True
    ed[:-1, ::3] = True
    el[L - 1] = er[L - 1] = True
    cases.append(("comb", er, ed, el))
    el, er, ed = z.copy(), z.copy(), z.copy()
    for r in (0, 3, 4, 7, 8, 11, 12, 15):
        el[r, :3] = el[r, -3:] = True
        er[r, :2] = er[r, -3:] = True
    ed[3, 1] = True
    cases.append(("wrap_on_piece_rows", er, ed, el))
    full = np.ones((L, S), bool)
    cases.append(("all_on", full, full.copy(), full.copy()))
    return cases


def phase_k1(cfg, data):
    """K1 against its plain version on the card; returns its JSON entry
    (launches filled in by the main-path runs) and its time on one real
    scan."""
    import torch

    from lins_tpu_torch.odometry.estimator import scan_pre_vmap
    from lins_tpu_torch.ops import label

    log("== 3. kernels: K1 label_components")
    dev = torch.device("cuda")
    for K, L, S in ((K_CHUNK, 16, 1800), (1, 16, 1800), (K_CHUNK, 13, 1800),
                    (K_CHUNK, 8, 450)):
        lay = label.k1_layout(K, L, S)
        log(f"  K1 on {K} scans of {L}x{S}: {lay['pieces']} blocks of "
            f"{lay['rows']} rows a scan, {lay['threads']} threads and "
            f"{lay['smem']} B of shared memory a block; the card holds "
            f"{lay['clusters']} such clusters at once")
    cases = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        cases.append((f"random_masked_seed{seed}",
                       *_random_graph(rng, (K_CHUNK, 16, 1800), True)))
    cases.append(("random_unmasked_seed3",
                  *_random_graph(np.random.default_rng(3),
                                 (K_CHUNK, 16, 1800), False)))
    cases += _edge_cases()
    cases += _k1_seam_cases(1800)
    # rows that 8 pieces do not divide, TINY's 8 x 450 (S not a multiple of
    # 4: byte loads), one scan and none
    for name, shape in (("random_13_rows", (K_CHUNK, 13, 1800)),
                        ("random_tiny", (K_CHUNK, 8, 450)),
                        ("random_one_scan", (1, 16, 1800)),
                        ("no_scan", (0, 16, 1800))):
        cases.append((name, *_random_graph(np.random.default_rng(5), shape,
                                           True)))
    cases = [(name, *(torch.as_tensor(a, device=dev) for a in arrs))
             for name, *arrs in cases]
    # a real chunk of the main path: scans 2..33 through frontend_pre
    xyz_k = torch.as_tensor(data["scans_xyz"][2:2 + K_CHUNK], device=dev)
    n_k = torch.as_tensor(data["scans_n"][2:2 + K_CHUNK].astype(np.int32),
                          device=dev)
    pre_k = scan_pre_vmap(xyz_k, n_k, cfg)
    real = (pre_k["e_right"], pre_k["e_down"], pre_k["eligible"])
    scan = tuple(t[0] for t in real)
    cases += [("real_chunk", *real), ("real_scan", *scan)]

    max_err = 0
    for name, er, ed, el in cases:
        before = label.label_components.launches
        got = label.label_components(er, ed, el)
        torch.cuda.synchronize()
        n_scans = el.shape[0] if el.dim() == 3 else 1
        check(label.label_components.launches == before + (n_scans > 0),
              f"one K1 launch for {name}")
        want = label.label_components_plain(er, ed, el)
        if want.numel():
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"K1 == plain on {name} {tuple(el.shape)} "
              f"({int(el.sum())} eligible cells, "
              f"{int(torch.unique(want[el.bool()]).numel())} components)")

    # three timings of the chunk, so that the noise shows beside the
    # previous body's, and one of a single scan; each with the card asleep
    # while the host enqueues, as the kernel is shorter than its enqueue
    runs = sorted(device_ms(lambda: label.label_components(*real), 50)
                  for _ in range(3))
    ms = runs[1]
    scan_ms = device_ms(lambda: label.label_components(*scan), 50)
    plain_ms = cuda_ms(lambda: label.label_components_plain(*real), 3)
    K, L, S = real[2].shape
    cells = K * L * S
    # each input byte read once, each int32 label written once; at least
    # one min per cell and edge direction
    bytes_moved = 3 * cells + 4 * cells
    bound_ms, bound_by = bound(bytes_moved, 4 * cells)
    scan_bound_ms, _ = bound(bytes_moved // K, 4 * cells // K)
    log(f"  K1 label_components ({K},{L},{S}): kernel {ms:.4f} ms (three "
        f"timings {', '.join(f'{t:.4f}' for t in runs)}; the previous "
        f"body, one block a scan, {PREVIOUS_MS['K1']:.4f}), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bytes_moved} B)")
    log(f"  K1 on one real scan (1,{L},{S}): kernel {scan_ms:.4f} ms (the "
        f"previous body {PREVIOUS_MS['K1 scan']:.4f}), bound "
        f"{scan_bound_ms:.6f} ms")
    check(ms < PREVIOUS_MS["K1"], f"K1 on the real chunk faster than the "
          f"previous body: {ms:.4f} < {PREVIOUS_MS['K1']:.4f} ms")
    return dict(name="label_components", route="cuda",
                source="lins_tpu_torch/csrc/label_components.cu",
                replaces="lins_tpu/ops/pallas_label.py:118",
                launches=None, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None), dict(ms=scan_ms, bound_ms=scan_bound_ms,
                                       real=real)


def _k2_edge_cases(S):
    """Tall-grid cases of K2's seam merge, each (name, e_right, e_down,
    eligible) at 64 x S."""
    L = 64
    z = np.zeros((L, S), bool)
    cases = []
    el, ed = z.copy(), z.copy()
    el[:, 5] = True
    ed[:-1, 5] = True
    cases.append(("column_through_all_seams", z.copy(), ed, el))
    el, er, ed = z.copy(), z.copy(), z.copy()
    el[15, :4] = el[15, -4:] = True
    er[15, -4:] = er[15, :3] = True          # S-4 .. S-1 -> 0, wrapping
    el[16:40, S - 4] = True                  # down across two row seams
    ed[15:39, S - 4] = True
    cases.append(("wrap_and_row_seams", er, ed, el))
    cases.append(("empty", z.copy(), z.copy(), z.copy()))
    full = np.ones((L, S), bool)
    ed_full = full.copy()
    ed_full[-1] = False
    cases.append(("all_eligible", full, ed_full, full.copy()))
    return cases


def phase_k2(cfg_h, data_h, smi, k1_real):
    """K2 against its plain version on the card; returns its JSON entry
    (launches filled in by path H).  Also checks that one K1 call (on
    `k1_real`, the real VLP-16 chunk) and one K2 call are one device launch
    each, in one profiler session: in later sessions of a process the
    profiler has recorded no launch of these kernels."""
    import torch

    from lins_tpu_torch.odometry.estimator import scan_pre_vmap
    from lins_tpu_torch.ops import label

    log("== 3. kernels: K2 (label_components on 64-row grids)")
    dev = torch.device("cuda")
    check(label.route(64, 1800) == "K2" and label.route(64, 1024) == "K2",
          "64x1800 and 64x1024 grids route to K2")
    for S in (1800, 1024):
        for rows in (16, 8):
            log(f"  K2 at 64x{S} in {64 // rows} blocks of {rows} rows: the "
                f"card holds {label.resident_clusters(64, S, rows)} clusters "
                f"at once" + (" (the blocks the wrapper takes)"
                              if rows == label.piece_rows(64) else ""))
    cases = []
    for seed in range(3):
        cases.append((f"random_masked_seed{seed}", *_random_graph(
            np.random.default_rng(seed), (K_CHUNK, 64, 1800), True)))
    cases.append(("random_unmasked_seed3", *_random_graph(
        np.random.default_rng(3), (K_CHUNK, 64, 1800), False)))
    cases.append(("os1_64_random_seed4", *_random_graph(
        np.random.default_rng(4), (K_CHUNK, 64, 1024), True)))
    cases += _k2_edge_cases(1800)
    cases += [(f"{name} at 64x1024", *arrs)
              for name, *arrs in _k2_edge_cases(1024)]
    cases = [(name, *(torch.as_tensor(a, device=dev) for a in arrs))
             for name, *arrs in cases]
    # a real chunk of path H: scans 2..33 through frontend_pre
    xyz_k = torch.as_tensor(data_h["scans_xyz"][2:2 + K_CHUNK], device=dev)
    n_k = torch.as_tensor(data_h["scans_n"][2:2 + K_CHUNK].astype(np.int32),
                          device=dev)
    pre_k = scan_pre_vmap(xyz_k, n_k, cfg_h)
    real = (pre_k["e_right"], pre_k["e_down"], pre_k["eligible"])
    cases.append(("real_hdl64_chunk", *real))

    max_err = 0
    for name, er, ed, el in cases:
        before = label._label_blocked.launches
        got = label.label_components(er, ed, el)
        torch.cuda.synchronize()
        check(label._label_blocked.launches == before + 1,
              f"label_components took K2 for {name}")
        want = label.label_blocked_plain(er, ed, el)
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"K2 == plain on {name} {tuple(el.shape)} "
              f"({int(el.sum())} eligible cells, "
              f"{int(torch.unique(want[el.bool()]).numel())} components)")
    # the blocked plain version against the unblocked one (the exact
    # fixpoint of label_from_edges) on the real chunk
    check(torch.equal(label.label_blocked_plain(*real),
                      label.label_components_plain(*real)),
          "plain K2 == plain K1 on the real HDL-64 chunk")

    prof, _ = profile_call(lambda: (label.label_components(*k1_real),
                                    label.label_components(*real)))
    names = [name for name, _ in prof["top"]]
    check(prof["launches"] == 2
          and sum("label_union_find" in n for n in names) == 1
          and sum("label_cluster" in n for n in names) == 1,
          f"one K1 call and one K2 call are {prof['launches']} device "
          f"launches, one of each kernel, on the real chunks: {prof['top']}")
    ms = cuda_ms(lambda: label.label_components(*real), 50)
    plain_ms = cuda_ms(lambda: label.label_blocked_plain(*real), 3)
    K, L, S = real[2].shape
    cells = K * L * S
    # each input byte read once, each int32 label written once; at least
    # one min per cell and edge direction
    bytes_moved = 3 * cells + 4 * cells
    bound_ms, bound_by = bound(bytes_moved, 4 * cells)
    log(f"  K2 label_components ({K},{L},{S}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bytes_moved} B)")
    check(ms < PREVIOUS_MS["K2"], f"K2 on the real HDL-64 chunk faster than "
          f"the previous two-launch design: {ms:.4f} < {PREVIOUS_MS['K2']:.4f}"
          f" ms a chunk on {smi}")
    return dict(name="label_blocked", route="cuda",
                source="lins_tpu_torch/csrc/label_blocked.cu",
                replaces="lins_tpu/ops/pallas_label.py:135",
                launches=None, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _select_grid(seed, Q, nb, cap, table, lattice=False, ties=False):
    """A random map grid (table, 3, cap) with its counts, and Q query rows
    of nb bucket ids, on the card, with the mapping path's edge cases:
    duplicate points (exact ties; with `lattice` every coordinate on a
    0.25 m lattice, so many more; with `ties` half the buckets one point in
    every slot, more ties at one distance than K3 sorts at once); two
    neighbour cells of a row hashed to one bucket; tombstones at the voxel
    map's SENTINEL among the counted slots; counts below cap and empty
    buckets; rows with fewer than C+1 candidates; an all-invalid row (only
    empty buckets); invalid queries.  Returns (query, q_valid, bb, cells,
    cnt), the arguments of select_candidates before C."""
    import torch

    from lins_tpu_torch.ops.voxel_map import SENTINEL

    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (Q, 3))
    cells = rng.uniform(-2.5, 2.5, (table, 3, cap))
    if lattice:
        q, cells = np.round(q * 4) / 4, np.round(cells * 4) / 4
    cells[:, :, 3] = cells[:, :, 2]
    cnt = rng.integers(0, cap + 1, table)
    cnt[::7] = cap
    cnt[1::11] = 0
    if ties:
        half = (np.arange(table) % 2 == 0) & (cnt > 0)
        cells[half] = cells[half][:, :, :1]
        cnt[half] = cap
    cells.transpose(0, 2, 1)[rng.random((table, cap)) < 0.05] = SENTINEL
    bb = rng.integers(0, table, (Q, nb))
    bb[::3, 1] = bb[::3, 0]
    short = bb[1:9]
    short[:] = rng.choice(np.flatnonzero(cnt <= 1), short.shape)
    bb[0] = np.flatnonzero(cnt == 0)[0]
    qv = rng.random(Q) < 0.9
    qv[9 % Q] = False
    dev = torch.device("cuda")
    return (torch.as_tensor(q.astype(np.float32), device=dev),
            torch.as_tensor(qv, device=dev),
            torch.as_tensor(bb.astype(np.int32), device=dev),
            torch.as_tensor(cells.astype(np.float32), device=dev),
            torch.as_tensor(cnt.astype(np.int32), device=dev))


def _k3_equal(args, C, what):
    """K3 vs its plain version on the same card tensors, bit for bit, for
    both d2C rules, one launch a call; returns the largest difference of
    kept distances."""
    import torch

    from lins_tpu_torch.ops import select

    err = 0.0
    for first_dropped in (True, False):
        before = select.select_candidates.launches
        got = select.select_candidates(*args, C, first_dropped=first_dropped)
        torch.cuda.synchronize()
        want = select.select_candidates_plain(*args, C,
                                              first_dropped=first_dropped)
        names = ("cand", "cand_ok", "d2k", "d2C")
        same = [torch.equal(g, w) if g.dtype == torch.bool else
                torch.equal(g.view(torch.int32), w.view(torch.int32))
                for g, w in zip(got, want)]
        fin = torch.isfinite(want[2])
        if fin.any():
            err = max(err, float((got[2][fin] - want[2][fin]).abs().max()))
        check(all(same) and select.select_candidates.launches == before + 1,
              f"K3 == plain bit for bit on {what} (first_dropped="
              f"{first_dropped}; {int(want[1].sum())} kept): "
              + ", ".join(f"{n} {'equal' if s else 'DIFFER'}"
                          for n, s in zip(names, same)))
    return err


def phase_k3_synthetic(C):
    log("== 3. kernels: K3 select_candidates (gather, selection, finish)")
    err = 0.0
    for seed, (Q, nb, cap, table), kind in (
            (0, (4096, 8, 216, 16384), ""), (1, (512, 27, 216, 8192), ""),
            (2, (4096, 8, 216, 16384), "lattice"),
            (3, (512, 27, 216, 8192), "lattice"), (4, (37, 3, 11, 40), ""),
            (5, (8192, 27, 64, 8192), ""),
            (6, (8192, 27, 64, 8192), "lattice"), (7, (8, 27, 64, 8192), ""),
            (8, (512, 8, 216, 64), "ties"), (9, (512, 27, 64, 64), "ties")):
        args = _select_grid(seed, Q, nb, cap, table, lattice=kind == "lattice",
                            ties=kind == "ties")
        err = max(err, _k3_equal(args, C, f"a random grid, {Q} rows of {nb} "
                                 f"buckets of {cap} slots (table {table})"
                                 + (f", {kind}" if kind else "")))
    return err


def k3_times(args, C, what, previous):
    """Times of K3 at one real gather, the previous route's parts beside
    them, and both bounds.  The kernel is timed with its calls enqueued
    while the card sleeps, and also as the host paces it; the plain version
    and the library yardstick (cells[bb], the masks, masked distances,
    torch.topk, three gathers and the finishing ops, all PyTorch calls) on
    the same inputs."""
    import torch

    from lins_tpu_torch.ops import select

    query, q_valid, bb, cells, cnt = args
    Q, nb = bb.shape
    cap = cells.shape[2]
    B, R = nb * cap, C + 1

    def kernel():
        return select.select_candidates(*args, C)

    def library():
        cand, ok = select.gather_block(bb, cells, cnt)
        d2 = select.masked_d2(query, q_valid, cand, ok)
        d, i = torch.topk(d2, R, dim=1, largest=False)
        planes = cand.transpose(1, 2).reshape(Q, 3, B)
        xyz = torch.stack([torch.gather(planes[:, k], 1, i)
                           for k in range(3)], dim=-1)
        return select._finish(query, d, xyz, C, True)

    ms, paced_ms = device_ms(kernel, 50), cuda_ms(kernel, 50)
    plain_ms = cuda_ms(lambda: select.select_candidates_plain(*args, C), 5)
    library_ms = device_ms(library, 10)
    # the fused function: each query, flag and bucket id read once, each
    # output written once, and of each distinct bucket a valid row reaches
    # its count and its counted slots' coordinates, min(cnt, cap) x 12 B
    # (the kernel reads no slot at or above a count and no bucket of an
    # invalid row); 8 operations a distance of every slot the rows take
    _, ok = select.gather_block(bb, cells, cnt)
    slots = int((ok & q_valid[:, None, None]).sum())
    reached = torch.unique(bb[q_valid].long())
    n_buckets = int(reached.numel())
    bucket_bytes = int((cnt[reached].clamp(0, cap).long() * 12 + 4).sum())
    bytes_moved = (Q * (12 + 1 + 4 * nb) + Q * C * (12 + 1 + 4) + Q * 4
                   + bucket_bytes)
    ops = 8 * slots
    bound_ms, bound_by = bound(bytes_moved, ops)
    # the previous contract's, from the gathered block (Q, nb, 3, cap) with
    # its ok bytes to the C+1 nearest distances and points
    old_bytes = Q * B * 13 + Q * 13 + Q * R * 16
    old_bound_ms, _ = bound(old_bytes, Q * B * (8 + R))
    log(f"  K3 at {what}: {Q} rows of {nb} buckets of {cap} slots, C={C}, "
        f"{n_buckets} distinct buckets reached by valid rows "
        f"({bucket_bytes} B), {slots} slots taken: kernel "
        f"{ms:.4f} ms on the card ({paced_ms:.4f} ms paced by the host), "
        f"plain {plain_ms:.4f} ms, library yardstick {library_ms:.4f} ms; "
        f"bound {bound_ms:.5f} ms ({bound_by}; {bytes_moved} B, {ops} ops), "
        f"the previous contract's {old_bound_ms:.5f} ms ({old_bytes} B)"
        + (("; the previous route's parts " + ", ".join(
            f"{k} {v:.4f}" for k, v in previous.items())
            + f" ms (sum {sum(previous.values()):.4f})") if previous else ""))
    return dict(ms=ms, paced_ms=paced_ms, plain_ms=plain_ms,
                library_ms=library_ms, bytes=bytes_moved, ops=ops,
                bound_ms=bound_ms, old_bound_ms=old_bound_ms)


def _k3_args(query, q_valid, grid):
    """select_candidates' arguments for one gather of gather_candidates,
    before C: the bucket ids hashed as it hashes them."""
    from lins_tpu_torch.ops.grid_nn import _bucket_of, _neighborhood

    bb = _bucket_of(_neighborhood(query, grid)[0], grid.table)
    return (query.contiguous(), q_valid.contiguous(), bb, grid.cells,
            grid.cnt)


def phase_k3_real(slam, smi):
    """K3 against its plain version on real gathers of the final map of
    the mapping run, at the surf and corner query shapes, bit for bit for
    both d2C rules; times per gather and per corner + surf pair.  The JSON
    entry is per launch: the pair's numbers halved."""
    import torch

    from lins_tpu_torch.geom import so3
    from lins_tpu_torch.mapping.mapper import downsample_scan
    from lins_tpu_torch.ops.grid_nn import (_bucket_of, _neighborhood,
                                            gather_candidates)

    log("== 5. K3 on real gathers of the mapping run")
    mapper, args = _mapping_inputs(slam)
    cfg, st = mapper.cfg, mapper.state
    C = cfg.s2m_cand
    sc = downsample_scan(*args[3:9], cfg, *mapper.caps, mapper.dtype)
    t, q = st.aft_pos, st.aft_quat
    err, times, calls = 0.0, [], []
    for what, pts, ok_q, grid in (
            ("surf", sc.query_surf, sc.query_surf_ok, st.lmap.surf_grid),
            ("corner", sc.query_corner, sc.query_corner_ok,
             st.lmap.corner_grid)):
        query = so3.quat_rotate(q[None], pts) + t
        k_args = _k3_args(query, ok_q, grid)
        err = max(err, _k3_equal(k_args, C, f"the real {what} gather "
                                 f"({int(ok_q.sum())} valid queries)"))
        times.append(k3_times(k_args, C, f"the real {what} gather",
                              PREVIOUS_K3_PARTS_MS[what]))
        calls.append(lambda query=query, ok_q=ok_q, grid=grid:
                     gather_candidates(query, ok_q, grid, C, True))
        ids_ms = device_ms(lambda query=query, grid=grid: _bucket_of(
            _neighborhood(query, grid)[0], grid.table), 10)
        log(f"  the {what} gather's bucket ids in PyTorch (neighbour cells "
            f"and hash): {ids_ms:.4f} ms on the card")
    tot = {k: sum(x[k] for x in times) for k in times[0]}
    b_ms, b_by = bound(tot["bytes"], tot["ops"])

    def pair():
        for c in calls:
            c()

    # four pairs: more of their ~50 launches would fill the launch queue
    # inside the card's sleep and wait for it
    whole_ms, whole_paced = device_ms(pair, 4), cuda_ms(pair, 20)
    prev = sum(sum(PREVIOUS_K3_PARTS_MS[w].values())
               for w in ("surf", "corner"))
    log(f"  K3 per corner + surf gather pair: kernel {tot['ms']:.4f} ms on "
        f"the card (previous kernel {PREVIOUS_MS['K3 pair']:.4f}; previous "
        f"mask, gather, kernel and finish {prev:.4f}), plain "
        f"{tot['plain_ms']:.4f} ms, library yardstick "
        f"{tot['library_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}), the "
        f"previous contract's {tot['old_bound_ms']:.5f} ms; the whole pair "
        f"of gather_candidates calls {whole_ms:.4f} ms on the card, "
        f"{whole_paced:.4f} ms paced by the host (previous wrapper pair "
        f"{PREVIOUS_MS['K3 wrapper pair']:.4f})")
    check(tot["ms"] < PREVIOUS_MS["K3 pair"],
          f"K3 per corner + surf pair faster than the previous kernel alone: "
          f"{tot['ms']:.4f} < {PREVIOUS_MS['K3 pair']:.4f} ms a pair on {smi}")
    torch.cuda.synchronize()
    return dict(name="select_candidates", route="cuda",
                source="lins_tpu_torch/csrc/select_candidates.cu",
                replaces="lins_tpu/ops/pallas_select.py:82",
                launches=None, max_abs_err=err, ms=tot["ms"] / 2,
                plain_ms=tot["plain_ms"] / 2, bound_ms=b_ms / 2,
                bound_by=b_by, library_ms=tot["library_ms"] / 2)


def _window_points(mapper):
    """The raw world-frame points of the recent window at the last
    keyframe (`keyframes.gather_window`): (corner points, valid), (surf +
    outlier points, valid), as the mapper's window rebuild unions them."""
    import torch

    from lins_tpu_torch.geom import so3
    from lins_tpu_torch.mapping import keyframes as kfm

    store = mapper.state.store
    slots, ok, _ = kfm.gather_window(store, store.count - 1, mapper.n_window)
    p = kfm.take_rows(store.pos, slots)[:, None, :]
    q = kfm.take_rows(store.quat, slots)[:, None, :]

    def world(cloud, valid):
        return (so3.quat_rotate(q, kfm.take_rows(cloud, slots)) + p,
                kfm.take_rows(valid, slots) & ok[:, None])

    cw, cv = world(store.corner, store.corner_valid)
    sw, sv = world(store.surf, store.surf_valid)
    ow, ov = world(store.outlier, store.outlier_valid)
    return ((cw.reshape(-1, 3), cv.reshape(-1)),
            (torch.cat([sw, ow], 1).reshape(-1, 3),
             torch.cat([sv, ov], 1).reshape(-1)))


def _lex(v):
    """Row order of integer triples (n, 3), lexicographic."""
    from lins_tpu_torch.ops.voxel import lex_order, pair_key

    return lex_order([pair_key(v[:, 0], v[:, 1]), v[:, 2].long()])


def _grid_centroids(grid, leaf):
    """The fused grid's centroids in the lexicographic order of their
    voxels, and those voxels.  A centroid is the mean of points of one
    voxel, rounded once, so it lies in that voxel."""
    import torch

    from lins_tpu_torch.frontend.projection import div_const

    live = (torch.arange(grid.cap, device=grid.cnt.device)[None, :]
            < grid.cnt[:, None])
    c = grid.cells.transpose(1, 2)[live]
    v = torch.floor(div_const(c, leaf)).to(torch.int32)
    o = _lex(v)
    return c[o], v[o]


def _voxel_means64(pts, ok, leaf, counts=False):
    """The voxels of the valid points in lexicographic order and their
    means, summed in float64 by voxel (no prefix sums); with `counts`, also
    each voxel's point count."""
    import torch

    from lins_tpu_torch.frontend.projection import div_const

    p = pts[ok]
    v = torch.floor(div_const(p, leaf)).to(torch.int32)
    uv, inv = torch.unique(v, dim=0, return_inverse=True)
    sums = torch.zeros((len(uv), 3), dtype=torch.float64, device=p.device)
    sums.index_add_(0, inv, p.double())
    n = torch.bincount(inv, minlength=len(uv))
    return (uv, sums / n[:, None]) + ((n,) if counts else ())


def _downsample_err(what, got, cap, pts, ok, leaf):
    """The valid centroids `got` (n, 3) of a `voxel_downsample` output
    (compacted in the lexicographic order of their voxels, the lowest
    ranks kept under its cap) against the float64 means of the voxels of
    `pts[ok]`: as many as the voxels (or the cap), each within
    GRID_CENT_TOL_M.  Returns the largest error."""
    n = len(got)
    _, tc = _voxel_means64(pts, ok, leaf)
    e = float((got.double() - tc[:n]).norm(dim=1).max()) if n else 0.0
    check(n == min(len(tc), cap) > 0 and e <= GRID_CENT_TOL_M,
          f"{what}: {n} centroids of {len(tc)} voxels ({int(ok.sum())} "
          f"points, leaf {leaf}, cap {cap}), the largest {e:.3e} m from "
          f"the float64 means (gate {GRID_CENT_TOL_M} m)")
    return e


def _kept_d2(query, cand, cand_ok):
    """Each query's kept squared distances in ascending order, +inf in an
    empty slot."""
    import torch

    diff = cand - query[:, None, :]
    d2 = torch.where(cand_ok, torch.sum(diff * diff, -1), torch.inf)
    return torch.sort(d2, dim=1).values


def phase_grid_voxelized(slam, smi):
    """The fused voxel-grid build (`grid_nn.build_grid_voxelized`) on the
    window path's final state, at the mapper's own grid geometry, over the
    raw window points at the last keyframe: against the voxel map's build
    (`build_voxel_map(...).as_grid()`, the same voxels slot for slot) and
    `voxel_downsample` of the same points (the same count), its centroids
    within GRID_CENT_TOL_M of the voxels' float64 means; K3 through
    `gather_candidates` on it for the last scan's world-frame queries, bit
    for bit against its plain version and its kept distances against the
    voxel map grid's; K3 on a supercell grid (the reference's leaf 0.4 m,
    m 5, cap 128) and on the reference's dense corner cell; `grid_knn`
    against `top_k_nn` by brute force under the 1 m gate and against a
    CPU float64 copy.  The centroids of the voxel map's build and of
    `voxel_downsample` are held to the float64 means too, as the fused
    build's are (all three sum their runs in float64), and so K3's kept
    distances on the fused grid to the voxel map grid's within
    GRID_D2_RTOL relative.  Returns (K3 launches of the
    `gather_candidates` calls, the largest difference of K3's kept
    distances from its plain version's, the largest centroid error of the
    voxel map's build and `voxel_downsample` against the float64
    means)."""
    import torch

    from lins_tpu_torch.frontend.projection import div_const
    from lins_tpu_torch.geom import so3
    from lins_tpu_torch.mapping.mapper import downsample_scan
    from lins_tpu_torch.ops import grid_nn
    from lins_tpu_torch.ops.voxel import top_k_nn, voxel_downsample
    from lins_tpu_torch.ops.voxel_map import build_voxel_map

    log("== 5. the fused voxel-grid build, grid_knn and K3 on the window "
        "path's final map")
    mapper, args = _mapping_inputs(slam)
    cfg, st, gp, dev = mapper.cfg, mapper.state, mapper.gp, mapper.device
    C = cfg.s2m_cand
    sc = downsample_scan(*args[3:9], cfg, *mapper.caps, mapper.dtype)

    def world(pts):
        return so3.quat_rotate(st.aft_quat[None], pts) + st.aft_pos

    (cw, cv), (sw, sv) = _window_points(mapper)
    grids, launches, k3_err, cent_err = {}, 0, 0.0, 0.0
    for what, pts, ok, q, q_ok, geo in (
            ("corner", cw, cv, world(sc.query_corner), sc.query_corner_ok,
             (gp.corner_leaf, gp.corner_m, gp.corner_table, gp.corner_cap,
              gp.corner_nb)),
            ("surf", sw, sv, world(sc.query_surf), sc.query_surf_ok,
             (gp.surf_leaf, gp.surf_m, gp.surf_table, gp.surf_cap,
              gp.surf_nb))):
        leaf = geo[0]
        fused, n_vox = grid_nn.build_grid_voxelized(pts, ok, *geo)
        vm = build_voxel_map(pts, ok, *geo)
        vd, vd_ok = voxel_downsample(pts, ok, leaf)
        fused_ms = cuda_ms(lambda: grid_nn.build_grid_voxelized(
            pts, ok, *geo), 5)
        vm_ms = cuda_ms(lambda: build_voxel_map(pts, ok, *geo), 5)
        n_vox, n_vm, n_vd = int(n_vox), int(vm.n_live), int(vd_ok.sum())
        check(n_vox == n_vm == n_vd == int(fused.cnt.sum()) > 0,
              f"the fused {what} grid ({int(ok.sum())} of {len(ok)} window "
              f"points, leaf {leaf}, m {geo[1]}, table {geo[2]}, cap "
              f"{geo[3]}, nb {geo[4]}): {n_vox} voxels, every one in a "
              f"slot; the voxel map {n_vm} live, voxel_downsample {n_vd}")
        # the voxels: the fused grid's slots hold the voxel map's voxels
        # slot for slot (both rank a cell's voxel runs in one sort order)
        # and the voxels of the float64 means, computed apart
        live = (torch.arange(fused.cap, device=dev)[None, :]
                < fused.cnt[:, None])
        slot_vox = torch.floor(div_const(fused.cells, leaf)).to(torch.int32)
        check(torch.equal(fused.cnt, vm.hwm)
              and torch.equal(live, vm.vcnt > 0)
              and torch.equal(slot_vox.transpose(1, 2)[live],
                              vm.vcoord.transpose(1, 2)[live]),
              f"the fused {what} grid's slots hold the voxel map's voxels, "
              f"slot for slot")
        c, v = _grid_centroids(fused, leaf)
        tv, tc = _voxel_means64(pts, ok, leaf)
        vm_c = vm.cells.transpose(1, 2)[live][_lex(
            vm.vcoord.transpose(1, 2)[live])]
        e_f = float((c.double() - tc).norm(dim=1).max())
        e_vm = float((vm_c.double() - tc).norm(dim=1).max())
        e_vd = float((vd[:n_vd].double() - tc).norm(dim=1).max())
        cent_err = max(cent_err, e_vm, e_vd)
        check(torch.equal(v, tv) and max(e_f, e_vm, e_vd) <= GRID_CENT_TOL_M,
              f"the {what} centroids (float64 run sums) within "
              f"{GRID_CENT_TOL_M} m of their voxels' float64 means: the "
              f"fused grid's {e_f:.3e} m, the voxel map build's {e_vm:.3e} "
              f"m, voxel_downsample's {e_vd:.3e} m")
        _reset_counts()
        got = grid_nn.gather_candidates(q, q_ok, fused, C, True)
        torch.cuda.synchronize()
        n = _counts()["select"]
        check(n == 1, f"gather_candidates on the fused {what} grid: K3 "
              f"launched {n} time(s)")
        launches += n
        k_args = _k3_args(q, q_ok, fused)
        k3_err = max(k3_err, _k3_equal(k_args, C, f"the fused {what} grid "
                                       f"({int(q_ok.sum())} valid queries)"))
        # kept distances against the voxel map grid's: the same voxels and
        # both centroids rounded once from float64 means, so each sorted
        # kept distance equals the voxel map grid's within GRID_D2_RTOL
        want = grid_nn.gather_candidates(q, q_ok, vm.as_grid(), C, True)
        d_f, d_v = _kept_d2(q, got[0], got[1]), _kept_d2(q, want[0], want[1])
        fin = torch.isfinite(d_v)
        e = float((c - vm_c).norm(dim=1).max())
        gap = (d_f - d_v).abs()[fin]
        d = torch.maximum(d_f, d_v)[fin]
        check(torch.equal(fin, torch.isfinite(d_f))
              and bool((gap <= GRID_D2_RTOL * d).all()),
              f"K3's kept distances on the fused {what} grid equal the voxel "
              f"map grid's, {int(fin.sum())} kept: within {GRID_D2_RTOL} d "
              f"(largest difference {float(gap.max()):.3e}, relative "
              f"{float((gap / d.clamp(min=1e-12)).max()):.3e}; the largest "
              f"centroid difference {e:.3e} m)")
        k3_times(k_args, C, f"the fused {what} grid", {})
        k3_times(_k3_args(q, q_ok, vm.as_grid()), C,
                 f"the voxel map's {what} grid", {})
        k_fused = device_ms(lambda: grid_nn.gather_candidates(
            q, q_ok, fused, C, True), 8)
        k_vm = device_ms(lambda: grid_nn.gather_candidates(
            q, q_ok, vm.as_grid(), C, True), 8)
        if what == "surf":
            for name, fn in (("build_grid_voxelized", grid_nn.
                              build_grid_voxelized),
                             ("build_voxel_map", build_voxel_map)):
                log_profile(f"{name} of the surf window",
                            profile_call(lambda fn=fn: fn(pts, ok, *geo))[0])
        log(f"  {what}: build_grid_voxelized {fused_ms:.4f} ms, "
            f"build_voxel_map {vm_ms:.4f} ms (CUDA events, paced by the "
            f"host); gather_candidates (K3) on the fused grid {k_fused:.4f} "
            f"ms, on the voxel map's grid {k_vm:.4f} ms (the card asleep "
            f"while the host enqueues); {n_vox} voxels; on {smi}")
        grids[what] = (fused, q, q_ok, pts, ok)

    # the reference's supercell geometry (tests/test_mapping.py:265) over
    # the surf window, and its dense corner cell (:308-323)
    _, q, q_ok, pts, ok = grids["surf"]
    g = (torch.arange(6, device=dev, dtype=pts.dtype) + 0.5) * 0.2
    dense = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                        -1).reshape(-1, 3)
    dq = torch.cat([torch.tensor([[0.61, 0.59, 0.6]], dtype=pts.dtype,
                                 device=dev),
                    dense[::7] + 0.05])
    for what, p_, ok_, q_, q_ok_, geo in (
            ("supercell", pts, ok, q, q_ok, (0.4, 5, gp.surf_table, 128, 8)),
            ("dense corner", dense, torch.ones(216, dtype=torch.bool,
                                               device=dev),
             dq, torch.ones(len(dq), dtype=torch.bool, device=dev),
             (0.2, 6, 512, 224, 27))):
        grid, n_vox = grid_nn.build_grid_voxelized(p_, ok_, *geo)
        check(int(grid.cnt.sum()) == int(n_vox) > 0
              and (what != "dense corner" or int(grid.cnt.max()) == 216),
              f"the {what} grid (leaf {geo[0]}, m {geo[1]}, cap {geo[3]}, "
              f"nb {geo[4]}): {int(n_vox)} voxels, every one in a slot, "
              f"{int(grid.cnt.max())} in the fullest bucket")
        _reset_counts()
        grid_nn.gather_candidates(q_, q_ok_, grid, C, True)
        torch.cuda.synchronize()
        n = _counts()["select"]
        check(n == 1, f"gather_candidates on the {what} grid: K3 launched "
              f"{n} time(s)")
        launches += n
        k_args = _k3_args(q_, q_ok_, grid)
        k3_err = max(k3_err, _k3_equal(k_args, C, f"the {what} grid "
                                       f"({len(q_)} queries)"))
        k3_times(k_args, C, f"the {what} grid", {})
        ms = device_ms(lambda: grid_nn.gather_candidates(
            q_, q_ok_, grid, C, True), 8)
        log(f"  gather_candidates (K3) on the {what} grid: {ms:.4f} ms on "
            f"{smi}")

    # grid_knn on the fused surf grid: brute force over its own centroids
    # under the 1 m gate, the reference's limits (tests/test_mapping.py:
    # 84-86), and a CPU float64 copy
    fused, q, q_ok = grids["surf"][:3]
    nn, d2 = grid_nn.grid_knn(q, q_ok, fused, 5)
    ref = _grid_centroids(fused, gp.surf_leaf)[0]
    _, d2_b = top_k_nn(q, q_ok, ref, torch.ones(len(ref), dtype=torch.bool,
                                                device=dev), 5)
    gate = d2_b[:, 4] < 1.0
    n_gate = int(gate.sum())
    err_b = float((d2[gate] - d2_b[gate]).abs().max()) if n_gate else 0.0
    check(n_gate >= KNN_MIN_GATED
          and torch.allclose(d2[gate], d2_b[gate], rtol=KNN_RTOL,
                             atol=KNN_ATOL)
          and bool((d2 >= d2_b - KNN_ATOL).all()),
          f"grid_knn on the fused surf grid equals top_k_nn by brute force "
          f"over {len(ref)} centroids for the {n_gate} of {int(q_ok.sum())} "
          f"valid queries under the 1 m gate (>= {KNN_MIN_GATED}; within "
          f"rtol {KNN_RTOL}, atol {KNN_ATOL}: {err_b:.3e}), never closer")
    cpu = dataclasses.replace(fused, cells=fused.cells.cpu().double(),
                              cnt=fused.cnt.cpu())
    nn64, d2_64 = grid_nn.grid_knn(q.cpu().double(), q_ok.cpu(), cpu, 5)
    fin = torch.isfinite(d2_64)
    err_c = float((d2.cpu().double() - d2_64)[fin].abs().max())
    check(torch.equal(fin, torch.isfinite(d2.cpu()))
          and torch.allclose(d2.cpu().double(), d2_64, rtol=KNN_CPU_RTOL,
                             atol=KNN_CPU_ATOL),
          f"grid_knn on the card (float32) equals grid_knn of a CPU float64 "
          f"copy: the same {int(fin.sum())} finite slots, distances within "
          f"rtol {KNN_CPU_RTOL}, atol {KNN_CPU_ATOL} ({err_c:.3e})")
    knn_ms = cuda_ms(lambda: grid_nn.grid_knn(q, q_ok, fused, 5), 5)
    log(f"  grid_knn on the fused surf grid: {knn_ms:.4f} ms (CUDA events) "
        f"on {smi}")
    torch.cuda.synchronize()
    return launches, k3_err, cent_err


def phase_incremental_map(slam, smi):
    """The window path's incremental voxel maps on its final state, before
    its next compaction rebuild: `VoxelMap.vsum` and `vcnt` are added and
    subtracted at every keyframe insert and eviction since the last build,
    `vsum` in the working dtype.  Every live slot's voxel and count must be
    those of the points of the keyframes in the window (`lmap.sel`), and
    its centroid, `cells` and vsum / vcnt both, within GRID_CENT_TOL_M of
    their float64 mean.  The run fills less than its window, so nothing
    was evicted: the same check then holds a copy of the maps from which
    the older half of the window's keyframes are evicted (their stored
    deltas subtracted, as the inserts of a full window do).  Returns the
    largest centroid error."""
    import torch

    from lins_tpu_torch.mapping import keyframes as kfm
    from lins_tpu_torch.mapping.local_map import _to_world
    from lins_tpu_torch.ops.voxel_map import apply_delta
    from lins_tpu_torch.utils.tree import tree_map

    log("== 5. the incremental window map against float64 means (the "
        "window path's final state)")
    mapper = slam.mapper
    lm, store, gp = mapper.state.lmap, mapper.state.store, mapper.gp
    dtype = lm.corner_vm.cells.dtype
    slots = kfm.slot_of(store, torch.clamp(lm.sel, min=0)).long()
    p, q = store.pos[slots], store.quat[slots]

    def world(cloud, valid, keep):
        w, v = _to_world(kfm.take_rows(cloud, slots).to(dtype),
                         kfm.take_rows(valid, slots), p, q, keep[:, None])
        return w.reshape(-1, 3), v.reshape(-1)

    def hold(what, cvm, svm, keep):
        """cvm and svm against the float64 means of the points of the
        window rows `keep`; returns the largest error."""
        cw, cv = world(store.corner, store.corner_valid, keep)
        sw, sv = world(store.surf, store.surf_valid, keep)
        ow, ov = world(store.outlier, store.outlier_valid, keep)
        err = 0.0
        for ch, vm, pts, valid, leaf in (
                ("corner", cvm, cw, cv, gp.corner_leaf),
                ("surf", svm, torch.cat([sw, ow]), torch.cat([sv, ov]),
                 gp.surf_leaf)):
            live = vm.vcnt > 0
            vox = vm.vcoord.transpose(1, 2)[live]
            o = _lex(vox)
            cells = vm.cells.transpose(1, 2)[live][o].double()
            ratio = (vm.vsum.double() / vm.vcnt.clamp(min=1)[:, None, :]
                     ).transpose(1, 2)[live][o]
            tv, tc, tn = _voxel_means64(pts, valid, leaf, counts=True)
            same = (len(tv) == len(vox) and torch.equal(vox[o], tv)
                    and torch.equal(vm.vcnt[live][o].long(), tn))
            e_c = float((cells - tc).norm(dim=1).max()) if same else math.inf
            e_r = float((ratio - tc).norm(dim=1).max()) if same else math.inf
            err = max(err, e_c, e_r)
            check(same and max(e_c, e_r) <= GRID_CENT_TOL_M,
                  f"the incremental {ch} map, {what} ({int(keep.sum())} "
                  f"keyframes in it, {len(vox)} live voxels, the points' "
                  f"{len(tv)}): voxels and counts equal; centroids within "
                  f"{GRID_CENT_TOL_M} m of the float64 means: cells "
                  f"{e_c:.3e} m, vsum / vcnt {e_r:.3e} m ({vm.vsum.dtype}) "
                  f"on {smi}")
        return err

    ok = lm.sel >= 0
    err = hold(f"{int(lm.pushes)} inserts since the last rebuild",
               lm.corner_vm, lm.surf_vm, ok)
    rows = torch.nonzero(ok).flatten()
    old = rows[torch.argsort(lm.sel[rows])][:len(rows) // 2]
    cvm, svm = lm.corner_vm, lm.surf_vm
    for r in old.tolist():
        cvm = apply_delta(cvm, tree_map(lambda a: a[r], lm.dc), -1)
        svm = apply_delta(svm, tree_map(lambda a: a[r], lm.dsf), -1)
    gone = torch.zeros_like(ok)
    gone[old] = True
    err = max(err, hold(f"then the {len(old)} oldest evicted", cvm, svm,
                        ok & ~gone))
    torch.cuda.synchronize()
    return err


def phase_map_means(h_slam, hs_slam, smi):
    """The map builders outside the mapping step against the float64 means
    of their voxels: the loop submap and the current cloud of
    `loop_clouds` at path H's final loop candidate, and
    `global_map_points` (the runner's global map, leaf 0.4 m) on path
    H-sparse's final state, each centroid within GRID_CENT_TOL_M.  Returns
    the largest error of each."""
    import torch

    from lins_tpu_torch.graph import loop_closure as lc
    from lins_tpu_torch.utils import checkpoint as ck

    log("== 6. the loop clouds and the global map against float64 means")
    m = h_slam.mapper
    cfg, store = m.cfg, m.state.store
    t = torch.full((), float(h_slam.trajectory[-1][0]), dtype=m.dtype,
                   device=m.device)
    cur = torch.clamp(store.count - 1, min=0)
    idx, found = lc.detect_loop(store, cur, t, cfg)
    check(bool(found), f"the final keyframe {int(cur)} of path H has a loop "
          f"candidate ({int(idx)})")
    submap, sub_ok, cloud, cloud_ok = lc.loop_clouds(
        store, idx, cur, t, cfg, m.submap_cap, m.cloud_cap)
    sub_xyz, sub_in, cloud_w, cloud_in = lc.loop_points(store, idx, cur, t,
                                                        cfg)
    e_sub = _downsample_err(f"path H's loop submap around keyframe "
                            f"{int(idx)}", submap[sub_ok], len(sub_ok),
                            sub_xyz, sub_in, cfg.map_surf_leaf)
    e_cloud = _downsample_err(f"path H's current cloud (keyframe "
                              f"{int(cur)})", cloud[cloud_ok],
                              len(cloud_ok), cloud_w, cloud_in,
                              cfg.map_surf_leaf)
    leaf, cap = 0.4, 1 << 20
    got = torch.as_tensor(ck.global_map_points(hs_slam.mapper, leaf, cap),
                          device=m.device)
    xyz, ok = ck.global_map_cloud(hs_slam.mapper)
    e_map = _downsample_err(
        f"global_map_points on path H-sparse's final state "
        f"({int(hs_slam.mapper.state.store.count)} keyframes)", got,
        min(cap, xyz.shape[0]), xyz, ok, leaf)
    log(f"  the largest centroid error from the float64 means: loop submap "
        f"{e_sub:.3e} m, current cloud {e_cloud:.3e} m, global map "
        f"{e_map:.3e} m (gate {GRID_CENT_TOL_M} m) on {smi}")
    return dict(submap=e_sub, cloud=e_cloud, global_map=e_map)


def _k6_equal(x, C, what):
    """K6 on (Q, B) values `x` against its plain version, bit for bit, and
    against torch.topk's values; returns the kernel's output."""
    import torch

    from lins_tpu_torch.ops import select

    before = select.topk_smallest.launches
    got = select.topk_smallest(x, C)
    torch.cuda.synchronize()
    want = select.topk_smallest_plain(x, C)
    lib = torch.topk(x, C, dim=1, largest=False).values
    bits = torch.equal(got.view(torch.int32), want.view(torch.int32))
    check(select.topk_smallest.launches == before + 1 and bits
          and torch.equal(got, lib),
          f"K6 == plain (bit for bit) == torch.topk (values; bits "
          f"{torch.equal(got.view(torch.int32), lib.view(torch.int32))}) on "
          f"{what}, ({x.shape[0]}, {x.shape[1]}), C={C}")
    return got


def phase_k6():
    """K6 on the canary's three shapes and on edge cases: bit-equal to its
    plain version and equal to torch.topk's values; times at each of the
    canary's shapes.  Returns its JSON entry at the largest (launches
    filled in from the main path's runs)."""
    import torch

    from lins_tpu_torch.ops import select

    log("== 3. kernels: K6 topk_smallest")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    signed = rng.uniform(-50, 50, (256, 1000)).astype(np.float32)
    signed[:, ::7] = 0.0
    signed[:, 3::7] = -0.0
    signed[0] = -0.0
    signed[1, 500:] = np.inf
    signed[2] = -np.inf
    edge = (("B = 1000 (not a multiple of 32)",
             rng.uniform(0, 100, (333, 1000)), (1, 17, 64, 999, 1000)),
            ("negative values, +0.0 and -0.0 ties, infinities", signed,
             (1, 5, 64, 143, 1000)),
            ("rows of one value each", np.repeat(
                rng.integers(-3, 4, (64, 1)).astype(np.float32), 1728, 1),
             (1, 64, 1728)),
            ("the longest rows the wrapper takes",
             rng.uniform(0, 1, (40, 12032)), (1, 64, 3000, 12032)),
            ("a 0.25 lattice (many exact ties)",
             np.round(rng.uniform(0, 8, (512, 1728)) * 4) / 4, (1, 64, 700)))
    for what, vals, Cs in edge:
        x = torch.as_tensor(np.asarray(vals, np.float32), device=dev)
        for C in Cs:
            _k6_equal(x, C, what)
    out = None
    for Q, B, C in ((128, 256, 8), (1024, 1728, 64), (6144, 1728, 64)):
        rng = np.random.default_rng(Q)
        d2 = rng.uniform(0, 100, (Q, B)).astype(np.float32)
        d2[0] = np.inf
        d2[1, ::2] = 3.0
        x = torch.as_tensor(d2, device=dev)
        got = _k6_equal(x, C, "the canary's values")
        want = select.topk_smallest_plain(x, C)
        # the kernel and torch.topk timed alike, enqueued while the card
        # sleeps, so that a launch shorter than its Python enqueue is not
        # timed by the host
        ms = device_ms(lambda: select.topk_smallest(x, C), 100)
        library_ms = device_ms(
            lambda: torch.topk(x, C, dim=1, largest=False), 20)
        plain_ms = cuda_ms(lambda: select.topk_smallest_plain(x, C), 5)
        # bytes: each value read once, each output written once;
        # operations: a key and a compare per value, the least a selection
        # does
        bytes_moved = Q * B * 4 + Q * C * 4
        bound_ms, bound_by = bound(bytes_moved, 2 * Q * B)
        log(f"  K6 ({Q}, {B}), C={C}: kernel {ms:.4f} ms, torch.topk "
            f"{library_ms:.4f} ms (both enqueued while the card slept), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        out = dict(name="topk_smallest", route="cuda",
                   source="lins_tpu_torch/csrc/topk_smallest.cu",
                   replaces="tools/r4_mosaic_canary.py:24", launches=None,
                   max_abs_err=float((got - want).abs().nan_to_num().max()),
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)
    check(out["ms"] < out["library_ms"],
          f"K6 at (6144, 1728), C=64 faster than torch.topk: {out['ms']:.4f}"
          f" < {out['library_ms']:.4f} ms (the previous design "
          f"{PREVIOUS_MS['K6']:.4f} ms)")
    return out


def _k45_case(seed, Qs, Rs, Qc, Rc, rings, lattice=False, far=False,
              no_query=False, no_reference=False, nan_pad=False,
              on_rings=None, one_reference=False):
    """Random surf and corner sets on the card: queries in an 80 m box,
    references scattered about them on `rings` rings (or on the rings of
    `on_rings` only), about 10% of each invalid.  `lattice`: every
    coordinate on a 0.25 m lattice and no de-skew time, so many distances
    tie exactly; `far`: every query 200 m off; `nan_pad`: the invalid
    rows' coordinates NaN; `one_reference`: a single valid reference."""
    import torch

    from lins_tpu_torch.ops import assoc

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    sets = []
    for Q, R in ((Qs, Rs), (Qc, Rc)):
        q = rng.uniform(-40, 40, (Q, 3)) * np.asarray([1.0, 1.0, 0.1])
        r = q[rng.integers(0, Q, R)] + rng.normal(0, 0.8, (R, 3))
        rel = rng.uniform(0, 1, Q)
        if lattice:
            q, r, rel = np.round(q * 4) / 4, np.round(r * 4) / 4, 0 * rel
        if far:
            q = q + np.asarray([200.0, 0.0, 0.0])
        qv, rv = rng.random(Q) < 0.9, rng.random(R) < 0.9
        qv &= not no_query
        rv &= not no_reference
        if one_reference:
            rv[:] = False
            rv[R // 3] = True
        ring = (rng.integers(0, rings, R) if on_rings is None
                else rng.choice(np.asarray(on_rings), R))
        if nan_pad:
            q[~qv], rel[~qv], r[~rv] = np.nan, np.nan, np.nan

        def t(a, dt=torch.float32):
            return torch.as_tensor(a).to(device=dev, dtype=dt).contiguous()

        sets.append((assoc.Queries(t(q), t(rel), t(qv, torch.bool)),
                     assoc.references(t(r), t(ring, torch.int32),
                                      t(rv, torch.bool))))
    return sets


def _k45_equal(surf, corner, rn, qbn, cfg, what):
    """K4 and K5 in one launch against their plain versions on the same
    card tensors, in both row forms and weight states; returns the largest
    absolute and scale-relative differences of the blocks and the rows
    each run kept."""
    import torch

    from lins_tpu_torch.ops import assoc

    err_abs = err_rel = 0.0
    kept = []
    max_d2 = cfg.nearest_feature_search_sq_dist
    for form in ("ieskf", "gn"):
        pose = assoc.pose_scalars(rn, qbn, form)
        scale = (cfg.lidar_scale if form == "ieskf" else
                 assoc.GN_RES_SCALE)
        for weighted in (False, True):
            got = assoc.launch(surf, corner, pose, form, weighted, max_d2,
                               scale)
            torch.cuda.synchronize()
            for k, (kind, pair) in enumerate(((assoc.SURF, surf),
                                              (assoc.CORNER, corner))):
                want = assoc._plain(kind, *pair, pose, form, weighted,
                                    max_d2, scale)
                e, rel, fin = k45_diff(got[k], want)
                err_abs, err_rel = max(err_abs, e), max(err_rel, rel)
                n_g, n_w = int(got[k][3]), int(want[3])
                kept.append(n_w)
                check(n_g == n_w and fin and rel <= K45_TOL,
                      f"K{4 + k} == plain on {what} ({form} rows, weighted "
                      f"{int(weighted)}): {n_g} of {pair[0].xyz.shape[0]} "
                      f"rows kept (plain {n_w}), every entry within "
                      f"{rel:.2e} of its scale (largest difference {e:.3g})")
    return err_abs, err_rel, kept


def k45_diff(got, want):
    """(largest absolute difference, largest difference over its entry's
    scale, all finite) of one set's (JtJ, Jtr, sum r^2) against the plain
    version's.  Entry (a, b) of the Gram of [J6 | r] has the scale
    sqrt(G_aa * G_bb) of the plain diagonal; where that is 0 the entry must
    equal exactly."""
    import torch

    def gram(blocks):
        G = torch.zeros((7, 7), dtype=torch.float64)
        G[:6, :6] = blocks[0].double().cpu()
        G[:6, 6] = G[6, :6] = blocks[1].double().cpu()
        G[6, 6] = blocks[2].double().cpu()
        return G

    g, w = gram(got), gram(want)
    d = w.diagonal().clamp(min=0.0)
    scale = torch.sqrt(d[:, None] * d[None, :])
    diff = (g - w).abs()
    rel = torch.where(scale > 0, diff / scale.clamp(min=1e-300),
                      torch.where(diff > 0, torch.inf, 0.0))
    return (float(diff.nan_to_num(nan=torch.inf).max()),
            float(rel.nan_to_num(nan=torch.inf).max()),
            bool(torch.isfinite(g).all()))


def _k45_sharp(real, cfg):
    """The card-vs-plain rule is sharp enough to see a wrong residual: on
    the real VLP-16 trip, a result whose GN residual column has the wrong
    sign, whose GN Jtb position entries are zeroed or flipped, or whose
    IESKF sum r^2 is 1% off must fail it."""
    from lins_tpu_torch.ops import assoc

    surf, corner, rn, qbn = real
    max_d2 = cfg.nearest_feature_search_sq_dist
    for form in ("gn", "ieskf"):
        pose = assoc.pose_scalars(rn, qbn, form)
        scale = (cfg.lidar_scale if form == "ieskf" else
                 assoc.GN_RES_SCALE)
        got = assoc.launch(surf, corner, pose, form, True, max_d2, scale)
        for k, (kind, pair) in enumerate(((assoc.SURF, surf),
                                          (assoc.CORNER, corner))):
            J, b, r2, n = got[k]
            wrong = {"ieskf": {"sum r^2 1% high": (J, b, r2 * 1.01, n)},
                     "gn": {"residual sign flipped": (J, -b, r2, n),
                            "Jtb position entries zeroed":
                                (J, b * b.new_tensor([1, 1, 1, 0, 0, 0]),
                                 r2, n),
                            "Jtb position entries flipped":
                                (J, b * b.new_tensor([1, 1, 1, -1, -1, -1]),
                                 r2, n)}}[form]
            for what, bad in wrong.items():
                rel = k45_diff(bad, got[k])[1]
                check(rel > K45_TOL,
                      f"K{4 + k} check sees a wrong result ({form} rows, "
                      f"{what}): {rel:.2e} of its entry's scale > "
                      f"K45_TOL {K45_TOL:.2e}")


def _trip_inputs(cfg, data, k):
    """The association inputs of RUNNING scan k on the card: its flat and
    sharp features, the previous scan's reference sets, and the last
    relative pose as the linearisation pose."""
    from lins_tpu_torch.frontend.pipeline import process_cloud
    from lins_tpu_torch.ops import assoc

    odo, _ = warm_odometry(cfg, data, k)
    xyz_t, n_t = odo._scan_tensors(data["scans_xyz"][k], data["scans_n"][k])
    _, _, feats = process_cloud(xyz_t, n_t, cfg)
    dt = odo.dtype
    surf, corner = assoc.reference_sets(odo.last_surf, odo.last_corner, dt)
    rn, qbn = odo.rel_pose
    return ((assoc.queries(feats.flat, dt), surf),
            (assoc.queries(feats.sharp, dt), corner), rn, qbn)


def _k45_work(kind, pair, pose, max_d2):
    """(bytes, operations) of one set at these inputs.  Bytes: each input
    read once (a query's 3 coordinates, time and flag, a reference's
    16-byte laid-out row, the ring offsets, the pose) and the set's 45
    output words written
    once.  Operations: 9 per (query, reference) pair whose distance the
    kernel forms (3 differences, 3 products, 2 sums, a compare): pass 1
    every valid query against every valid reference, pass 2 each query
    with a reference within max_d2 against the valid references of the
    rings its pass reads (ring[i1] less i1, and ±1, ±2 for K4; ±1, ±2 for
    K5)."""
    from lins_tpu_torch.ops import assoc

    q, ref = pair
    p0, _ = assoc.deskew(q.xyz, q.rel, pose)
    i1, d1 = assoc._tripod(kind, p0, ref)[:2]
    near = q.valid & (d1 < max_d2)
    ring = ref.ring.long()
    gap = (ring[None, :] - ring[i1][:, None]).abs()
    window = (gap <= 2) & ref.valid[None, :]
    if kind == assoc.CORNER:
        window &= gap != 0
    pairs = (int(q.valid.sum()) * int(ref.valid.sum())
             + int(window[near].sum())
             - (int(near.sum()) if kind == assoc.SURF else 0))
    bytes_moved = (q.xyz.shape[0] * 17 + ref.xyz.shape[0] * 16
                   + ref.offsets.numel() * 4 + pose.numel() * 4 + 45 * 4)
    return bytes_moved, 9 * pairs


def phase_k45(cfg, data, cfg_h, data_h):
    """K4 and K5 against their plain versions on the card, then their
    times on the real VLP-16 trip; returns their JSON entries (launches
    filled in by the main paths)."""
    import torch

    from lins_tpu_torch.ops import assoc

    log("== 3. kernels: K4 surf_normal_equations and K5 "
        "corner_normal_equations")
    Qs, Rs, Qc, Rc = cfg.max_flat, cfg.max_less_flat, cfg.max_sharp, \
        cfg.max_less_sharp
    dev = torch.device("cuda")
    rn = torch.tensor([0.31, -0.12, 0.02], device=dev)
    qbn = torch.tensor([0.999, 0.011, -0.021, 0.031], device=dev)
    qbn = qbn / torch.linalg.vector_norm(qbn)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    err_abs = err_rel = 0.0
    cases = (("random clouds", dict(), rn, qbn),
             ("a lattice (exact ties, no de-skew)", dict(lattice=True), rn,
              ident),
             ("invalid rows with NaN coordinates", dict(nan_pad=True), rn,
              qbn),
             ("no valid query", dict(no_query=True), rn, qbn),
             ("no valid reference", dict(no_reference=True), rn, qbn),
             ("every query beyond max_d2", dict(far=True), rn, qbn),
             ("references on two neighbouring rings", dict(on_rings=(7, 8)),
              rn, qbn),
             ("references on five rings, each end ring two rings from its "
              "only neighbour, the middle one alone (the +-2 window clipped "
              "at ring 0)", dict(on_rings=(0, 2, 7, cfg.line_num - 3,
                                           cfg.line_num - 1)), rn, qbn),
             ("references on the first two and last two rings",
              dict(on_rings=(0, 1, cfg.line_num - 2, cfg.line_num - 1)), rn,
              qbn),
             ("references on the layout's last rings (253-255)",
              dict(on_rings=(253, 254, 255)), rn, qbn),
             ("one valid ring", dict(on_rings=(5,)), rn, qbn),
             ("a single valid reference", dict(one_reference=True), rn,
              qbn))
    for seed, (what, kw, c_rn, c_qbn) in enumerate(cases):
        surf, corner = _k45_case(seed, Qs, Rs, Qc, Rc, cfg.line_num, **kw)
        e = _k45_equal(surf, corner, c_rn, c_qbn, cfg,
                       f"{what} ({Qs}x{Rs}, {Qc}x{Rc})")
        err_abs, err_rel = max(err_abs, e[0]), max(err_rel, e[1])
        if len(kw.get("on_rings", ())) > 1:
            check(min(e[2]) > 0, f"{what}: each set keeps rows in every "
                  f"form (least {min(e[2])})")
    trips = {}
    for name, c, d in (("VLP-16", cfg, data), ("HDL-64", cfg_h, data_h)):
        surf, corner, t_rn, t_qbn = _trip_inputs(c, d, WARMUP_SCANS - 1)
        e = _k45_equal(surf, corner, t_rn, t_qbn, c,
                       f"the real trip inputs of a RUNNING {name} scan")
        err_abs, err_rel = max(err_abs, e[0]), max(err_rel, e[1])
        trips[name] = (surf, corner, t_rn, t_qbn)
    real = trips["VLP-16"]
    log(f"  K4/K5 largest difference from plain: {err_abs:.3e} "
        f"(absolute), {err_rel:.3e} of its entry's scale")
    _k45_sharp(real, cfg)

    surf, corner, t_rn, t_qbn = real
    max_d2 = cfg.nearest_feature_search_sq_dist
    pose = assoc.pose_scalars(t_rn, t_qbn, "ieskf")
    entries = []
    for k, (kind, pair) in enumerate(((assoc.SURF, surf),
                                      (assoc.CORNER, corner))):
        sets = (pair, None) if k == 0 else (None, pair)
        ms = device_ms(lambda: assoc.launch(*sets, pose, "ieskf", True,
                                            max_d2, cfg.lidar_scale), 200)
        plain_ms = cuda_ms(lambda: assoc._plain(kind, *pair, pose, "ieskf",
                                                True, max_d2,
                                                cfg.lidar_scale), 5)
        bytes_moved, ops = _k45_work(kind, pair, pose, max_d2)
        bound_ms, bound_by = bound(bytes_moved, ops)
        log(f"  K{4 + k} {kind} ({pair[0].xyz.shape[0]} x "
            f"{pair[1].xyz.shape[0]}, the real VLP-16 trip, weighted): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}; {bytes_moved} B, {ops} ops)")
        entries.append(dict(
            name=f"{kind}_normal_equations", route="cuda",
            source="lins_tpu_torch/csrc/assoc_normal_equations.cu",
            replaces=f"attic/pallas_assoc.py:{293 if k == 0 else 310}",
            launches=None, max_abs_err=err_abs, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    def pair():
        return assoc.launch(surf, corner, pose, "ieskf", True, max_d2,
                            cfg.lidar_scale)

    pair_ms, paced_ms = device_ms(pair, 200), cuda_ms(pair, 200)
    h_surf, h_corner, h_rn, h_qbn = trips["HDL-64"]
    h_pose = assoc.pose_scalars(h_rn, h_qbn, "ieskf")
    h_ms = device_ms(lambda: assoc.launch(
        h_surf, h_corner, h_pose, "ieskf", True,
        cfg_h.nearest_feature_search_sq_dist, cfg_h.lidar_scale), 200)
    log(f"  K4 + K5 on the real HDL-64 trip: {h_ms:.4f} ms on the card")
    trip_ms = cuda_ms(lambda: assoc.scan_normal_equations(
        surf[0], corner[0], surf[1], corner[1], t_rn, t_qbn, 1, cfg,
        "ieskf"), 200)
    log(f"  K4 + K5 in one launch (as the odometry's trips take them): "
        f"{pair_ms:.4f} ms on the card; {paced_ms:.4f} ms a call paced by "
        f"the host's enqueue; a whole trip's entry (pose scalars + launch) "
        f"{trip_ms:.4f} ms")
    check(pair_ms < PREVIOUS_MS["K4+K5 pair"],
          f"K4 + K5 on the real VLP-16 trip faster than the previous design: "
          f"{pair_ms:.4f} < {PREVIOUS_MS['K4+K5 pair']:.4f} ms")
    return entries


def warm_odometry(cfg, data, n_scans):
    """A LinsOdometry on the card fed scans 0..n_scans-1 through add_scan,
    with the IMU up to each; returns it and the next IMU index."""
    from lins_tpu_torch.odometry.estimator import LinsOdometry

    odo = LinsOdometry(cfg)
    imu_i = 0
    for k in range(n_scans):
        t_scan = data["scan_times"][k] + cfg.scan_period
        while (imu_i < len(data["imu_times"])
               and data["imu_times"][imu_i] <= t_scan + 1e-9):
            odo.add_imu(data["imu_times"][imu_i], data["imu_acc"][imu_i],
                        data["imu_gyr"][imu_i])
            imu_i += 1
        odo.add_scan(t_scan, data["scans_xyz"][k], data["scans_n"][k])
    return odo, imu_i


def _reset_counts():
    from lins_tpu_torch.ops import assoc, label, select

    for fn in (label.label_components, label._label_blocked,
               select.select_candidates, select.topk_smallest,
               assoc.surf_normal_equations, assoc.corner_normal_equations):
        fn.launches = 0
    label.label_components.batches = collections.Counter()
    for fn in (label.label_components_plain, label.label_blocked_plain,
               select.select_candidates_plain, select.topk_smallest_plain,
               assoc.surf_normal_equations_plain,
               assoc.corner_normal_equations_plain):
        fn.calls = 0


def _counts():
    from lins_tpu_torch.ops import assoc, label, select

    return dict(label=label.label_components.launches,
                label_batches=dict(label.label_components.batches),
                label_blocked=label._label_blocked.launches,
                label_plain=label.label_components_plain.calls,
                label_blocked_plain=label.label_blocked_plain.calls,
                select=select.select_candidates.launches,
                select_plain=select.select_candidates_plain.calls,
                topk=select.topk_smallest.launches,
                k4=assoc.surf_normal_equations.launches,
                k5=assoc.corner_normal_equations.launches,
                k4_plain=assoc.surf_normal_equations_plain.calls,
                k5_plain=assoc.corner_normal_equations_plain.calls)


def check_assoc(r, n_scans):
    """K4 and K5 took every trip the run's odometry issued, one launch a
    trip of its IESKF and GN spans (the IESKF at least once a RUNNING
    scan), and no plain association ran."""
    counts, trips = r["counts"], r["odometry_trips"]
    check(counts["k4"] == counts["k5"] == trips >= n_scans - 2,
          f"K4 launched {counts['k4']} and K5 {counts['k5']} times = the "
          f"{trips} trips of the odometry's spans >= {n_scans - 2} RUNNING "
          f"scans ({trips / (n_scans - 2):.2f} a scan)")
    check(counts["k4_plain"] == 0 and counts["k5_plain"] == 0,
          "no plain association on the card")


def replay(slam, data, n_scans=None):
    """`slam.run_replay(data, n_scans, chunk=K_CHUNK)`, the user's entry
    point, with its chunks fenced by torch.cuda.synchronize(): chunk 0 (the
    warm chunk) runs in PyTorch's sync debug mode, chunks 1.. are timed as
    bench.py times them (bench_slam with mapping, the odometry loop
    without).  The kernel counts are set to 0 just before the run and read
    just after; the peak memory is the run's, and counts what earlier runs
    still hold (held_bytes, allocated when the run starts).  The run's
    spans are recorded apart.  Returns a dict: wall s, chunk_s, rate
    (scans/s over the timed chunks), syncs and sites (chunk 0's host syncs
    by call site), warm_spans (chunk 0's spans), odometry_trips (the run's),
    counts, kept (the run's `cond` spans kept, by name), peak_bytes,
    held_bytes."""
    import torch

    from lins_tpu_torch.utils import metrics

    inner = slam.run_chunk
    chunk_s, sites = [], collections.Counter()

    def run_chunk(job):
        torch.cuda.synchronize()
        if not run_chunk.warm_done:
            run_chunk.warm_done = True
            run_chunk.warm_from = metrics.RECORDER._last_id
            with count_host_syncs() as s:
                inner(job)
            run_chunk.warm_to = metrics.RECORDER._last_id
            sites.update(s)
            torch.cuda.synchronize()
            return
        t0 = time.perf_counter()
        inner(job)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)

    run_chunk.warm_done = False
    slam.run_chunk = run_chunk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        with record_spans() as spans:
            slam.run_replay(data, n_scans=n_scans, chunk=K_CHUNK)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts()
    finally:
        del slam.run_chunk
    check(chunk_s, "at least one timed chunk after the warm one")
    return dict(wall=wall, chunk_s=chunk_s,
                rate=len(chunk_s) * K_CHUNK / sum(chunk_s),
                syncs=sum(sites.values()), sites=sites,
                warm_spans=[s for s in spans if run_chunk.warm_from < s["id"]
                            <= run_chunk.warm_to],
                odometry_trips=odometry_trips(spans), counts=counts,
                kept=collections.Counter(s["name"] for s in spans
                                         if s["attrs"].get("kept") is True),
                peak_bytes=torch.cuda.max_memory_allocated(),
                held_bytes=held)


def log_run(what, slam, r):
    n = len(slam.trajectory)
    log(f"  run_replay: {n} poses in {r['wall']:.2f} s; launch counts "
        f"{r['counts']}")
    log(f"  {what}: {r['rate']:.3f} scans/s over chunks 1-"
        f"{len(r['chunk_s'])} ({K_CHUNK} scans each; per chunk "
        + ", ".join(f"{s:.3f}" for s in r["chunk_s"]) + " s)")
    log(f"  host syncs in the warm chunk: {r['syncs']}"
        + "".join(f"; {n} at {site}"
                  for site, n in r["sites"].most_common(5)))
    log(f"  peak device memory of the run: {r['peak_bytes'] / 2**20:.1f} "
        f"MiB, {(r['peak_bytes'] - r['held_bytes']) / 2**20:.1f} MiB above "
        f"the {r['held_bytes'] / 2**20:.1f} MiB held when it started")


def log_ate_rmse(what, data, ps, err):
    """Log the reference's own ATE (`slam.ate_rmse`: the ground truth put
    into the estimator's frame, the first scan's end pose, no fit) beside
    the Umeyama-fitted ATE `err` that the gates read."""
    import torch

    from lins_tpu_torch.geom import so3
    from lins_tpu_torch.slam import ate_rmse

    R0 = so3.quat_to_mat(torch.as_tensor(data["gt_quat"][0],
                                         dtype=torch.float64)).numpy()
    no_fit = ate_rmse(ps, data["gt_pos"][1:1 + len(ps)],
                      (R0, data["gt_pos"][0]))
    log(f"  {what}: ATE {err:.4f} m fitted (Umeyama), {no_fit:.4f} m in the "
        f"estimator's frame with no fit (slam.ate_rmse)")
    return no_fit


def _mapping_log(slam):
    metrics = [{k: float(v) for k, v in m.items()}
               for m in slam.mapper.metrics]
    log(f"  {len(metrics)} mapping steps "
        f"({int(sum(m['keyframe_added'] for m in metrics))} keyframes); per "
        "step: iters " + str([int(m["iters"]) for m in metrics])
        + "; matches " + str([int(m["n_matches"]) for m in metrics])
        + "; re-gathers " + str([int(m["n_refresh"]) for m in metrics]))
    check(not any(m["query_overflow"] for m in metrics),
          "no query cap dropped points")
    return metrics


@contextlib.contextmanager
def count_loop_launches():
    """Count the K3 launches made inside each loop attempt (streamed or in
    a chunk: both go through `mapper._loop_step_impl`); yields the list
    they go to."""
    from lins_tpu_torch.mapping import mapper
    from lins_tpu_torch.ops import select

    inner, per_attempt = mapper._loop_step_impl, []

    def loop_step(*args, **kw):
        before = select.select_candidates.launches
        out = inner(*args, **kw)
        per_attempt.append(select.select_candidates.launches - before)
        return out

    mapper._loop_step_impl = loop_step
    try:
        yield per_attempt
    finally:
        mapper._loop_step_impl = inner


def check_loop_launches(in_loops, infos):
    """K3 launched inside each loop attempt that found a candidate (the
    polish of its alignment) and in no other: an attempt with no
    candidate issues no alignment."""
    found = [bool(i["found"]) for i in infos]
    check(len(in_loops) == len(found)
          and all((n > 0) == f for n, f in zip(in_loops, found)),
          f"K3 launched inside the {sum(found)} attempts that found a "
          f"candidate and in none of the other {len(found) - sum(found)}")


def _loop_log(mapper):
    infos = [{k: float(v) for k, v in i.items()} for i in mapper.loop_info]
    log(f"  {len(infos)} loop attempts: found "
        + str([int(i["found"]) for i in infos]) + "; accepted "
        + str([int(i["accepted"]) for i in infos]) + "; applied "
        + str([int(i["applied"]) for i in infos]) + "; fitness "
        + str([round(i["fitness"], 4) for i in infos]) + "; corr_t "
        + str([round(i["corr_t"], 4) for i in infos]))
    return infos


def phase_odometry(cfg, data):
    from lins_tpu_torch.slam import LinsSlam
    from lins_tpu_torch.utils.trajectory import ate

    log("== 4. main path: odometry")
    slam = LinsSlam(cfg, enable_mapping=False)
    r = replay(slam, data)
    log_run("odometry", slam, r)
    counts = r["counts"]
    _, ps, qs = slam.trajectory_arrays()
    n_chunks = (N_SCANS - 2) // K_CHUNK
    check(len(ps) == N_SCANS - 1, "one pose per scan after the first")
    check(counts["label"] >= n_chunks,
          f"K1 launched {counts['label']} times >= {n_chunks} chunks")
    check(counts["label_plain"] == 0 and counts["label_blocked"] == 0,
          "no plain labelling and no K2 at 16 rows")
    check_assoc(r, N_SCANS)
    check(bool(np.isfinite(ps).all() and np.isfinite(qs).all()),
          "every pose finite")
    err = ate(ps, data["gt_pos"][1:1 + len(ps)], align=True)
    check(err <= ATE_LIMIT_M,
          f"odometry ATE {err:.4f} m <= {ATE_LIMIT_M} m ({len(ps)} scans)")
    no_fit = log_ate_rmse("odometry", data, ps, err)
    return dict(r, ate=err, ps=ps, ate_no_fit=no_fit)


def phase_mapping(cfg, data, odo_ps):
    from lins_tpu_torch.slam import LinsSlam
    from lins_tpu_torch.utils.trajectory import ate

    log("== 5. main path: odometry + mapping (recent window, no loop "
        "attempts)")
    slam = LinsSlam(cfg, enable_mapping=True)
    r = replay(slam, data, N_SCANS_WINDOW)
    log_run("SLAM with mapping", slam, r)
    counts = r["counts"]
    _, ps, qs = slam.trajectory_arrays()
    metrics = _mapping_log(slam)
    n_gn = len(metrics) - 1          # every step after the first has a map
    check(len(ps) == N_SCANS_WINDOW - 1,
          "one fused pose per scan after the first")
    check(counts["select"] >= 2 * n_gn,
          f"K3 launched {counts['select']} times >= 2 per mapping step "
          f"against a map ({n_gn} steps; "
          f"{counts['select'] / max(n_gn, 1):.1f} per step)")
    check(counts["select_plain"] == 0, "no plain selection on the card")
    check(counts["label"] > 0 and counts["label_plain"] == 0,
          f"K1 launched {counts['label']} times, no plain labelling")
    check_assoc(r, N_SCANS_WINDOW)
    check_reads(r["sites"], r["warm_spans"], "the warm chunk")
    check(bool(np.isfinite(ps).all() and np.isfinite(qs).all()),
          "every fused pose finite")
    gt = data["gt_pos"][1:1 + len(ps)]
    err = ate(ps, gt, align=True)
    odo_err = ate(odo_ps[:len(ps)], gt, align=True)
    check(err <= odo_err and err <= ATE_LIMIT_M,
          f"fused ATE {err:.4f} m <= odometry ATE {odo_err:.4f} m of the "
          f"same scans and <= {ATE_LIMIT_M} m ({len(ps)} scans)")
    return dict(r, slam=slam, ate=err, ps=ps, metrics=metrics)


def phase_path_v(cfg, data):
    from lins_tpu_torch.slam import LinsSlam
    from lins_tpu_torch.utils.trajectory import ate

    log("== 5. path V: bench.py's main cell, loop attempts on")
    slam = LinsSlam(cfg, enable_mapping=True)
    with count_loop_launches() as in_loops:
        r = replay(slam, data)
    log_run("SLAM with loop attempts", slam, r)
    counts = r["counts"]
    _, ps, qs = slam.trajectory_arrays()
    _mapping_log(slam)
    infos = _loop_log(slam.mapper)
    log(f"  K3 launches inside the attempts: {in_loops}")
    check(len(ps) == N_SCANS - 1, "one fused pose per scan after the first")
    check(len(infos) >= 10, f"{len(infos)} loop attempts at 1 Hz")
    check_loop_launches(in_loops, infos)
    check(counts["select_plain"] == 0 and counts["label_plain"] == 0,
          "no plain selection or labelling on the card")
    check_assoc(r, N_SCANS)
    check_reads(r["sites"], r["warm_spans"], "the warm chunk")
    check(bool(np.isfinite(ps).all() and np.isfinite(qs).all()),
          "every fused pose finite")
    err = ate(ps, data["gt_pos"][1:1 + len(ps)], align=True)
    check(err <= ATE_LIMIT_M,
          f"fused ATE {err:.4f} m <= {ATE_LIMIT_M} m ({len(ps)} scans)")
    no_fit = log_ate_rmse("path V", data, ps, err)
    return dict(r, slam=slam, ate=err, ps=ps, ate_no_fit=no_fit)


@contextlib.contextmanager
def record_selections():
    """Record each radius selection the mapping steps make (the ids
    tensor, left on the card: no host read)."""
    from lins_tpu_torch.mapping import local_map as lmn

    inner, seen = lmn.select_radius, []

    def select_radius(*args):
        out = inner(*args)
        seen.append(out[0])
        return out

    lmn.select_radius = select_radius
    try:
        yield seen
    finally:
        lmn.select_radius = inner


def check_reselected(slam, seen):
    """The radius window changed, and was rebuilt, at least twice: the
    selection is stored only by the rebuild, which runs (is selected) when
    a step's ids differ from the stored ones."""
    import torch

    sel = [s.cpu() for s in seen]
    empty = torch.full_like(sel[0], -1)
    changes = sum(not bool((a == b).all())
                  for a, b in zip([empty] + sel, sel))
    final = slam.mapper.state.lmap.sel.cpu()
    check(changes >= 2 and bool((final == sel[-1]).all()),
          f"the radius selection changed and the window was rebuilt "
          f"{changes} times in {len(sel)} mapping steps; "
          f"{int((final >= 0).sum())} keyframes selected at the end")
    return changes


def phase_path_r(cfg, data, odo_ps):
    from lins_tpu_torch.slam import LinsSlam
    from lins_tpu_torch.utils.trajectory import ate

    log("== 5. path R: the radius-selected map, loop closure off "
        "(run_slam.py --no-loop-closure)")
    slam = LinsSlam(cfg, enable_mapping=True)
    with record_selections() as seen:
        r = replay(slam, data, N_SCANS_WINDOW)
    log_run("SLAM over the radius map", slam, r)
    counts = r["counts"]
    _, ps, qs = slam.trajectory_arrays()
    metrics = _mapping_log(slam)
    n_gn = len(metrics) - 1
    changes = check_reselected(slam, seen)
    check(len(ps) == N_SCANS_WINDOW - 1,
          "one fused pose per scan after the first")
    check(not slam.mapper.loop_info, "no loop attempt with loop closure off")
    check(counts["select"] >= 2 * n_gn and counts["select_plain"] == 0,
          f"K3 launched {counts['select']} times >= 2 per mapping step "
          f"against a map ({n_gn} steps), no plain selection")
    check(counts["label"] > 0 and counts["label_plain"] == 0
          and counts["label_blocked"] == 0,
          f"K1 launched {counts['label']} times, no plain labelling")
    check_assoc(r, N_SCANS_WINDOW)
    check_reads(r["sites"], r["warm_spans"], "the warm chunk")
    check(bool(np.isfinite(ps).all() and np.isfinite(qs).all()),
          "every fused pose finite")
    gt = data["gt_pos"][1:1 + len(ps)]
    err = ate(ps, gt, align=True)
    odo_err = ate(odo_ps[:len(ps)], gt, align=True)
    check(err <= odo_err and err <= ATE_LIMIT_M,
          f"fused ATE {err:.4f} m <= odometry ATE {odo_err:.4f} m of the "
          f"same scans and <= {ATE_LIMIT_M} m ({len(ps)} scans)")
    return dict(r, slam=slam, ate=err, ps=ps, metrics=metrics,
                changes=changes)


def store_mesh(n):
    """A mesh of n parts of the one card."""
    import torch

    from lins_tpu_torch.parallel.multihost import Mesh

    return Mesh([torch.device("cuda", 0)] * n)


def phase_path_h(cfg, data, what="path H", ref_ate=REF_FUSED_ATE_H_M,
                 shards=0):
    """Path H's run and gates; with `shards` the mapper's keyframe store is
    split over that many parts of the card before the run."""
    from lins_tpu_torch.slam import LinsSlam
    from lins_tpu_torch.utils.trajectory import ate

    log(f"== 5. {what}: HDL-64 full SLAM on the revisiting circuit"
        + (", the radius-selected map" if cfg.lc_map_mode == "radius"
           else "")
        + (f", the store over {shards} parts of the card" if shards else ""))
    slam = LinsSlam(cfg, enable_mapping=True)
    if shards:
        slam.mapper.shard_store_over(store_mesh(shards))
    with count_loop_launches() as in_loops:
        r = replay(slam, data)
    log_run("HDL-64 SLAM with loop closure", slam, r)
    counts = r["counts"]
    _, ps, qs = slam.trajectory_arrays()
    metrics = _mapping_log(slam)
    infos = _loop_log(slam.mapper)
    log(f"  K3 launches inside the attempts: {in_loops}")
    st = slam.mapper.state
    n_kf, n_loops = int(st.store.count), int(st.n_loops)
    n_edges = int(st.edges.count)
    n_chunks = (N_SCANS_H - 2) // K_CHUNK
    n_tail = N_SCANS_H - 2 - n_chunks * K_CHUNK
    check(len(ps) == N_SCANS_H - 1, "one fused pose per scan after the first")
    check(counts["label_blocked"] >= n_chunks + n_tail,
          f"K2 launched {counts['label_blocked']} times >= {n_chunks} "
          f"chunks + {n_tail} streamed RUNNING scans")
    check(counts["label"] == 0 and counts["label_plain"] == 0
          and counts["label_blocked_plain"] == 0,
          "no K1 and no plain labelling at 64 rows")
    check_assoc(r, N_SCANS_H)
    check(counts["select"] > 0 and counts["select_plain"] == 0,
          f"K3 launched {counts['select']} times, no plain selection")
    check_loop_launches(in_loops, infos)
    check_reads(r["sites"], r["warm_spans"], "the warm chunk")
    accepted = [i for i in infos if i["accepted"]]
    check(n_loops >= 1 and len(accepted) == n_loops
          and all(i["fitness"] < 0.3 for i in accepted),
          f"{n_loops} loops closed, every accepted fitness < 0.3")
    check(n_edges == n_kf - 1 + n_loops,
          f"{n_edges} edges = {n_kf} keyframes - 1 + {n_loops} loops")
    check(bool(np.isfinite(ps).all() and np.isfinite(qs).all()),
          "every fused pose finite")
    err = ate(ps, data["gt_pos"][1:1 + len(ps)], align=True)
    lim = ref_ate + ATE_MARGIN_H_M
    check(err <= lim,
          f"fused ATE {err:.4f} m <= the JAX package's {ref_ate:.4f}"
          f" m + {ATE_MARGIN_H_M} m ({len(ps)} scans)")
    no_fit = log_ate_rmse(what, data, ps, err)
    return dict(r, slam=slam, ate=err, ate_no_fit=no_fit, ps=ps, qs=qs,
                metrics=metrics,
                n_loops=n_loops, n_kf=n_kf, n_edges=n_edges,
                in_loops=in_loops)


def loop_profiles(slam):
    """One loop-closure attempt and one pose-graph solve on the final state
    of path H, each under the profiler (nothing is written back).  Returns
    the two profiles and their outputs: ((new state, info), (pos, quat))."""
    import torch

    from lins_tpu_torch.graph import pose_graph as pg
    from lins_tpu_torch.mapping import keyframes as kf
    from lins_tpu_torch.mapping.mapper import _loop_step_impl

    m = slam.mapper
    st = m.state
    t = torch.full((), float(slam.trajectory[-1][0]), dtype=m.dtype,
                   device=m.device)
    prof, attempt = profile_call(lambda: _loop_step_impl(
        st, t, m.cfg, m.submap_cap, m.cloud_cap, 8, m.n_window, m.gp))
    info = attempt[1]
    log_profile(f"one loop-closure attempt (found {int(info['found'])}, "
                f"accepted {int(info['accepted'])})", prof)
    store = st.store
    K = store.capacity
    ev = pg.live_view(st.edges, store.count, K)
    prior = torch.remainder(torch.clamp(store.count - K, min=0), K)
    solve, solved = profile_call(lambda: pg.optimize(
        store.pos, store.quat, kf.live_mask(store), ev, 8, prior_slot=prior,
        huber_delta=m.cfg.pg_loop_huber))
    log_profile(f"one pose-graph solve (8 iterations, {K} slots, "
                f"{int(store.count)} keyframes)", solve)
    return prof, solve, attempt, solved


def shard_profiles(slams):
    """One mapping step and one loop-closure attempt on the final state of
    each (name, slam), under the profiler (nothing is written back):
    the launches and busy time a sharded store adds."""
    import torch

    from lins_tpu_torch.mapping.mapper import (_loop_step_impl,
                                               _mapping_step_impl)

    out = {}
    for name, slam in slams:
        m, args = _mapping_inputs(slam)
        st = m.state
        step, _ = profile_call(lambda: _mapping_step_impl(
            st, *args, m.cfg, *m.caps, m.n_window, m.gp, True))
        log_profile(f"{name}: one mapping step", step)
        t = torch.full((), float(slam.trajectory[-1][0]), dtype=m.dtype,
                       device=m.device)
        attempt, _ = profile_call(lambda: _loop_step_impl(
            st, t, m.cfg, m.submap_cap, m.cloud_cap, 8, m.n_window, m.gp))
        log_profile(f"{name}: one loop-closure attempt", attempt)
        out[name] = dict(step=step, attempt=attempt)
    return out


def phase_profiles(cfg, data, map_slam, h_slam):
    log("== 6. profiles (after every timing)")
    odo, _ = warm_odometry(cfg, data, WARMUP_SCANS - 1)
    k = WARMUP_SCANS - 1
    t_scan = data["scan_times"][k] + cfg.scan_period
    prof, _ = profile_call(lambda: odo.add_scan(
        t_scan, data["scans_xyz"][k], data["scans_n"][k]))
    log_profile("one RUNNING add_scan", prof)
    stage_breakdown(odo, data["scans_xyz"][WARMUP_SCANS],
                    data["scans_n"][WARMUP_SCANS])
    mapping_stage_breakdown(map_slam)
    return loop_profiles(h_slam)


def _cpu64(tree):
    """A float64 CPU copy of a state container of card tensors."""
    import torch

    from lins_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x.detach().cpu().to(torch.float64)
                    if x.is_floating_point() else x.detach().cpu(), tree)


def _quat_gap(a, b):
    """Largest rotation angle in radians between two stacks of quaternions,
    each normalised: 4 asin(|a - b| / 2) with b's sign nearer a (arccos of
    the dot product is ill-conditioned at small angles)."""
    a, b = (np.asarray(x, float) / np.linalg.norm(x, axis=-1, keepdims=True)
            for x in (a, b))
    b = np.where(np.sum(a * b, -1, keepdims=True) < 0, -b, b)
    chord = np.clip(np.linalg.norm(a - b, axis=-1) / 2, 0.0, 1.0)
    return float(np.max(4 * np.arcsin(chord), initial=0.0))


def phase_k3_loop(slam, C):
    """K3 against its plain version at the shapes the loop attempt gives
    it, on real gathers: path H's final state, its current keyframe's cloud
    moved by ICP onto the loop candidate's submap, gathered from the
    polish's grid (graph/loop_closure.polish_grid), surf queries and the
    polish's eight invalid corner queries, bit for bit for both d2C rules;
    the surf gather's times beside the previous route's.  Returns the
    largest difference of kept distances."""
    import torch

    from lins_tpu_torch.geom import so3
    from lins_tpu_torch.graph import loop_closure as lc

    log("== 6. K3 on the loop polish's real gathers (path H's final state)")
    m = slam.mapper
    cfg, store = m.cfg, m.state.store
    t = torch.full((), float(slam.trajectory[-1][0]), dtype=m.dtype,
                   device=m.device)
    cur = torch.clamp(store.count - 1, min=0)
    idx, found = lc.detect_loop(store, cur, t, cfg)
    check(bool(found), f"the final keyframe {int(cur)} has a loop candidate "
          f"({int(idx)})")
    submap, sub_ok, cloud, cloud_ok = lc.loop_clouds(
        store, idx, cur, t, cfg, m.submap_cap, m.cloud_cap)
    R, tt, _ = lc.icp_align(cloud, cloud_ok, submap, sub_ok,
                            iters=cfg.loop_icp_iters,
                            max_corr=cfg.loop_icp_max_corr)
    src = so3.quat_rotate(so3.mat_to_quat(R)[None, :], cloud) + tt[None, :]
    grid = lc.polish_grid(submap, sub_ok)
    corner = torch.zeros((8, 3), dtype=m.dtype, device=m.device)
    err = 0.0
    for what, q, q_ok in (
            ("surf", src, cloud_ok),
            ("corner", corner, torch.zeros(8, dtype=torch.bool,
                                           device=m.device))):
        args = _k3_args(q, q_ok, grid)
        shape = (*args[2].shape, *args[3].shape[1:])
        check(shape == (q.shape[0], 27, 3, 64),
              f"the polish's {what} gather reads {shape[0]} rows of "
              f"{shape[1]} buckets of {shape[2]} x {shape[3]}")
        err = max(err, _k3_equal(args, C, f"the loop polish's {what} gather "
                                 f"({int(q_ok.sum())} valid queries)"))
        if what == "surf":
            k3_times(args, C, "the loop polish's real surf gather",
                     PREVIOUS_K3_PARTS_MS["polish surf"])
    return err


def phase_loop_cpu_check(slam, attempt, solved):
    """Path H's final state, card float32 against a CPU float64 copy: the
    profiled loop attempt, the profiled pose-graph solve, and then
    LinsMapper.final_solve (solve, pose rewrite, window rebuild) on the
    card against the same on the CPU."""
    import torch

    from lins_tpu_torch.graph import pose_graph as pg
    from lins_tpu_torch.mapping import keyframes as kf
    from lins_tpu_torch.mapping.mapper import (_final_solve_impl,
                                               _loop_step_impl)

    log("== 7. CPU cross-check: path H's loop attempt and pose-graph solve")
    t0 = time.perf_counter()
    m = slam.mapper
    cfg, st = m.cfg, m.state
    cpu = _cpu64(st)
    t = torch.full((), float(slam.trajectory[-1][0]), dtype=torch.float64)
    new_c, info_c = _loop_step_impl(cpu, t, cfg, m.submap_cap, m.cloud_cap,
                                    8, m.n_window, m.gp)
    new_g, info_g = attempt
    flags = ("found", "accepted", "applied", "matched")
    got = {k: int(info_g[k]) for k in flags}
    want = {k: int(info_c[k]) for k in flags}
    log(f"  attempt: card {got}, fitness {float(info_g['fitness']):.6f}, "
        f"corr_t {float(info_g['corr_t']):.6f} m; CPU {want}, fitness "
        f"{float(info_c['fitness']):.6f}, corr_t "
        f"{float(info_c['corr_t']):.6f} m")
    check(got == want and got["found"] == 1,
          "found, accepted, applied and the matched id equal, a loop found")
    check(int(new_g.n_loops) == int(new_c.n_loops)
          and int(new_g.edges.count) == int(new_c.edges.count),
          f"{int(new_g.n_loops)} loops and {int(new_g.edges.count)} edges "
          f"after the attempt on both")
    fit_g, fit_c = float(info_g["fitness"]), float(info_c["fitness"])
    check(abs(fit_g - fit_c) <= LOOP_FIT_TOL * fit_c,
          f"fitness {fit_g:.6f} within {LOOP_FIT_TOL:.0%} of {fit_c:.6f}")
    e = int(new_c.edges.count) - 1
    dt_m = float(np.abs(new_g.edges.t[e].cpu().numpy()
                        - new_c.edges.t[e].numpy()).max())
    dq = _quat_gap(new_g.edges.q[e].cpu().numpy()[None],
                   new_c.edges.q[e].numpy()[None])
    dc = abs(float(info_g["corr_t"]) - float(info_c["corr_t"]))
    check(dt_m <= LOOP_CPU_TOL_M and dc <= LOOP_CPU_TOL_M
          and dq <= LOOP_CPU_TOL_RAD,
          f"the attempt's edge: t_rel {dt_m:.6f} m, corr_t {dc:.6f} m <= "
          f"{LOOP_CPU_TOL_M} m, q_rel {dq:.6f} rad <= {LOOP_CPU_TOL_RAD} rad")

    store = cpu.store
    K = store.capacity
    live = kf.live_mask(store).numpy()
    ev = pg.live_view(cpu.edges, store.count, K)
    prior = torch.remainder(torch.clamp(store.count - K, min=0), K)
    pos_c, quat_c = pg.optimize(store.pos, store.quat, kf.live_mask(store),
                                ev, 8, prior_slot=prior,
                                huber_delta=cfg.pg_loop_huber)
    pos_g, quat_g = (x.cpu().double().numpy() for x in solved)
    pos_c, quat_c = pos_c.numpy()[live], quat_c.numpy()
    moved = float(np.abs(pos_c - store.pos.numpy()[live]).max())
    dp = float(np.abs(pos_g[live] - pos_c).max())
    dq = _quat_gap(quat_g[live], quat_c[live])
    check(bool(np.isfinite(pos_g[live]).all()) and dp <= SOLVE_CPU_TOL_M
          and dq <= SOLVE_CPU_TOL_RAD,
          f"pose-graph solve ({int(live.sum())} keyframes, moved up to "
          f"{moved:.6f} m): card vs CPU positions {dp:.2e} m <= "
          f"{SOLVE_CPU_TOL_M} m, rotations {dq:.2e} rad <= "
          f"{SOLVE_CPU_TOL_RAD} rad")

    m.final_solve()
    fin_c = _final_solve_impl(cpu, cfg, 8, m.n_window, m.gp)
    pos_g = m.state.store.pos.cpu().double().numpy()[live]
    pos_f = fin_c.store.pos.numpy()[live]
    moved = float(np.abs(pos_f - store.pos.numpy()[live]).max())
    dp = float(np.abs(pos_g - pos_f).max())
    check(bool(np.isfinite(pos_g).all()) and moved > 0
          and dp <= SOLVE_CPU_TOL_M,
          f"LinsMapper.final_solve kept the solve (moved up to {moved:.6f} "
          f"m): card vs CPU keyframe positions {dp:.2e} m <= "
          f"{SOLVE_CPU_TOL_M} m")
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return dp


def phase_cpu_check(cfg, data, card_ps):
    import torch

    from lins_tpu_torch.slam import LinsSlam

    log("== 7. CPU cross-check: odometry")
    t0 = time.perf_counter()
    slam = LinsSlam(cfg, enable_mapping=False, device="cpu",
                    dtype=torch.float64)
    slam.run_replay(data, n_scans=CPU_CHECK_SCANS,
                    chunk=CPU_CHECK_SCANS - 2)
    _, ps, _ = slam.trajectory_arrays()
    n = len(ps)
    diff = float(np.abs(card_ps[:n] - ps).max())
    log(f"  {n} poses on the CPU in {time.perf_counter() - t0:.1f} s")
    check(n == CPU_CHECK_SCANS - 1 and diff <= CPU_CHECK_LIMIT_M,
          f"card float32 vs CPU float64 positions: max {diff:.6f} m <= "
          f"{CPU_CHECK_LIMIT_M} m over {n} scans")
    return diff


def phase_cpu_map_check(what, cfg, data, card_ps, card_metrics):
    import torch

    from lins_tpu_torch.slam import LinsSlam

    log(f"== 7. CPU cross-check: {what}")
    t0 = time.perf_counter()
    slam = LinsSlam(cfg, enable_mapping=True, device="cpu",
                    dtype=torch.float64)
    slam.run_replay(data, n_scans=CPU_CHECK_SCANS,
                    chunk=CPU_CHECK_SCANS - 2)
    _, ps, _ = slam.trajectory_arrays()
    n = len(ps)
    diff = float(np.abs(card_ps[:n] - ps).max())
    cpu_m = [int(m["n_matches"]) for m in slam.mapper.metrics]
    card_m = [int(m["n_matches"]) for m in card_metrics[:len(cpu_m)]]
    log(f"  {n} fused poses, {len(cpu_m)} mapping steps on the CPU in "
        f"{time.perf_counter() - t0:.1f} s; matches card {card_m}, CPU "
        f"{cpu_m}")
    check(n == CPU_CHECK_SCANS - 1 and diff <= MAP_CPU_POS_TOL_M,
          f"card float32 vs CPU float64 fused positions: max {diff:.6f} m "
          f"<= {MAP_CPU_POS_TOL_M} m over {n} scans (the reference's "
          f"cross-backend gate)")
    rel = max((abs(a - b) / max(b, 1) for a, b in zip(card_m, cpu_m)),
              default=math.inf)
    check(len(cpu_m) >= 2 and sum(cpu_m) > 0 and rel <= MAP_CPU_MATCH_TOL,
          f"per-step matches within {MAP_CPU_MATCH_TOL:.0%} (largest "
          f"{rel:.4f}; the reference's cross-backend gate)")
    return diff, rel


def phase_hr_final_solve(slam):
    """LinsMapper.final_solve on path H-radius's final state, on the card:
    the solve over every edge (the add-only loop edges included) and the
    current radius selection rebuilt at the corrected poses."""
    m = slam.mapper
    before = m.state.store.pos.clone()
    sel = m.state.lmap.sel.clone()
    t0 = time.perf_counter()
    m.final_solve()
    pos = m.state.store.pos
    live = (m.state.store.kf_id >= 0).cpu().numpy()
    moved = float((pos - before).abs().max())
    check(bool(np.isfinite(pos.cpu().numpy()[live]).all()) and moved > 0
          and bool((m.state.lmap.sel == sel).all()),
          f"final_solve over the radius map: keyframes moved up to "
          f"{moved:.6f} m, finite, the selection of "
          f"{int((sel >= 0).sum())} keyframes rebuilt "
          f"({time.perf_counter() - t0:.2f} s)")


def phase_runner():
    """`python -m lins_tpu_torch.run_slam` on the card, as a user runs it:
    a radius run with checkpoints, then a run resumed from the first
    checkpoint.  Each exits 0 and writes every output; the summary has the
    JAX package's runner's keys, trajectory.tum one row a scan with a pose,
    the ATE within ATE_LIMIT_M."""
    log("== 8. the runner: python -m lins_tpu_torch.run_slam")
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "chiprun_out", "runner")
    ckpt = os.path.join(out, f"ckpt_{RUNNER_CKPT:05d}.npz")
    cmd = [sys.executable, "-m", "lins_tpu_torch.run_slam", "--synthetic",
           "gentle", "--scans", str(RUNNER_SCANS), "--no-loop-closure",
           "--checkpoint-every", str(RUNNER_CKPT), "--map-format", "ply"]
    runs = (("a radius run", out, [], RUNNER_SCANS - 1,
             {f"ckpt_{k:05d}.npz"
              for k in range(RUNNER_CKPT, RUNNER_SCANS + 1, RUNNER_CKPT)}),
            ("the run resumed at scan " + str(RUNNER_CKPT), out + "_resume",
             ["--resume", ckpt], RUNNER_SCANS - RUNNER_CKPT,
             {f"ckpt_{RUNNER_SCANS:05d}.npz"}))
    summaries = []
    for what, d, extra, rows, ckpts in runs:
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        p = subprocess.run(cmd + extra + ["--out", d], cwd=root,
                           capture_output=True, text=True,
                           timeout=RUNNER_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if p.returncode:
            log(p.stdout[-3000:] + p.stderr[-3000:])
        check(p.returncode == 0, f"{what}: exit 0 ({wall:.1f} s)")
        files = set(os.listdir(d))
        check(RUNNER_OUTPUTS | ckpts == files,
              f"{what}: wrote {sorted(files)}")
        with open(os.path.join(d, "summary.json")) as f:
            summary = json.load(f)
        check(set(summary) == RUNNER_SUMMARY_KEYS
              and json.loads(p.stdout.strip().splitlines()[-1]) == summary,
              f"{what}: the summary has the JAX runner's keys, printed and "
              f"written")
        with open(os.path.join(d, "trajectory.tum")) as f:
            n = sum(1 for _ in f)
        check(n == rows == summary["scans"],
              f"{what}: trajectory.tum has {n} rows, one a scan with a pose")
        check(summary["ate_rmse_m"] <= ATE_LIMIT_M,
              f"{what}: ATE {summary['ate_rmse_m']} m <= {ATE_LIMIT_M} m")
        log(f"  {what}: {summary}")
        summaries.append(summary)
    # the checkpoints and state dumps (about 50 MB each at VLP-16 size)
    # are checked; they are not kept
    for d in (out, out + "_resume"):
        for name in sorted(os.listdir(d)):
            if name.endswith(".npz"):
                path = os.path.join(d, name)
                log(f"  {os.path.relpath(path, root)}: "
                    f"{os.path.getsize(path) / 2**20:.1f} MiB (removed)")
                os.unlink(path)
    return summaries


def phase_path_e(cfg, data, window_rate):
    """The window path in the exact feature mode: the odometry and fused
    ATEs of the same run, the gates of the window path, no host sync."""
    from lins_tpu_torch.slam import LinsSlam
    from lins_tpu_torch.utils.trajectory import ate

    log("== 5. path E: the window map in the exact feature mode (the "
        "reference's greedy picking)")
    slam = LinsSlam(cfg, enable_mapping=True)
    r = replay(slam, data, N_SCANS_WINDOW)
    log_run("SLAM in the exact mode", slam, r)
    counts = r["counts"]
    _, ps, qs = slam.trajectory_arrays()
    _, odo_ps, _ = slam.odometry.trajectory_arrays()
    metrics = _mapping_log(slam)
    n_gn = len(metrics) - 1
    check(len(ps) == N_SCANS_WINDOW - 1 and len(odo_ps) == len(ps),
          "one odometry and one fused pose per scan after the first")
    check(counts["select"] >= 2 * n_gn and counts["select_plain"] == 0,
          f"K3 launched {counts['select']} times >= 2 per mapping step "
          f"against a map ({n_gn} steps), no plain selection")
    check(counts["label"] > 0 and counts["label_plain"] == 0,
          f"K1 launched {counts['label']} times, no plain labelling")
    check_assoc(r, N_SCANS_WINDOW)
    check_reads(r["sites"], r["warm_spans"], "the warm chunk")
    check(bool(np.isfinite(ps).all() and np.isfinite(qs).all()),
          "every fused pose finite")
    gt = data["gt_pos"][1:1 + len(ps)]
    odo_err = ate(odo_ps, gt, align=True)
    err = ate(ps, gt, align=True)
    check(odo_err <= ATE_LIMIT_M,
          f"odometry ATE {odo_err:.4f} m <= {ATE_LIMIT_M} m ({len(ps)} "
          f"scans)")
    lim = REF_FUSED_ATE_E_M + ATE_MARGIN_H_M
    check(err <= odo_err and err <= lim,
          f"fused ATE {err:.4f} m <= the odometry ATE {odo_err:.4f} m of "
          f"the same run and <= the JAX package's {REF_FUSED_ATE_E_M:.4f} m"
          f" + {ATE_MARGIN_H_M} m")
    log(f"  {r['rate']:.3f} scans/s in the exact mode against the window "
        f"path's {window_rate:.3f} (fast mode) in this call "
        f"({r['rate'] / window_rate:.3f}x)")
    return dict(r, slam=slam, ate=err, odo_ate=odo_err, ps=ps,
                metrics=metrics)


def phase_exact_labels(cfg, data):
    """The exact mode's labels on the card against the port's CPU float32
    labels on the first scans.  Gate: the greedy picking (`extract_rings`)
    of the card's segmented scan equals the CPU's picking of the same scan
    copied over.  Logged: the whole front end from the raw points on both,
    with the picks that differ counted and, where they do, the first input
    of the picking that differed.  Gate: every scan whose labels differ
    has a projection cell that differs, and the differing labels are at
    most `EXACT_E2E_MAX_SHARE` of the CPU's picks."""
    import torch

    from lins_tpu_torch.frontend import features as F
    from lins_tpu_torch.frontend.pipeline import frontend_post, frontend_pre
    from lins_tpu_torch.ops.label import label_components

    log(f"== 7. exact-mode labels, card vs CPU float32 (first "
        f"{EXACT_LABEL_SCANS} scans)")

    def seg_of(xyz, n):
        pre = frontend_pre(xyz, n, cfg)
        labels = label_components(pre["e_right"], pre["e_down"],
                                  pre["eligible"])
        return frontend_post(labels, pre, cfg)[0]

    picks, diff_e2e, notes = 0, 0, []
    for k in range(EXACT_LABEL_SCANS):
        xyz = np.asarray(data["scans_xyz"][k], np.float32)
        n = int(data["scans_n"][k])
        seg_g = seg_of(torch.as_tensor(xyz, device="cuda"),
                       torch.tensor(n, dtype=torch.int32, device="cuda"))
        lab_g = F.extract_rings(seg_g, cfg)[0].cpu()
        seg_c = type(seg_g)(*(x.cpu() for x in seg_g))
        lab_same = F.extract_rings(seg_c, cfg)[0]
        check(bool((lab_g == lab_same).all()),
              f"scan {k}: the card's greedy picks equal the CPU's on the "
              f"same segmented scan ({int((lab_g != 0).sum())} picks)")
        seg_cpu = seg_of(torch.as_tensor(xyz),
                         torch.tensor(n, dtype=torch.int32))
        lab_cpu = F.extract_rings(seg_cpu, cfg)[0]
        picks += int((lab_cpu != 0).sum())
        d = int((lab_g != lab_cpu).sum())
        diff_e2e += d
        if d:
            cells, note = _first_difference(xyz, n, cfg)
            notes.append(f"scan {k}: {d} labels differ; {note}")
            check(cells > 0, f"scan {k}: the {d} differing labels follow "
                  f"{cells} projection cells that differ")
    log(f"  the whole front end from the raw points: {diff_e2e} of "
        f"{picks} CPU picks differ on the card"
        + "".join(f"; {t}" for t in notes))
    check(diff_e2e <= EXACT_E2E_MAX_SHARE * picks,
          f"the whole front end: {diff_e2e} differing labels <= "
          f"{EXACT_E2E_MAX_SHARE} x {picks} picks")
    return diff_e2e, picks


def _first_difference(xyz, n, cfg):
    """Where the front end's inputs to the picking first differ between the
    card and the CPU on one raw scan: the projection's outputs cell by
    cell (the winning point of each cell, its range in ulps).  Returns the
    number of cells that differ and a note naming them."""
    import torch

    from lins_tpu_torch.frontend import projection as P

    def proj(dev):
        out = P.project(torch.as_tensor(xyz, device=dev),
                        torch.tensor(n, dtype=torch.int32, device=dev), cfg)
        return [x.cpu() for x in out[:3]]

    (xg, rg, vg), (xc, rc, vc) = proj("cuda"), proj("cpu")
    same_pt = (xg == xc).all(-1) & vg & vc
    moved = int((vg != vc).sum() + (~(xg == xc).all(-1) & vg & vc).sum())
    rd = (rg != rc) & same_pt
    ulps = ((rg.view(torch.int32) - rc.view(torch.int32)).abs()[rd]
            if bool(rd.any()) else torch.zeros(1, dtype=torch.int32))
    return moved + int(rd.sum()), (
        f"projection: {moved} cells with another winning point, "
        f"{int(rd.sum())} cells whose range (sqrt of the same point's "
        f"float32 squared norm) differs, by up to {int(ulps.max())} ulp")


@contextlib.contextmanager
def count_solves():
    """Count the mapper's pose-graph solves by kind: `pose_graph.optimize`
    (dense) and `optimize_cg` (sparse), looked up on the module."""
    from lins_tpu_torch.graph import pose_graph as pg

    calls = collections.Counter()
    inner = {name: getattr(pg, name) for name in ("optimize", "optimize_cg")}

    def counted(name):
        def solve(*args, **kw):
            calls[name] += 1
            return inner[name](*args, **kw)
        return solve

    for name in inner:
        setattr(pg, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in inner.items():
            setattr(pg, name, fn)


def _store_bytes(store):
    """The store's bytes on the card, a sharded field's parts included."""
    return sum(x.numel() * x.element_size()
               for f in store for x in getattr(f, "parts", [f])
               if hasattr(x, "numel"))


def phase_path_hs(cfg, data, shards=0):
    """Path H with 2048 keyframe slots: every solve a loop attempt keeps
    goes through optimize_cg (phase 6 times one on the final state)."""
    with count_solves() as solves:
        r = phase_path_h(cfg, data,
                         "path HS-shard" if shards else "path H-sparse",
                         REF_FUSED_ATE_HS_M, shards)
    store = r["slam"].mapper.state.store
    K = store.capacity
    nbytes = _store_bytes(store)
    log(f"  the keyframe store: {K} slots, {nbytes / 2**20:.1f} MiB "
        f"({nbytes / K / 1e3:.1f} kB a keyframe)")
    kept = r["kept"]["loop.solve"]
    log(f"  solves during the run: {dict(solves)}; loop.solve kept {kept}"
        " times")
    check(K == 2048 and solves["optimize_cg"] == kept
          and solves["optimize"] == 0,
          f"{solves['optimize_cg']} sparse solves (optimize_cg), one a kept "
          f"loop.solve, and no dense one above 1024 slots")
    return dict(r, store_bytes=nbytes, solves=dict(solves))


def phase_path_hs_shard(cfg, data, hs):
    """Path H-sparse with its keyframe store split over STORE_SHARDS parts
    of the card: path H-sparse's gates, and against path H-sparse's run in
    this call the same loops, keyframes and edges and every fused pose
    within SHARD_POS_TOL_M; no host sync in the warm chunk; each cloud
    field in STORE_SHARDS parts of K / STORE_SHARDS rows."""
    from lins_tpu_torch.parallel.shard_map_store import (SHARDED_FIELDS,
                                                         ShardedRows)

    r = phase_path_hs(cfg, data, STORE_SHARDS)
    store = r["slam"].mapper.state.store
    R = store.capacity // STORE_SHARDS
    fields = [getattr(store, f) for f in SHARDED_FIELDS]
    shard_mib = sum(a.parts[0].numel() * a.parts[0].element_size()
                    for a in fields) / 2**20
    check(all(isinstance(a, ShardedRows)
              and [p.shape[0] for p in a.parts] == [R] * STORE_SHARDS
              for a in fields),
          f"each cloud field in {STORE_SHARDS} parts of {R} rows, "
          f"{shard_mib:.1f} MiB a shard")
    got = (r["n_loops"], r["n_kf"], r["n_edges"])
    want = (hs["n_loops"], hs["n_kf"], hs["n_edges"])
    check(got == want, f"loops, keyframes, edges {got} = path H-sparse's "
          f"{want}")
    dp = float(np.abs(r["ps"] - hs["ps"]).max())
    dq = float(np.abs(np.sum(r["qs"] * hs["qs"], axis=1)).min())
    n_equal = int(np.all(r["ps"] == hs["ps"], axis=1).sum())
    check(r["ps"].shape == hs["ps"].shape and dp <= SHARD_POS_TOL_M
          and dq >= 1 - SHARD_QUAT_TOL,
          f"every fused pose within {dp:.3e} m <= {SHARD_POS_TOL_M} m of "
          f"path H-sparse's, quaternion |dot| >= {dq:.9f} (>= 1 - "
          f"{SHARD_QUAT_TOL}); {n_equal} of {len(r['ps'])} positions equal "
          f"bit for bit")
    check_reads(r["sites"], r["warm_spans"], "the warm chunk")
    log(f"  {r['rate']:.3f} scans/s against path H-sparse's "
        f"{hs['rate']:.3f} ({r['rate'] / hs['rate']:.3f}x); peak above the "
        f"run's start {(r['peak_bytes'] - r['held_bytes']) / 2**20:.1f} MiB "
        f"against {(hs['peak_bytes'] - hs['held_bytes']) / 2**20:.1f}")
    return dict(r, max_pose_diff=dp, min_quat_dot=dq, n_equal=n_equal,
                shard_mib=shard_mib)


def _seam_store(store, count, seed):
    """`store` filled directly on its device with seeded rows as if `count`
    keyframes had been added: slot s holds the newest id below `count`
    that is s modulo K, poses in a 40 m box, clouds in a 20 m box with 90%
    of the points valid."""
    import torch

    K, dev = store.capacity, store.count.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev,
                          dtype=store.pos.dtype)

    slots = torch.arange(K, device=dev)
    ids = slots + K * torch.div(count - 1 - slots, K, rounding_mode="floor")
    q = torch.randn((K, 4), generator=g, device=dev, dtype=store.pos.dtype)
    clouds = {}
    for f in ("corner", "surf", "outlier"):
        shape = tuple(getattr(store, f).shape)
        clouds[f] = (rand(*shape) - 0.5) * 20.0
        clouds[f + "_valid"] = rand(*shape[:2]) < 0.9
    return store._replace(
        pos=(rand(K, 3) - 0.5) * 40.0,
        quat=q / torch.linalg.vector_norm(q, dim=1, keepdim=True),
        time=0.1 * ids.to(store.pos.dtype), kf_id=ids.to(torch.int32),
        count=torch.tensor(count, dtype=torch.int32, device=dev), **clouds)


def _tree_equal(a, b):
    """Whether every tensor of two containers is equal bit for bit."""
    import torch

    from lins_tpu_torch.utils.tree import tree_map

    xs, ys = [], []
    tree_map(xs.append, a)
    tree_map(ys.append, b)
    return len(xs) == len(ys) > 0 and all(
        x.dtype == y.dtype and bool(torch.equal(x, y)) for x, y in zip(xs, ys))


def phase_store_seams(cfg):
    """The sharded store's gathers at full width across its seams: a
    2048-slot store at path H-sparse's caps, filled past the ring's wrap
    (SEAM_COUNT), sharded over STORE_SHARDS parts of the card; for windows
    ending at each of SEAM_CENTERS, `assemble_local_map`, `rebuild_window`
    and `loop_clouds` equal the unsharded ones bit for bit."""
    import torch

    from lins_tpu_torch.graph import loop_closure as lc
    from lins_tpu_torch.mapping import keyframes as kf
    from lins_tpu_torch.mapping import local_map as lmn
    from lins_tpu_torch.mapping.mapper import LinsMapper
    from lins_tpu_torch.parallel.shard_map_store import shard_store

    log(f"== 5. the sharded store's seams at full width ({STORE_SHARDS} "
        f"parts of the card)")
    m = LinsMapper(cfg)
    store = _seam_store(m.state.store, SEAM_COUNT, 7)
    sharded = shard_store(store, store_mesh(STORE_SHARDS))
    dev, W, K = m.device, m.n_window, store.capacity
    t_cur = torch.tensor(0.1 * SEAM_COUNT + 100.0, device=dev)
    n_ok = 0
    t0 = time.perf_counter()
    for center in SEAM_CENTERS:
        c = torch.tensor(center, dtype=torch.int32, device=dev)
        ids = c - (W - 1) + torch.arange(W, dtype=torch.int32, device=dev)
        ok = ids >= SEAM_COUNT - K
        wslots = torch.remainder(ids, W).to(torch.int32)
        idx = c - 18
        for name, fn in (
                ("assemble_local_map", lambda st: kf.assemble_local_map(
                    st, c, W, with_outlier=True)),
                ("rebuild_window", lambda st: lmn.rebuild_window(
                    m.state.lmap, st, ids, ok, wslots, m.gp)),
                ("loop_clouds", lambda st: lc.loop_clouds(
                    st, idx, c, t_cur, cfg, m.submap_cap, m.cloud_cap))):
            same = _tree_equal(fn(sharded), fn(store))
            check(same, f"{name}, window ending at id {center} (slots "
                  f"{int(kf.slot_of(store, ids[0]))}..{center % K}): "
                  f"sharded = unsharded bit for bit")
            n_ok += same
    torch.cuda.synchronize()
    log(f"  {n_ok} gathers equal in {time.perf_counter() - t0:.2f} s")
    return n_ok


def _final_graph(slam):
    """(pos, quat, live mask, live edge view, prior slot) of a mapper's
    final state."""
    import torch

    from lins_tpu_torch.graph import pose_graph as pg
    from lins_tpu_torch.mapping import keyframes as kf

    st = slam.mapper.state
    store = st.store
    K = store.capacity
    return (store.pos, store.quat, kf.live_mask(store),
            pg.live_view(st.edges, store.count, K),
            torch.remainder(torch.clamp(store.count - K, min=0), K))


def phase_sparse_solve(slam):
    """One optimize_cg on path H-sparse's final state under the profiler,
    then card float32 against a CPU float64 copy (1 mm, 0.001 rad)."""
    from lins_tpu_torch.graph import pose_graph as pg

    log("== 6. the sparse solve on path H-sparse's final state")
    cfg = slam.mapper.cfg
    pos, quat, live, ev, prior = _final_graph(slam)
    prof, solved = profile_call(lambda: pg.optimize_cg(
        pos, quat, live, ev, 8, prior_slot=prior,
        huber_delta=cfg.pg_loop_huber))
    log_profile(f"one sparse solve (8 GN x 64 CG iterations, "
                f"{pos.shape[0]} slots, {int(live.sum())} keyframes)", prof)
    pos_c, quat_c, live_c, ev_c, prior_c = _cpu64((pos, quat, live, ev,
                                                   prior))
    want = pg.optimize_cg(pos_c, quat_c, live_c, ev_c, 8, prior_slot=prior_c,
                          huber_delta=cfg.pg_loop_huber)
    lv = live_c.numpy()
    got = [x.cpu().double().numpy()[lv] for x in solved]
    want = [x.numpy()[lv] for x in want]
    moved = float(np.abs(want[0] - pos_c.numpy()[lv]).max())
    dp = float(np.abs(got[0] - want[0]).max())
    dq = _quat_gap(got[1], want[1])
    check(bool(np.isfinite(got[0]).all()) and moved > 0
          and dp <= SOLVE_CPU_TOL_M and dq <= SOLVE_CPU_TOL_RAD,
          f"optimize_cg ({int(lv.sum())} keyframes, moved up to "
          f"{moved:.6f} m): card vs CPU float64 positions {dp:.2e} m <= "
          f"{SOLVE_CPU_TOL_M} m, rotations {dq:.2e} rad <= "
          f"{SOLVE_CPU_TOL_RAD} rad")
    return prof, dp


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_distributed(slam):
    """The edge-sharded solves in an NCCL world of one process (TCP on
    127.0.0.1) over a one-card mesh, on path H's final graph, against the
    one-device solves on the same card, and path H's final store sharded
    over that world against the unsharded store; the group is destroyed
    after."""
    import torch

    from lins_tpu_torch.graph import pose_graph as pg
    from lins_tpu_torch.mapping import keyframes as kf
    from lins_tpu_torch.parallel import dist_graph, multihost
    from lins_tpu_torch.parallel.shard_map_store import shard_store

    log("== 7. distributed solves and store reads: an NCCL world of one")
    check(multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                               device="cuda"),
          "enrolled through torch.distributed (NCCL)")
    out = {}
    try:
        mesh = multihost.global_mesh()
        check(mesh.group is not None and mesh.size == 1,
              f"a one-card mesh with its process group: {mesh}")
        pos, quat, live, ev, prior = _final_graph(slam)
        K = pos.shape[0]
        for name, make, single in (
                ("dense", dist_graph.make_sharded_optimizer, pg.optimize),
                ("sparse", dist_graph.make_sharded_cg_optimizer,
                 pg.optimize_cg)):
            t0 = time.perf_counter()
            got = make(mesh, K, iters=8)(pos, quat, live, ev,
                                         prior_slot=prior)
            want = single(pos, quat, live, ev, 8, prior_slot=prior)
            lv = live.cpu().numpy()
            dp = float((got[0] - want[0]).abs().cpu().numpy()[lv].max())
            moved = float((want[0] - pos).abs().cpu().numpy()[lv].max())
            check(dp <= DIST_TOL_M and moved > 0,
                  f"edge-sharded {name} solve ({int(lv.sum())} keyframes, "
                  f"{K} slots, moved up to {moved:.6f} m) vs the one-device "
                  f"solve: {dp:.2e} m <= {DIST_TOL_M} m "
                  f"({time.perf_counter() - t0:.2f} s)")
            out[name] = dp
        # path H's final store sharded over the NCCL world: every read of a
        # cloud row goes through the all_reduce of the owner-masked rows
        st = slam.mapper.state.store
        c = torch.clamp(st.count - 1, min=0)
        whole = kf.assemble_local_map(st, c, slam.mapper.n_window)
        got = kf.assemble_local_map(shard_store(st, mesh), c,
                                    slam.mapper.n_window)
        check(_tree_equal(got, whole) and int(whole[3].sum()) > 0,
              f"the window assembly ({int(whole[3].sum())} surf points) "
              f"from path H's store sharded over the NCCL world equals the "
              f"unsharded one bit for bit")
    finally:
        multihost.shutdown()
    return out


def phase_multi_stream(cfg):
    """make_sharded_slam_replay over a one-card mesh with distinct VLP-16
    streams, against each stream's own LinsSlam chunk in this process; both
    timed alike (fenced, in PyTorch's sync debug mode)."""
    import torch

    from lins_tpu_torch.datasets.synthetic import generate_sequence
    from lins_tpu_torch.parallel import replay as rp
    from lins_tpu_torch.slam import LinsSlam
    from lins_tpu_torch.utils.trajectory import ate
    from lins_tpu_torch.utils.tree import tree_map

    B, n_scans = len(STREAM_SPEEDS), WARMUP_SCANS + K_CHUNK
    log(f"== 5. multi-stream replay: {B} VLP-16 streams (speeds "
        f"{STREAM_SPEEDS} m/s) of {n_scans} scans on a one-card mesh")
    streams = []
    for speed in STREAM_SPEEDS:
        data = generate_sequence(cfg, n_scans=n_scans, kind="gentle",
                                 speed=speed)
        slam = LinsSlam(cfg, enable_mapping=True)
        jobs, tail = slam.stage_replay(data, n_scans, chunk=K_CHUNK,
                                       min_streamed=WARMUP_SCANS)
        check(len(jobs) == 1 and not tail,
              f"speed {speed}: {WARMUP_SCANS} scans streamed, one chunk of "
              f"{K_CHUNK} staged")
        streams.append((data, slam, jobs[0]))
    mf, lf = streams[0][2][1][1:3]
    check(all((j[1][1] == mf).all() and (j[1][2] == lf).all()
              for _, _, j in streams),
          f"the streams share their cadence flags ({int(mf.sum())} mapping "
          f"steps, {int(lf.sum())} loop attempts in the chunk)")
    odo = rp.stack_lanes([tree_map(torch.clone, (
        s.odometry.filter_state, s.odometry.global_state,
        s.odometry.last_surf, s.odometry.last_corner))
        for _, s, _ in streams])
    maps = rp.stack_lanes([tree_map(torch.clone, s.mapper.state)
                           for _, s, _ in streams])
    chunk = [torch.stack([j[0][i] for _, _, j in streams]) for i in (1, 2)]
    imu = [torch.stack([j[0][3][i] for _, _, j in streams])
           for i in range(4)]
    ts = torch.stack([j[1][0] for _, _, j in streams])
    rpy = torch.stack([j[1][3] for _, _, j in streams])
    step, put = rp.make_sharded_slam_replay(cfg, rp.make_mesh(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _reset_counts()
    t0 = time.perf_counter()
    with record_spans() as batch_spans, count_host_syncs() as sites:
        _, _, (pos, quat) = step(*put((odo, maps)), *put(chunk), *put(imu),
                                 put(ts), put(rpy), mf, lf, has_map=True)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    syncs = sum(sites.values())
    single_s, diffs, equal, errs = [], [], True, []
    for b, (data, slam, job) in enumerate(streams):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_spans() as spans1, count_host_syncs() as s1:
            slam.run_chunk(job)
            torch.cuda.synchronize()
            single_s.append(time.perf_counter() - t0)
        _, ps, qs = slam.trajectory_arrays()
        got = pos[b].cpu().numpy()
        diffs.append(float(np.abs(got - ps[-K_CHUNK:]).max()))
        equal &= bool((got == ps[-K_CHUNK:]).all()
                      and (quat[b].cpu().numpy() == qs[-K_CHUNK:]).all())
        check_reads(s1, spans1, f"stream {b}'s own chunk")
        full = np.concatenate([ps[:-K_CHUNK], got])
        errs.append(ate(full, data["gt_pos"][1:1 + len(full)], align=True))
    log(f"  batch of {B}: {B * K_CHUNK} scans in {batch_s:.3f} s "
        f"({B * K_CHUNK / batch_s:.3f} scans/s); each stream alone: "
        + ", ".join(f"{t:.3f}" for t in single_s) + f" s ("
        f"{K_CHUNK * B / sum(single_s):.3f} scans/s); peak "
        f"{peak / 2**20:.1f} MiB; fused ATEs "
        + ", ".join(f"{e:.4f}" for e in errs) + " m; launch counts "
        f"{counts}")
    check(max(diffs) <= STREAM_TOL_M,
          f"each stream's fused poses within {STREAM_TOL_M} m of its own "
          f"run: max {max(diffs):.2e} m ("
          + ("bit for bit" if equal else "not bit for bit") + ")")
    check_reads(sites, batch_spans, "the batched chunk")
    check(max(errs) <= ATE_LIMIT_M and len({round(e, 6) for e in errs}) == B,
          f"distinct streams, every fused ATE <= {ATE_LIMIT_M} m")
    return dict(rate=B * K_CHUNK / batch_s,
                single_rate=K_CHUNK * B / sum(single_s), chunk_s=[batch_s],
                ate=max(errs), syncs=syncs, counts=counts, peak_bytes=peak,
                held_bytes=held,
                max_diff=max(diffs), bit_equal=equal)


def phase_dryrun():
    import torch

    from lins_tpu_torch.parallel import dryrun

    log("== 7. the dry run (parallel/dryrun.py)")
    fn, args = dryrun.entry()
    rn, qbn, res = fn(*args)
    check(rn.shape == (3,) and bool(torch.isfinite(rn).all()),
          f"entry(): the forward step ran on {rn.device}, residual "
          f"{float(res):.4f}")
    n = torch.cuda.device_count()
    report = dryrun.dryrun_multichip(n)
    check(report["shards"] == n and len(report["ran"]) == 4
          and not report["skipped"],
          f"dryrun_multichip({n}): {report['ran']}; skipped "
          f"{report['skipped']}")


def phase_runner_multihost():
    """The runner with --multihost, enrolled through the reference's
    variables in a world of one: exit 0, the enrollment line, the
    summary's keys."""
    log("== 8. the runner with --multihost")
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "chiprun_out", "runner_multihost")
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, JAX_COORDINATOR=f"127.0.0.1:{_free_port()}",
               JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0")
    cmd = [sys.executable, "-m", "lins_tpu_torch.run_slam", "--multihost",
           "--synthetic", "gentle", "--scans", str(MULTIHOST_SCANS),
           "--no-loop-closure", "--out", out]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True, timeout=RUNNER_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if p.returncode:
        log(p.stdout[-3000:] + p.stderr[-3000:])
    check(p.returncode == 0, f"exit 0 ({wall:.1f} s)")
    lines = [json.loads(t) for t in p.stdout.splitlines()
             if t.startswith("{")]
    enroll, summary = lines[0], lines[-1]
    check(enroll == dict(multihost=True, process_index=0, process_count=1,
                         global_devices=1),
          f"the enrollment line: {enroll}")
    check(set(summary) == RUNNER_SUMMARY_KEYS,
          f"the summary has phase 8's keys: {summary}")
    for name in os.listdir(out):
        if name.endswith(".npz"):
            os.unlink(os.path.join(out, name))
    return summary


def _idle(p):
    return 1 - p["busy_ms"] / p["wall_ms"] if p["launches"] else math.nan


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    from lins_tpu_torch.config import HDL64, VLP16
    from lins_tpu_torch.datasets.synthetic import generate_sequence

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    cfg = VLP16.replace(max_points=28800, use_pallas=True)
    cfg_map = cfg.replace(use_pallas_select=True, loop_attempts=False)
    cfg_v = cfg.replace(use_pallas_select=True)
    cfg_h = HDL64.replace(use_pallas=True, use_pallas_select=True,
                          loop_time_gate=4.0)
    cfg_r = cfg_v.replace(loop_closure_enabled=False)
    cfg_hr = cfg_h.replace(lc_map_mode="radius")
    cfg_e = cfg_map.replace(feature_mode="exact")
    cfg_hs = cfg_h.replace(max_keyframes=2048)
    t0 = time.perf_counter()
    data = generate_sequence(cfg, n_scans=N_SCANS, kind="gentle", speed=1.5)
    data_h = generate_sequence(cfg_h, n_scans=N_SCANS_H, **SEQ_H)
    log(f"  (set-up: {N_SCANS} VLP-16 and {N_SCANS_H} HDL-64 synthetic "
        f"scans in {time.perf_counter() - t0:.1f} s)")
    k1, k1_scan = phase_k1(cfg, data)
    k2 = phase_k2(cfg_h, data_h, smi, k1_scan.pop("real"))
    k3_err = phase_k3_synthetic(cfg_map.s2m_cand)
    k6 = phase_k6()
    k4, k5 = phase_k45(cfg, data, cfg_h, data_h)
    odo = phase_odometry(cfg, data)
    mp = phase_mapping(cfg_map, data, odo["ps"])
    k3 = phase_k3_real(mp["slam"], smi)
    grid_k3, grid_err, build_err = phase_grid_voxelized(mp["slam"], smi)
    inc_err = phase_incremental_map(mp["slam"], smi)
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_err, grid_err)
    pv = phase_path_v(cfg_v, data)
    ph = phase_path_h(cfg_h, data_h)
    pr = phase_path_r(cfg_r, data, odo["ps"])
    phr = phase_path_h(cfg_hr, data_h, "path H-radius", REF_FUSED_ATE_HR_M)
    pe = phase_path_e(cfg_e, data, mp["rate"])
    phs = phase_path_hs(cfg_hs, data_h)
    phss = phase_path_hs_shard(cfg_hs, data_h, phs)
    n_seams = phase_store_seams(cfg_hs)
    map_err = phase_map_means(ph["slam"], phs["slam"], smi)
    pms = phase_multi_stream(cfg_v)
    runs = dict(odometry=odo, window=mp, V=pv, H=ph, R=pr, HR=phr, E=pe,
                HS=phs, HSS=phss, MS=pms)
    # each kernel's launches: the sum of its counts over the main-path runs,
    # each read just after its own run
    k1["launches"] = sum(r["counts"]["label"] for r in runs.values())
    k2["launches"] = sum(r["counts"]["label_blocked"] for r in runs.values())
    # K3's also the gather_candidates calls of the fused-grid phase, each
    # read just after its call
    k3["launches"] = sum(r["counts"]["select"]
                         for r in runs.values()) + grid_k3
    # K6 is the canary's kernel, off every main path: its count must stay 0
    # until a path calls it
    k6["launches"] = sum(r["counts"]["topk"] for r in runs.values())
    k4["launches"] = sum(r["counts"]["k4"] for r in runs.values())
    k5["launches"] = sum(r["counts"]["k5"] for r in runs.values())
    log("  launches per run: " + "; ".join(
        f"{name} K1 {r['counts']['label']} K2 {r['counts']['label_blocked']}"
        f" K3 {r['counts']['select']} K4 {r['counts']['k4']} K5 "
        f"{r['counts']['k5']} K6 {r['counts']['topk']}"
        for name, r in runs.items()) + f"; the fused-grid phase K3 {grid_k3}")
    check(k6["launches"] == 0, "K6 launched 0 times on the main paths")
    # K1's lost time, launch by launch: a 32-scan chunk at the chunk's time
    # and bound, a streamed scan at one scan's
    batches = sum((collections.Counter(r["counts"]["label_batches"])
                   for r in runs.values()), collections.Counter())
    per = {K_CHUNK: (k1["ms"], k1["bound_ms"]),
           1: (k1_scan["ms"], k1_scan["bound_ms"])}
    check(set(batches) <= set(per), f"K1 launched only on chunks of "
          f"{K_CHUNK} scans and on single scans: {dict(batches)}")
    lost = sum(n * (per[K][0] - per[K][1]) for K, n in batches.items())
    log("  K1 launches by scans a launch: " + ", ".join(
        f"{n} x {K}" for K, n in sorted(batches.items())) + f"; lost "
        f"{lost:.4f} ms (launches x (ms - bound))")
    attempt, solve, attempt_out, solved = phase_profiles(
        cfg, data, mp["slam"], ph["slam"])
    odo_e, _ = warm_odometry(cfg_e, data, WARMUP_SCANS - 1)
    k = WARMUP_SCANS - 1
    exact_scan, _ = profile_call(lambda: odo_e.add_scan(
        data["scan_times"][k] + cfg.scan_period, data["scans_xyz"][k],
        data["scans_n"][k]))
    log_profile("one RUNNING add_scan in the exact mode", exact_scan)
    sparse, sparse_dp = phase_sparse_solve(phs["slam"])
    shard_prof = shard_profiles((("path H-sparse", phs["slam"]),
                                 ("path HS-shard", phss["slam"])))
    k3["max_abs_err"] = max(k3["max_abs_err"],
                            phase_k3_loop(ph["slam"], cfg_h.s2m_cand))
    diff = phase_cpu_check(cfg, data, odo["ps"])
    mdiff, mrel = phase_cpu_map_check("the window path", cfg_map, data,
                                      mp["ps"], mp["metrics"])
    hdiff, hrel = phase_cpu_map_check("path H (HDL-64)", cfg_h, data_h,
                                      ph["ps"], ph["metrics"])
    dist = phase_distributed(ph["slam"])
    sdiff = phase_loop_cpu_check(ph["slam"], attempt_out, solved)
    rdiff, rrel = phase_cpu_map_check("path R (radius map)", cfg_r, data,
                                      pr["ps"], pr["metrics"])
    phase_hr_final_solve(phr["slam"])
    ediff, erel = phase_cpu_map_check("path E (exact mode)", cfg_e, data,
                                      pe["ps"], pe["metrics"])
    label_diff, label_picks = phase_exact_labels(cfg_e, data)
    phase_dryrun()
    runner = phase_runner()
    runner_mh = phase_runner_multihost()
    log(f"  summary on {smi}:")
    for name, r in runs.items():
        log(f"    {name}: {r['rate']:.3f} scans/s, ATE {r['ate']:.4f} m, "
            f"host syncs in the warm chunk {r['syncs']}, peak "
            f"{r['peak_bytes'] / 2**20:.1f} MiB "
            f"({(r['peak_bytes'] - r['held_bytes']) / 2**20:.1f} above its "
            f"start)")
    log(f"    card-vs-CPU: odometry {diff:.6f} m; window {mdiff:.6f} m, "
        f"matches {mrel:.4f}; H {hdiff:.6f} m, matches {hrel:.4f}; H's "
        f"final solve {sdiff:.2e} m; R {rdiff:.6f} m, matches {rrel:.4f}")
    log(f"    R: the selection changed {pr['changes']} times; H-radius: "
        f"{phr['n_loops']} loops, {phr['n_kf']} keyframes")
    log(f"    E: odometry ATE {pe['odo_ate']:.4f} m, {pe['rate']:.3f} scans/s"
        f" against the window path's {mp['rate']:.3f}; card vs CPU "
        f"{ediff:.6f} m, matches {erel:.4f}; labels from the raw points "
        f"{label_diff} of {label_picks} picks differ; one RUNNING scan "
        f"{exact_scan['launches']} launches, busy "
        f"{exact_scan['busy_ms']:.3f} ms, idle share "
        f"{_idle(exact_scan):.4f}")
    log(f"    H-sparse: {phs['n_loops']} loops, {phs['n_kf']} keyframes, "
        f"store {phs['store_bytes'] / 2**20:.1f} MiB, solves "
        f"{phs['solves']}; one sparse solve {sparse['launches']} launches, "
        f"busy {sparse['busy_ms']:.3f} ms, idle share {_idle(sparse):.4f}; "
        f"card vs CPU {sparse_dp:.2e} m")
    hs_p, hss_p = shard_prof["path H-sparse"], shard_prof["path HS-shard"]
    log(f"    HS-shard: {phss['rate']:.3f} scans/s against H-sparse's "
        f"{phs['rate']:.3f} ({phss['rate'] / phs['rate']:.3f}x), poses "
        f"within {phss['max_pose_diff']:.3e} m ({phss['n_equal']} of "
        f"{len(phss['ps'])} equal), store {phss['store_bytes'] / 2**20:.1f}"
        f" MiB, {phss['shard_mib']:.1f} MiB a shard; launches of a mapping "
        f"step "
        f"{hss_p['step']['launches']} (unsharded {hs_p['step']['launches']})"
        f", of a loop attempt {hss_p['attempt']['launches']} (unsharded "
        f"{hs_p['attempt']['launches']}); {n_seams} seam gathers equal")
    log("    ATE in the estimator's frame, no fit (slam.ate_rmse): "
        + ", ".join(f"{name} {runs[name]['ate_no_fit']:.4f} m"
                    for name in ("odometry", "V", "H", "HR")))
    log(f"    map builders (float64 run sums), the largest centroid error "
        f"from the float64 means (gate {GRID_CENT_TOL_M} m): the voxel map's "
        f"build and voxel_downsample on the window map {build_err:.3e} m; "
        f"the incremental window map {inc_err:.3e} m; path H's loop submap "
        f"{map_err['submap']:.3e} m, its current cloud "
        f"{map_err['cloud']:.3e} m; the global map of path H-sparse "
        f"{map_err['global_map']:.3e} m")
    log(f"    distributed solves vs one device: dense {dist['dense']:.2e} m, "
        f"sparse {dist['sparse']:.2e} m")
    log(f"    multi-stream: {pms['rate']:.3f} scans/s batched against "
        f"{pms['single_rate']:.3f} one stream at a time; max difference "
        f"{pms['max_diff']:.2e} m (bit for bit: {pms['bit_equal']})")
    log(f"    runner --multihost: {runner_mh['scans']} scans at "
        f"{runner_mh['scans_per_sec']} scans/s, ATE "
        f"{runner_mh['ate_rmse_m']} m")
    log("    runner: " + "; ".join(
        f"{s['scans']} scans at {s['scans_per_sec']} scans/s, warm-up "
        f"{s['compile_s']} s, ATE {s['ate_rmse_m']} m" for s in runner))
    log(f"    H: {ph['n_loops']} loops, {ph['n_kf']} keyframes; one loop "
        f"attempt {attempt['launches']} launches, busy "
        f"{attempt['busy_ms']:.3f} ms, idle share {_idle(attempt):.4f}; one "
        f"solve {solve['launches']} launches, busy {solve['busy_ms']:.3f} ms,"
        f" idle share {_idle(solve):.4f}")
    log(f"    script {time.perf_counter() - t_start:.1f} s")
    kernels = [k1, k2, k3, k4, k5, k6]
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms"):
            if not math.isfinite(k[key]):
                raise SystemExit(f"chip_smoke: FAILED: {k['name']} {key} "
                                 f"not finite")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

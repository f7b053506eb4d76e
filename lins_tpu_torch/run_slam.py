"""lins_tpu_torch command-line runner: decode a dataset, run the full SLAM
pipeline on the card, write the TUM trajectory, metrics, map export and
checkpoints, and evaluate ATE/RPE against ground truth when there is one.
It takes every flag of the reference package's `run_slam.py`, with the
same meaning and default, and writes the same files and summary keys, and
also `spans.jsonl`: the run's stage spans (utils/metrics.RECORDER).

Usage:
  python -m lins_tpu_torch.run_slam --synthetic gentle --scans 40 --out out/
  python -m lins_tpu_torch.run_slam --bag port.bag --imu-topic /imu/data \\
                     --cloud-topic /velodyne_points --out out/
  python -m lins_tpu_torch.run_slam --kitti /data/kitti --seq 00 \\
                     --preset hdl64 --out out/

It runs on the card (`--device cuda`, the default) and raises when there
is none; `--device cpu` runs the kernels' plain versions on the CPU.  A
run with `--resume` goes on after the checkpoint's last scan.  With
`--multihost` the process enrolls in a torch.distributed group through the
reference's variables and prints the reference runner's enrollment line.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _positive_int(v):
    iv = int(v)
    if iv < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return iv


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lins_tpu_torch.run_slam", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic", metavar="KIND",
                     help="synthetic trajectory: static|straight|gentle|"
                          "turny|loop|bigloop (loop: closed revisiting "
                          "circuit; bigloop: ~181 m ring course whose "
                          "extent exceeds the 50 m radius window)")
    src.add_argument("--bag", help="rosbag 2.0 file (uncompressed chunks)")
    src.add_argument("--kitti", help="KITTI odometry root directory")
    ap.add_argument("--seq", default="00", help="KITTI sequence id")
    ap.add_argument("--preset", default="vlp16",
                    help="sensor preset: vlp16|os1_64|hdl64|tiny")
    ap.add_argument("--config", help="YAML/JSON config overriding the preset")
    ap.add_argument("--scans", type=int, default=None, help="max scans")
    ap.add_argument("--speed", type=float, default=1.5)
    ap.add_argument("--imu-topic", default="/imu/data")
    ap.add_argument("--cloud-topic", default="/velodyne_points")
    ap.add_argument("--no-mapping", action="store_true",
                    help="odometry only (no scan-to-map backend)")
    ap.add_argument("--no-loop-closure", action="store_true",
                    help="mapping with the 50 m-RADIUS window and no loop "
                         "machinery (the reference's loopClosureEnableFlag="
                         "false mode)")
    ap.add_argument("--window-no-loop", action="store_true",
                    help="mapping with the recent-keyframe WINDOW map (the "
                         "LC-mode local map) but loop attempts disabled: "
                         "the 'window, no loops' baseline of the LC matrix")
    ap.add_argument("--loop-frac", type=float, default=None,
                    help="override loop_consistency_frac (drift-rate bound "
                         "of the odometry-consistency gate; raise for "
                         "high-noise courses where true drift exceeds 5%% "
                         "of arc)")
    ap.add_argument("--loop-fitness", type=float, default=None,
                    help="override history_keyframe_fitness_score (ICP "
                         "mean-squared-distance acceptance gate; high IMU "
                         "noise blurs the map and inflates fitness of "
                         "CORRECT alignments past the reference's 0.3)")
    ap.add_argument("--lc-map", choices=("recent", "radius"), default=None,
                    help="local-map selection in loop-closure mode: "
                         "'recent' = last-50 window (the reference), "
                         "'radius' = 50 m-radius selection (relocalizes "
                         "against the loop-corrected old map on revisits)")
    ap.add_argument("--loop-rewrite-min", type=float, default=None,
                    help="override loop_rewrite_min_m (implied-correction "
                         "threshold below which an accepted loop edge is "
                         "add-only, no solve/rewrite)")
    ap.add_argument("--pallas", action="store_true",
                    help="the kernel driver shapes: the split per-chunk "
                         "front end (pre -> label -> rest) and the kernel "
                         "prune bound of the scan-to-map selection (the "
                         "kernels run on the card either way)")
    ap.add_argument("--no-pallas-select", action="store_true",
                    help="with --pallas: keep the split front end but use "
                         "the sort path's prune bound for the scan-to-map "
                         "candidate selection (A/B isolation)")
    ap.add_argument("--full-queries", action="store_true",
                    help="disable the measured-occupancy map_query_* caps "
                         "(A/B isolation)")
    ap.add_argument("--feature-scale", type=float, default=None,
                    help="multiply the per-scan feature capacities "
                         "(max_sharp/less_sharp/flat/less_flat/outlier) and "
                         "the map_query_* caps by this factor.  The presets "
                         "size these for 16 rings; 64-beam sensors truncate "
                         "features at the VLP-16 caps")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save state every N scans")
    ap.add_argument("--resume", help="checkpoint file to resume from")
    ap.add_argument("--out", default="out", help="output directory")
    ap.add_argument("--map-format", default="npz",
                    choices=("npz", "ply", "none"),
                    help="global map export format (none: skip)")
    ap.add_argument("--no-state", action="store_true",
                    help="skip the final_state.npz dump (saves are "
                         "uncompressed and leave the derived local map "
                         "out; this skips even that)")
    ap.add_argument("--chunk", type=_positive_int, default=24,
                    help="scans per chunk in replay mode")
    ap.add_argument("--imu-noise-scale", type=float, default=1.0,
                    help="multiplier on the --imu-noise noise densities and "
                    "biases (drift severity knob for loop-closure studies)")
    ap.add_argument("--imu-noise", action="store_true",
                    help="synthetic only: add IMU noise + fixed biases "
                         "(acc 0.02 m/s^2, gyr 0.002 rad/s) so odometry "
                         "drifts realistically")
    ap.add_argument("--stream", action="store_true",
                    help="per-scan streaming mode (default: chunked replay "
                         "with every chunk staged on the device up front)")
    ap.add_argument("--multihost", action="store_true",
                    help="enroll this process in a multi-process group "
                         "through torch.distributed (JAX_COORDINATOR / "
                         "JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars; NCCL "
                         "on the card, gloo on the CPU; see "
                         "lins_tpu_torch.parallel.multihost)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; raises when "
                         "there is none; 'cpu' runs the kernels' plain "
                         "versions)")
    return ap


def configure(args):
    """The run's SlamConfig: the preset or --config, then the flags'
    transforms, in the reference runner's order."""
    from lins_tpu_torch.config import PRESETS, SlamConfig

    cfg = PRESETS[args.preset]
    if args.config:
        cfg = (SlamConfig.from_yaml(args.config)
               if args.config.endswith((".yaml", ".yml"))
               else SlamConfig.from_json(args.config))
    if args.no_loop_closure:
        cfg = cfg.replace(loop_closure_enabled=False)
    if args.window_no_loop:
        cfg = cfg.replace(loop_closure_enabled=True, loop_attempts=False)
    if args.loop_frac is not None:
        cfg = cfg.replace(loop_consistency_frac=args.loop_frac)
    if args.loop_fitness is not None:
        cfg = cfg.replace(history_keyframe_fitness_score=args.loop_fitness)
    if args.loop_rewrite_min is not None:
        cfg = cfg.replace(loop_rewrite_min_m=args.loop_rewrite_min)
    if args.lc_map is not None:
        cfg = cfg.replace(lc_map_mode=args.lc_map)
    if args.pallas:
        cfg = cfg.replace(use_pallas=True, use_pallas_select=True)
    if args.no_pallas_select:
        cfg = cfg.replace(use_pallas_select=False)
    if args.full_queries:
        cfg = cfg.replace(map_query_corner=None, map_query_surf=None)
    if args.feature_scale is not None:
        def _sc(v):  # scale a capacity, keep it a multiple of 128
            return max(128, int(-(-v * args.feature_scale // 128)) * 128)
        cfg = cfg.replace(
            max_sharp=_sc(cfg.max_sharp),
            max_less_sharp=_sc(cfg.max_less_sharp),
            max_flat=_sc(cfg.max_flat),
            max_less_flat=_sc(cfg.max_less_flat),
            max_outlier=_sc(cfg.max_outlier),
            map_query_corner=(None if cfg.map_query_corner is None
                              else _sc(cfg.map_query_corner)),
            map_query_surf=(None if cfg.map_query_surf is None
                            else _sc(cfg.map_query_surf)),
            max_map_corner=_sc(cfg.max_map_corner),
            max_map_surf=_sc(cfg.max_map_surf))
    return cfg


def load_data(args, cfg, device):
    """(config, sequence dict of host arrays) for the chosen source; the
    synthetic source caps max_points at the range image, as the reference
    runner does."""
    if args.synthetic:
        from lins_tpu_torch.datasets import synthetic as syn

        cfg = cfg.replace(max_points=min(cfg.max_points, cfg.grid_size))
        s = args.imu_noise_scale
        noise = (dict(acc_noise=0.02 * s, gyr_noise=0.002 * s,
                      ba=tuple(s * v for v in (0.05, -0.03, 0.02)),
                      bw=tuple(s * v for v in (0.002, -0.001, 0.0015)))
                 if args.imu_noise else {})
        return cfg, syn.generate_sequence(
            cfg, n_scans=args.scans or 40, kind=args.synthetic,
            speed=args.speed, device=device, **noise)
    if args.bag:
        from lins_tpu_torch.datasets import bag as bagmod

        raw = bagmod.read_bag(args.bag, args.imu_topic, args.cloud_topic)
        return cfg, bagmod.bag_to_sequence(raw, cfg)
    from lins_tpu_torch.datasets import kitti

    return cfg, kitti.load_sequence(args.kitti, args.seq, cfg,
                                    max_scans=args.scans)


def run(args):
    """One run of the runner for parsed `args`; writes every output under
    `args.out`.  Returns (the LinsSlam, the summary dict)."""
    import numpy as np

    from lins_tpu_torch.slam import LinsSlam
    from lins_tpu_torch.utils import checkpoint as ckpt
    from lins_tpu_torch.utils import trajectory as traj
    from lins_tpu_torch.utils.device import resolve_device
    from lins_tpu_torch.utils.lazy import to_numpy
    from lins_tpu_torch.utils.metrics import RECORDER, MetricsLog

    device = resolve_device(args.device)
    if args.multihost:
        # enroll through torch.distributed with the reference's variables
        # (JAX_COORDINATOR, JAX_NUM_PROCESSES, JAX_PROCESS_ID) and print
        # the reference runner's line (run_slam.py:132-138)
        from lins_tpu_torch.parallel import multihost

        enrolled = multihost.initialize(device=device)
        print(json.dumps(dict(
            multihost=enrolled, process_index=multihost.process_index(),
            process_count=multihost.process_count(),
            global_devices=multihost.global_mesh([device]).size)),
            flush=True)
    cfg, data = load_data(args, configure(args), device)

    os.makedirs(args.out, exist_ok=True)
    n = min(args.scans or len(data["scans_xyz"]), len(data["scans_xyz"]))

    slam = LinsSlam(cfg, enable_mapping=not args.no_mapping, device=device)
    # the first scan to run, and the first scan with a pose: the bootstrap
    # takes scan 0; a resumed run goes on after the checkpoint's last scan
    start, first = 0, 1
    if args.resume:
        ckpt.load_state(args.resume, slam.odometry, slam.mapper)
        t_end = np.asarray(data["scan_times"], float) + cfg.scan_period
        start = first = min(int(np.searchsorted(
            t_end, slam.odometry.time + 1e-9)), n)

    chunk = args.chunk    # scans per odometry chunk in replay mode; the
    # mapping cadence inside a chunk stays mapping_process_interval
    t_c = time.perf_counter()
    slam.warmup(chunk=None if args.stream else chunk)
    compile_s = time.perf_counter() - t_c

    log = MetricsLog()
    RECORDER.clear()
    t0 = time.perf_counter()
    if args.stream or args.checkpoint_every:
        imu_i = 0
        imu_t = data.get("imu_times", [])
        for k in range(start, n):
            t_scan = float(data["scan_times"][k]) + cfg.scan_period
            while imu_i < len(imu_t) and imu_t[imu_i] <= t_scan + 1e-9:
                slam.add_imu(imu_t[imu_i], data["imu_acc"][imu_i],
                             data["imu_gyr"][imu_i])
                imu_i += 1
            slam.add_scan(t_scan, data["scans_xyz"][k], data["scans_n"][k])
            if args.checkpoint_every and (k + 1) % args.checkpoint_every == 0:
                ckpt.save_state(os.path.join(args.out, f"ckpt_{k+1:05d}.npz"),
                                slam.odometry, slam.mapper)
    else:
        rest = {k: (v[start:] if k in ("scans_xyz", "scans_n", "scan_times")
                    else v) for k, v in data.items()}
        slam.run_replay(rest, n_scans=n - start, chunk=chunk)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0

    # ---- outputs ----
    mapper = slam.mapper
    # the final-estimate solve takes the add-only loop edges (those below
    # loop_rewrite_min_m) into the keyframe poses before the map and the
    # keyframe trajectory are written: the reference's last correctPoses
    n_loops_run = int(mapper.state.n_loops) if mapper is not None else 0
    if n_loops_run > 0:
        mapper.final_solve()
    ts, ps, qs = slam.trajectory_arrays()
    traj.write_tum(os.path.join(args.out, "trajectory.tum"), ts, ps, qs)

    def scalars(m):
        return {k: to_numpy(v).item() for k, v in m.items()}

    for m in slam.odometry.metrics:
        log.record("odometry", **scalars(m))
    if mapper is not None:
        for m in mapper.metrics:
            log.record("mapping", **scalars(m))
        for m in mapper.loop_info:
            log.record("loop", **scalars(m))
        if args.map_format != "none":
            ckpt.export_global_map(
                os.path.join(args.out, f"global_map.{args.map_format}"),
                mapper)
        if not args.no_state:
            t_s = time.perf_counter()
            ckpt.save_state(os.path.join(args.out, "final_state.npz"),
                            slam.odometry, mapper)
            state_save_s = round(time.perf_counter() - t_s, 2)
    log.dump(os.path.join(args.out, "metrics.jsonl"))
    RECORDER.export(os.path.join(args.out, "spans.jsonl"))

    summary = dict(
        scans=len(ts), elapsed_s=round(elapsed, 2),
        compile_s=round(compile_s, 2),
        scans_per_sec=round(len(ts) / max(elapsed, 1e-9), 2),
        keyframes=int(mapper.state.store.count) if mapper else None,
        loops=int(mapper.state.n_loops) if mapper else None,
        # solves that rewrote the map (not add-only edges below
        # loop_rewrite_min_m, nor solves the guard discarded)
        loops_applied=(sum(int(to_numpy(m["applied"]))
                           for m in mapper.loop_info)
                       if mapper else None),
    )
    if mapper is not None and not args.no_state:
        summary["state_save_s"] = state_save_s
    if mapper is not None:
        # the final keyframe trajectory: the loop-corrected map poses (the
        # causal stream above never rewrites published poses)
        st = mapper.state.store
        K = st.capacity
        count = int(st.count)
        slots = np.arange(max(count - K, 0), count) % K
        kf_t = to_numpy(st.time)[slots]
        kf_p = to_numpy(st.pos)[slots]
        kf_q = to_numpy(st.quat)[slots]
        traj.write_tum(os.path.join(args.out, "trajectory_kf.tum"),
                       kf_t, kf_p, kf_q)

    if "gt_pos" in data:
        gt = np.asarray(data["gt_pos"])[first:first + len(ps)]
        summary["ate_rmse_m"] = round(traj.ate(ps, gt, align=True), 4)
        gt_q = data.get("gt_quat")
        summary["rpe_m"] = round(traj.rpe(
            ps, gt, est_quat=qs if gt_q is not None else None,
            gt_quat=(None if gt_q is None
                     else np.asarray(gt_q)[first:first + len(ps)])), 4)
        if mapper is not None and len(kf_t):
            # ground truth at each keyframe's scan time by the NEAREST
            # stamp of the scan end-time grid (keyframe times are float32
            # copies of it, whose ulp outgrows any fixed rounding tolerance
            # after tens of seconds); the whole grid, as a resumed run's
            # keyframes reach back before its first scan
            t_all = np.asarray(data["scan_times"], float)[:n] + cfg.scan_period
            j = np.clip(np.searchsorted(t_all, kf_t), 1, len(t_all) - 1)
            pick_prev = (np.abs(t_all[j - 1] - kf_t)
                         <= np.abs(t_all[j] - kf_t))
            ji = np.where(pick_prev, j - 1, j)
            summary["ate_kf_m"] = round(traj.ate(
                kf_p, np.asarray(data["gt_pos"])[ji], align=True), 4)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return slam, summary


def main(argv=None):
    from lins_tpu_torch.parallel import multihost

    try:
        summary = run(build_parser().parse_args(argv))[1]
    finally:
        multihost.shutdown()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

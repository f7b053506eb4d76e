"""On-card check of the PyTorch/CUDA port `lins_tpu_torch` on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device      the card's name and power limit (nvidia-smi), TF32 flags
  2. build       nvcc of every kernel source, all started together
  3. kernels     each hand-written kernel against its plain PyTorch version
                 on the card, exactly: K1 on random graphs, edge cases and a
                 real chunk; K3 on random gathered blocks with ties,
                 tombstones, invalid rows and short rows at the mapping
                 shapes; K6 on the canary's shapes (and against torch.topk)
  4. odometry    LinsSlam(VLP16, max_points=28800, use_pallas=True,
                 enable_mapping=False).run_replay over a synthetic gentle
                 sequence (6 + 4x32 scans at 1.5 m/s): label launches,
                 finite poses, odometry ATE <= 0.25 m, no plain-label
                 fallback; odometry scans/s timed as bench.py times it
                 (chunks 1-3 after a warm chunk 0), the warm chunk's host
                 syncs (PyTorch's sync debug mode), peak memory
  5. mapping     the same with the mapping backend, enable_mapping=True and
                 use_pallas_select=True, loop_attempts=False: K3 launches
                 (>= 2 per mapping step), no plain selection, finite fused
                 poses, fused ATE <= the odometry ATE and <= 0.25 m; SLAM
                 scans/s as bench.py:bench_slam times it, host syncs, peak
                 memory; then K3 against its plain version on real gathers
                 of the final map at the surf and corner shapes, with kernel,
                 plain and torch.topk times
  6. profiles    under torch.profiler, after every timing: one streamed
                 RUNNING scan and each of its stages; one mapping step and
                 each of its stages (device launches, busy time, idle share,
                 top kernels)
  7. CPU checks  the first 8 scans again on the CPU in float64: odometry
                 positions within 1 cm; with mapping, positions within 5 cm
                 and per-step matches within 10%
Then one JSON line of kernel numbers, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.  Without a card, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

K_CHUNK = 32
N_CHUNKS = 3          # timed chunks, after one warm chunk
WARMUP_SCANS = 6
N_SCANS = WARMUP_SCANS + (N_CHUNKS + 1) * K_CHUNK
ATE_LIMIT_M = 0.25
CPU_CHECK_SCANS = 8
CPU_CHECK_LIMIT_M = 0.01
# mapping, card float32 vs CPU float64: the reference's own cross-backend
# gates (tools/selfcheck.py POS_TOL_M, N_MATCH_TOL), calibrated there on a
# benign floor of 1.0-1.5 cm and up to 3.7% of matches, which comes from
# float32 reassociation in the map build feeding tie-sensitive 5-NN
# selection
MAP_CPU_POS_TOL_M = 0.05
MAP_CPU_MATCH_TOL = 0.10
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, and the float32
# rate outside the tensor cores, used for the kernels' scalar operations
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def log(msg):
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
    stage(f"ieskf.update, {cfg.num_iter} trips", lambda: ieskf.update(
        prop, feats.flat, feats.sharp, ls, lc, cfg))
    stage(f"GN fallback, {cfg.num_iter} trips",
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


def phase_k1(cfg, data):
    """K1 against its plain version on the card; returns its JSON entry
    (launches filled in by the odometry phase)."""
    import torch

    from lins_tpu_torch.odometry.estimator import scan_pre_vmap
    from lins_tpu_torch.ops import label

    log("== 3. kernels: K1 label_components")
    dev = torch.device("cuda")
    cases = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        cases.append((f"random_masked_seed{seed}",
                       *_random_graph(rng, (K_CHUNK, 16, 1800), True)))
    cases.append(("random_unmasked_seed3",
                  *_random_graph(np.random.default_rng(3),
                                 (K_CHUNK, 16, 1800), False)))
    cases += _edge_cases()
    cases = [(name, *(torch.as_tensor(a, device=dev) for a in arrs))
             for name, *arrs in cases]
    # a real chunk of the main path: scans 2..33 through frontend_pre
    xyz_k = torch.as_tensor(data["scans_xyz"][2:2 + K_CHUNK], device=dev)
    n_k = torch.as_tensor(data["scans_n"][2:2 + K_CHUNK].astype(np.int32),
                          device=dev)
    pre_k = scan_pre_vmap(xyz_k, n_k, cfg)
    real = (pre_k["e_right"], pre_k["e_down"], pre_k["eligible"])
    cases.append(("real_chunk", *real))

    max_err = 0
    for name, er, ed, el in cases:
        got = label.label_components(er, ed, el)
        torch.cuda.synchronize()
        want = label.label_components_plain(er, ed, el)
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"K1 == plain on {name} {tuple(el.shape)} "
              f"({int(el.sum())} eligible cells, "
              f"{int(torch.unique(want[el.bool()]).numel())} components)")

    ms = cuda_ms(lambda: label.label_components(*real), 50)
    plain_ms = cuda_ms(lambda: label.label_components_plain(*real), 3)
    K, L, S = real[2].shape
    cells = K * L * S
    # each input byte read once, each int32 label written once; at least
    # one min per cell and edge direction
    bytes_moved = 3 * cells + 4 * cells
    bound_ms, bound_by = bound(bytes_moved, 4 * cells)
    log(f"  K1 label_components ({K},{L},{S}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bytes_moved} B)")
    return dict(name="label_components", route="cuda",
                source="lins_tpu_torch/csrc/label_components.cu",
                replaces="lins_tpu/ops/pallas_label.py:118",
                launches=None, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _select_case(seed, Q, nb, cap, quantized=False):
    """A random gathered block (Q, nb, 3, cap) with the mapping path's edge
    cases: duplicate points (exact ties), tombstones at the voxel map's
    SENTINEL, an all-invalid row, invalid queries, rows with fewer than C+1
    valid candidates.  `quantized` puts every coordinate on a 0.25 m
    lattice, so many distances tie exactly."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    cand = q[:, None, :, None] + rng.uniform(-2, 2, (Q, nb, 3, cap))
    if quantized:
        q = np.round(q * 4) / 4
        cand = np.round(cand * 4) / 4
    cand = cand.astype(np.float32)
    cand[:, 1, :, :20] = cand[:, 0, :, :20]
    cand[:, :, :, 5] = cand[:, :, :, 4]
    cand[:, 2, :, 30:40] = 1.0e9
    ok = rng.random((Q, nb, cap)) < 0.8
    ok[0] = False
    ok[1:9] = False
    ok[1:9, 0, :7] = True
    qv = rng.random(Q) < 0.95
    qv[9] = False
    return q, qv, cand, ok


def _k3_equal(args, C, what):
    """K3 vs its plain version on the same card tensors, for both d2C
    rules; returns the largest difference of kept distances."""
    import torch

    from lins_tpu_torch.ops import select

    err = 0.0
    for first_dropped in (True, False):
        got = select.select_candidates(*args, C, first_dropped=first_dropped)
        torch.cuda.synchronize()
        want = select.select_candidates_plain(*args, C,
                                              first_dropped=first_dropped)
        names = ("cand", "cand_ok", "d2k", "d2C")
        same = [torch.equal(g, w) for g, w in zip(got, want)]
        fin = torch.isfinite(want[2])
        if fin.any():
            err = max(err, float((got[2][fin] - want[2][fin]).abs().max()))
        check(all(same), f"K3 == plain on {what} (first_dropped="
              f"{first_dropped}; {int(want[1].sum())} kept): "
              + ", ".join(f"{n} {'equal' if s else 'DIFFER'}"
                          for n, s in zip(names, same)))
    return err


def phase_k3_synthetic(C):
    import torch

    log("== 3. kernels: K3 select_candidates")
    dev = torch.device("cuda")
    err = 0.0
    for seed, (Q, nb, cap), quant in ((0, (4096, 8, 216), False),
                                      (1, (512, 27, 216), False),
                                      (2, (4096, 8, 216), True),
                                      (3, (512, 27, 216), True),
                                      (4, (37, 3, 11), False)):
        arrs = _select_case(seed, Q, nb, cap, quant)
        args = [torch.as_tensor(a, device=dev) for a in arrs]
        err = max(err, _k3_equal(args, C, f"random block {(Q, nb, 3, cap)}"
                                 + (" on a lattice" if quant else "")))
    return err


def k3_times(args, C, what):
    """Kernel, plain and library times of K3 at one shape, and its bound.
    All three stop at the same point, the C+1 nearest distances and
    coordinates before the wrapper's finishing ops: the kernel's launch
    (`launch_select`), the plain version's distances, sort and gathers
    (`select_raw_plain`), and torch.topk + three gathers on the same masked
    distances.  The whole wrapper (kernel + finishing ops, as the main path
    calls it) is logged beside them; on a slow host its reading is the
    enqueue rate of its small ops."""
    import torch

    from lins_tpu_torch.ops import select

    query, q_valid, cand, ok = args
    Q, nb, _, cap = cand.shape
    B, R = nb * cap, C + 1
    ms = cuda_ms(lambda: select.launch_select(*args, C), 50)
    wrapper_ms = cuda_ms(lambda: select.select_candidates(*args, C), 50)
    plain_ms = cuda_ms(lambda: select.select_raw_plain(*args, C), 5)
    d2 = select.masked_d2(query, q_valid, cand, ok)
    planes = cand.transpose(1, 2).reshape(Q, 3, B)

    def library():
        d, i = torch.topk(d2, R, dim=1, largest=False)
        return d, [torch.gather(planes[:, k], 1, i) for k in range(3)]

    library_ms = cuda_ms(library, 20)
    # each input read once (3 float32 coordinates and one ok byte per
    # candidate, a query and its flag per row), each output written once
    # (distance and 3 coordinates per kept column); the operations are the
    # distance (8 per candidate) and a compare per candidate and round
    bytes_moved = Q * B * 13 + Q * 13 + Q * R * 16
    ops = Q * B * (8 + R)
    bound_ms, bound_by = bound(bytes_moved, ops)
    log(f"  K3 at {what} {(Q, nb, 3, cap)}, C={C}, up to the C+1 nearest: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.topk "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
        f"{bytes_moved} B, {ops} ops); whole wrapper with its finishing ops "
        f"{wrapper_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bytes=bytes_moved, ops=ops,
                wrapper_ms=wrapper_ms)


def phase_k3_real(slam):
    """K3 against its plain version on real gathers of the final map of
    the mapping run, at the surf and corner query shapes; the JSON entry
    holds the times of one corner + surf gather pair."""
    from lins_tpu_torch.geom import so3
    from lins_tpu_torch.mapping.mapper import downsample_scan
    from lins_tpu_torch.ops.grid_nn import gather_neighbourhood

    log("== 5. K3 on real gathers of the mapping run")
    mapper, args = _mapping_inputs(slam)
    cfg, st = mapper.cfg, mapper.state
    C = cfg.s2m_cand
    sc = downsample_scan(*args[3:9], cfg, *mapper.caps, mapper.dtype)
    t, q = st.aft_pos, st.aft_quat
    err, times = 0.0, []
    for what, pts, ok_q, grid in (
            ("surf", sc.query_surf, sc.query_surf_ok, st.lmap.surf_grid),
            ("corner", sc.query_corner, sc.query_corner_ok,
             st.lmap.corner_grid)):
        query = so3.quat_rotate(q[None], pts) + t
        cand, ok, _ = gather_neighbourhood(query, grid)
        k_args = (query.contiguous(), ok_q.contiguous(), cand, ok)
        err = max(err, _k3_equal(k_args, C, f"the real {what} gather "
                                 f"({int(ok_q.sum())} valid queries)"))
        times.append(k3_times(k_args, C, f"the real {what} gather"))
    tot = {k: sum(x[k] for x in times) for k in times[0]}
    b_ms, b_by = bound(tot["bytes"], tot["ops"])
    log(f"  K3 per corner + surf gather pair: kernel {tot['ms']:.4f} ms, "
        f"plain {tot['plain_ms']:.4f} ms, torch.topk "
        f"{tot['library_ms']:.4f} ms, bound {b_ms:.5f} ms; whole wrapper "
        f"{tot['wrapper_ms']:.4f} ms")
    return dict(name="select_candidates", route="cuda",
                source="lins_tpu_torch/csrc/select_candidates.cu",
                replaces="lins_tpu/ops/pallas_select.py:82",
                launches=None, max_abs_err=err, ms=tot["ms"],
                plain_ms=tot["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=tot["library_ms"])


def phase_k6():
    """K6 on the canary's three shapes: equal to its plain version and to
    torch.topk's values; times at the largest shape.  Returns its JSON
    entry (launches filled in from the main path's runs)."""
    import torch

    from lins_tpu_torch.ops import select

    log("== 3. kernels: K6 topk_smallest")
    dev = torch.device("cuda")
    out = None
    for Q, B, C in ((128, 256, 8), (1024, 1728, 64), (6144, 1728, 64)):
        rng = np.random.default_rng(Q)
        d2 = rng.uniform(0, 100, (Q, B)).astype(np.float32)
        d2[0] = np.inf
        d2[1, ::2] = 3.0
        x = torch.as_tensor(d2, device=dev)
        got = select.topk_smallest(x, C)
        torch.cuda.synchronize()
        want = select.topk_smallest_plain(x, C)
        lib = torch.topk(x, C, dim=1, largest=False).values
        check(torch.equal(got, want) and torch.equal(got, lib),
              f"K6 == plain == torch.topk on ({Q}, {B}), C={C}")
        ms = cuda_ms(lambda: select.topk_smallest(x, C), 50)
        plain_ms = cuda_ms(lambda: select.topk_smallest_plain(x, C), 5)
        library_ms = cuda_ms(
            lambda: torch.topk(x, C, dim=1, largest=False), 20)
        bytes_moved = Q * B * 4 + Q * C * 4
        bound_ms, bound_by = bound(bytes_moved, Q * B * C)
        log(f"  K6 ({Q}, {B}), C={C}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.topk {library_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
        out = dict(name="topk_smallest", route="cuda",
                   source="lins_tpu_torch/csrc/select_candidates.cu",
                   replaces="tools/r4_mosaic_canary.py:24", launches=None,
                   max_abs_err=float((got - want).abs().nan_to_num().max()),
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)
    return out


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


def measure_rate(cfg, data, mapping):
    """Scans/s as bench.py times it (bench_slam with mapping, the odometry
    loop without): WARMUP_SCANS streamed, the rest staged in chunks of
    K_CHUNK; a warm chunk 0, then chunks 1..N_CHUNKS each between
    torch.cuda.synchronize() fences.  The warm chunk runs in PyTorch's sync
    debug mode, which stays out of the timed chunks.  Returns (scans/s,
    seconds per timed chunk, host syncs of the warm chunk, their call
    sites)."""
    import torch

    from lins_tpu_torch.slam import LinsSlam

    slam = LinsSlam(cfg, enable_mapping=mapping)
    jobs, _ = slam.stage_replay(data, chunk=K_CHUNK,
                                min_streamed=WARMUP_SCANS)
    torch.cuda.synchronize()
    with count_host_syncs() as sites:
        slam.run_chunk(jobs[0])
    torch.cuda.synchronize()
    chunk_s = []
    for job in jobs[1:N_CHUNKS + 1]:
        t0 = time.perf_counter()
        slam.run_chunk(job)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    return (N_CHUNKS * K_CHUNK / sum(chunk_s), chunk_s, sum(sites.values()),
            sites)


def _reset_counts():
    from lins_tpu_torch.ops import label, select

    for fn in (label.label_components, select.select_candidates,
               select.topk_smallest):
        fn.launches = 0
    for fn in (label.label_components_plain, select.select_candidates_plain,
               select.topk_smallest_plain):
        fn.calls = 0


def _counts():
    from lins_tpu_torch.ops import label, select

    return dict(label=label.label_components.launches,
                label_plain=label.label_components_plain.calls,
                select=select.select_candidates.launches,
                select_plain=select.select_candidates_plain.calls,
                topk=select.topk_smallest.launches)


def log_rate(what, rate, chunk_s, syncs, sites):
    log(f"  {what}: {rate:.3f} scans/s over chunks 1-{N_CHUNKS} "
        f"({K_CHUNK} scans each; per chunk "
        + ", ".join(f"{s:.3f}" for s in chunk_s) + " s)")
    log(f"  host syncs in the warm chunk: {syncs}"
        + "".join(f"; {n} at {site}" for site, n in sites.most_common(5)))


def phase_odometry(cfg, data):
    import torch

    from lins_tpu_torch.slam import LinsSlam
    from lins_tpu_torch.utils.trajectory import ate

    log("== 4. main path: odometry")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    slam = LinsSlam(cfg, enable_mapping=False)
    slam.run_replay(data, chunk=K_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    ts, ps, qs = slam.trajectory_arrays()
    n_chunks = (N_SCANS - 2) // K_CHUNK
    log(f"  run_replay: {len(ps)} poses in {wall:.2f} s; launch counts "
        f"{counts}")
    check(len(ps) == N_SCANS - 1, "one pose per scan after the first")
    check(counts["label"] >= n_chunks,
          f"label kernel launched {counts['label']} times >= {n_chunks} "
          f"chunks")
    check(counts["label_plain"] == 0, "no plain-label fallback on the card")
    check(bool(np.isfinite(ps).all() and np.isfinite(qs).all()),
          "every pose finite")
    err = ate(ps, data["gt_pos"][1:1 + len(ps)], align=True)
    check(err <= ATE_LIMIT_M,
          f"odometry ATE {err:.4f} m <= {ATE_LIMIT_M} m ({len(ps)} scans)")
    peak = torch.cuda.max_memory_allocated()
    # timed before any profiling: once torch.profiler has run, later eager
    # work in the same process runs slower (PERF.md)
    rate, chunk_s, syncs, sites = measure_rate(cfg, data, mapping=False)
    log_rate("odometry", rate, chunk_s, syncs, sites)
    log(f"  peak device memory of the replay: {peak / 2**20:.1f} MiB")
    return dict(launches=counts["label"], topk=counts["topk"], ate=err,
                rate=rate, ps=ps, syncs_per_chunk=syncs, peak_bytes=peak)


def phase_mapping(cfg, data, odo_ate):
    import torch

    from lins_tpu_torch.slam import LinsSlam
    from lins_tpu_torch.utils.trajectory import ate

    log("== 5. main path: odometry + mapping (recent window, no loop "
        "attempts)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    slam = LinsSlam(cfg, enable_mapping=True)
    slam.run_replay(data, chunk=K_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    ts, ps, qs = slam.trajectory_arrays()
    metrics = [{k: float(v) for k, v in m.items()}
               for m in slam.mapper.metrics]
    n_steps = len(metrics)
    n_gn = n_steps - 1              # every step after the first has a map
    log(f"  run_replay: {len(ps)} fused poses, {n_steps} mapping steps "
        f"({int(sum(m['keyframe_added'] for m in metrics))} keyframes) in "
        f"{wall:.2f} s; launch counts {counts}")
    log("  per mapping step: iters "
        + str([int(m["iters"]) for m in metrics]) + "; matches "
        + str([int(m["n_matches"]) for m in metrics]) + "; re-gathers "
        + str([int(m["n_refresh"]) for m in metrics]))
    check(len(ps) == N_SCANS - 1, "one fused pose per scan after the first")
    check(counts["select"] >= 2 * n_gn,
          f"K3 launched {counts['select']} times >= 2 per mapping step "
          f"against a map ({n_gn} steps; "
          f"{counts['select'] / max(n_gn, 1):.1f} per step)")
    check(counts["select_plain"] == 0, "no plain selection on the card")
    check(counts["label"] > 0 and counts["label_plain"] == 0,
          f"K1 launched {counts['label']} times, no plain labelling")
    check(not any(m["query_overflow"] for m in metrics),
          "no query cap dropped points")
    check(bool(np.isfinite(ps).all() and np.isfinite(qs).all()),
          "every fused pose finite")
    err = ate(ps, data["gt_pos"][1:1 + len(ps)], align=True)
    check(err <= odo_ate and err <= ATE_LIMIT_M,
          f"fused ATE {err:.4f} m <= odometry ATE {odo_ate:.4f} m and <= "
          f"{ATE_LIMIT_M} m ({len(ps)} scans)")
    log(f"  peak device memory of the replay: {peak / 2**20:.1f} MiB")
    rate, chunk_s, syncs, sites = measure_rate(cfg, data, mapping=True)
    log_rate("SLAM with mapping", rate, chunk_s, syncs, sites)
    return dict(slam=slam, launches=counts["select"], topk=counts["topk"],
                ate=err, rate=rate, ps=ps, metrics=metrics,
                syncs_per_chunk=syncs, peak_bytes=peak)


def phase_profiles(cfg, data, map_slam):
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


def phase_cpu_map_check(cfg, data, card_ps, card_metrics):
    import torch

    from lins_tpu_torch.slam import LinsSlam

    log("== 7. CPU cross-check: odometry + mapping")
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    from lins_tpu_torch.config import VLP16
    from lins_tpu_torch.datasets.synthetic import generate_sequence

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    cfg = VLP16.replace(max_points=28800, use_pallas=True)
    cfg_map = cfg.replace(use_pallas_select=True, loop_attempts=False)
    t0 = time.perf_counter()
    data = generate_sequence(cfg, n_scans=N_SCANS, kind="gentle", speed=1.5)
    log(f"  (set-up: {N_SCANS} synthetic scans in "
        f"{time.perf_counter() - t0:.1f} s)")
    k1 = phase_k1(cfg, data)
    k3_err = phase_k3_synthetic(cfg_map.s2m_cand)
    k6 = phase_k6()
    odo = phase_odometry(cfg, data)
    mp = phase_mapping(cfg_map, data, odo["ate"])
    k3 = phase_k3_real(mp["slam"])
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_err)
    k1["launches"] = odo["launches"]
    k3["launches"] = mp["launches"]
    # K6 is the canary's kernel, off both main paths: its count, read after
    # each run as the others are, must stay 0 until a path calls it
    k6["launches"] = odo["topk"] + mp["topk"]
    check(k6["launches"] == 0, f"K6 launched {odo['topk']} times in the "
          f"odometry run and {mp['topk']} in the mapping run (off the path)")
    phase_profiles(cfg, data, mp["slam"])
    diff = phase_cpu_check(cfg, data, odo["ps"])
    mdiff, mrel = phase_cpu_map_check(cfg_map, data, mp["ps"],
                                      mp["metrics"])
    log(f"  summary on {smi}: odometry {odo['rate']:.3f} scans/s, ATE "
        f"{odo['ate']:.4f} m, card-vs-CPU {diff:.6f} m; with mapping "
        f"{mp['rate']:.3f} scans/s, fused ATE {mp['ate']:.4f} m, card-vs-CPU "
        f"{mdiff:.6f} m and matches {mrel:.4f}; host syncs per chunk "
        f"{odo['syncs_per_chunk']} / {mp['syncs_per_chunk']}; peak "
        f"{odo['peak_bytes'] / 2**20:.1f} / {mp['peak_bytes'] / 2**20:.1f} "
        f"MiB; script {time.perf_counter() - t_start:.1f} s")
    kernels = [k1, k3, k6]
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

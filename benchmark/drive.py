"""What every mode shares: the drives a traffic mix describes, made on the
device from the seed; a `LinsSlam` built as a user builds one; and the
port's outputs of a drive, read to the host once the window has closed."""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generator


def round_mantissa(x, bits: int):
    """float32 values rounded to `bits` mantissa bits (nearest, ties
    away): what a narrower float keeps (10 bits: TF32)."""
    x = np.ascontiguousarray(x, np.float32).copy()
    i = x.view(np.int32)
    drop = 23 - bits
    i[...] = (((i.astype(np.int64) + (1 << (drop - 1))) >> drop) << drop
              ).astype(np.int32)
    return x


class Context:
    """A run: the cell, its port configuration, the seed and window, the
    tracer, the control (None; "tf32": TF32 on in the port's matmuls;
    "tf32-clouds": that, and the scans rounded to TF32's mantissa) and the
    fault planted under the timed path (None, or one of FAULTS)."""

    def __init__(self, cell, cfg, seed, seconds, tracer, device,
                 control=None, fault=None, n_scans=None):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.seconds, self.tracer, self.device = seconds, tracer, device
        self.traffic = cell.traffic
        self.control = control
        self.fault = fault
        self.n_scans = n_scans or self.traffic["drive_scans"]
        self.t_window = None
        self.profiled = None
        self.marks = []

    def mark(self, name: str):
        """The end of a stage of set-up (ignored once the window is open)."""
        if self.t_window is None:
            self.marks.append((name, time.time()))

    def setup_marks(self, t_process: float) -> list:
        """[[stage, seconds]] of set-up, from the process's start."""
        out, t = [], t_process
        for name, t1 in self.marks:
            out.append([name, round(t1 - t, 3)])
            t = t1
        return out

    # ------------------------------------------------------------ drives
    def make_drive(self, stream: int = 0, speed: float | None = None):
        """One drive of the mix, from the seed (the IMU noise; stream b of
        a multi-stream mix draws seed + b), made on the device."""
        d = dict(self.traffic["drive"])
        if speed is not None:
            d["speed"] = speed
        data = generator.generate_sequence(
            self.cfg, n_scans=self.n_scans, kind=d["kind"],
            speed=d["speed"], world=generator.WORLDS[d["world"]](),
            imu_rate=d["imu_rate"], ba=d["ba"], bw=d["bw"],
            acc_noise=d["acc_noise"], gyr_noise=d["gyr_noise"],
            seed=(self.seed + stream) % 2 ** 63,
            loop_scale=d["loop_scale"], device=self.device)
        if self.control == "tf32-clouds":
            data["scans_xyz"] = round_mantissa(data["scans_xyz"], 10)
        return data

    def done_generating(self):
        """The generator's temporaries are not the port's: the peak starts
        here."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.mark("drive made")

    # -------------------------------------------------------------- port
    def new_slam(self):
        """A LinsSlam as a user builds one for a drive (its kernels built
        or loaded by `warmup`)."""
        from lins_tpu_torch.slam import LinsSlam

        slam = LinsSlam(self.cfg, device=self.device)
        if self.control:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        slam.warmup()
        if self.fault in ("frozen", "altered", "loopedge"):
            plant(slam, self.fault)
        self.mark("LinsSlam and warmup")
        return slam

    # ------------------------------------------------------------ window
    def start_window(self):
        """Open the window."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.mark("bootstrap and warm-up")
        self.tracer.phase = "window"
        self.t_window = time.perf_counter()
        self.t_window_wall = time.time()
        return self.t_window

    def window_open(self) -> bool:
        return time.perf_counter() - self.t_window < self.seconds


# faults the correctness tests plant under the timed path, to see
# `correct` come out false: "frozen", every odometry step returns the state
# it was given (its outputs computed, its state unchanged); "altered", one
# fused pose in every chunk or every tenth scan moved by ALTER_M where the
# mapper produces it; "half" (benchmark/modes/multistream.py), half of
# the streams left out of the batched step; "loopedge", every measured
# loop edge's translation moved by ALTER_M along x where the loop closure
# produces it (for the whole process)
FAULTS = ("frozen", "altered", "half", "loopedge")
ALTER_M = 2.0


def plant(slam, fault):
    """Plant `fault` in this LinsSlam's odometry or mapper (instance
    attributes; nothing of the port changes)."""
    from lins_tpu_torch.odometry.estimator import STATUS_RUNNING

    odo, mapper = slam.odometry, slam.mapper
    if fault == "frozen":
        def frozen(inner):
            def call(*args, **kw):
                if odo.status != STATUS_RUNNING:
                    return inner(*args, **kw)
                keep = (odo.filter_state, odo.global_state, odo.last_surf,
                        odo.last_corner)
                out = inner(*args, **kw)
                (odo.filter_state, odo.global_state, odo.last_surf,
                 odo.last_corner) = keep
                return out
            return call

        odo.add_scan = frozen(odo.add_scan)
        odo.add_scan_chunk = frozen(odo.add_scan_chunk)
    elif fault == "altered":
        chunk = mapper.process_chunk
        process = mapper.process

        def altered_chunk(*args, **kw):
            pos, quat = chunk(*args, **kw)
            return pos + torch.where(
                torch.arange(len(pos), device=pos.device)[:, None] == 0,
                ALTER_M, 0.0), quat

        def altered_step(*args, **kw):
            out = process(*args, **kw)
            if out is not None and len(mapper.metrics) % 3 == 0:
                mapper.state = mapper.state._replace(
                    aft_pos=mapper.state.aft_pos + ALTER_M)
            return out

        mapper.process_chunk = altered_chunk
        mapper.process = altered_step
    elif fault == "loopedge":
        from lins_tpu_torch.graph import loop_closure as lc

        inner = lc.try_close_loop
        if getattr(inner, "planted", False):
            return

        def wrong_edge(*args, **kw):
            idx, found, accepted, t_rel, q_rel, fitness, corr_t = inner(
                *args, **kw)
            shift = torch.zeros_like(t_rel)
            shift[0] = ALTER_M
            return (idx, found, accepted, t_rel + shift, q_rel, fitness,
                    corr_t)

        wrong_edge.planted = True
        lc.try_close_loop = wrong_edge


def scan_index(t_end, period):
    """The drive's scan index of a scan-end time."""
    return int(round(float(t_end) / period)) - 1


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def slam_outputs(slam, data, clouds, period):
    """One drive's outputs on the host: fused and odometry poses by scan
    index, the surf clouds captured during the run, the loop edges and
    the number of accepted loops.  `clouds`: [(first scan index, xyz
    (K, N, 3) or (N, 3), valid)] device references."""
    ts, ps, qs = slam.trajectory_arrays()
    fused = [(scan_index(t, period), p, q) for t, p, q in zip(ts, ps, qs)]
    ots, ops, oqs = slam.odometry.trajectory_arrays()
    odo = [(scan_index(t, period), p, q) for t, p, q in zip(ots, ops, oqs)]
    surf = []
    for i0, xyz, valid in clouds:
        xyz, valid = host(xyz), host(valid)
        if xyz.ndim == 2:
            surf.append((i0, xyz, valid))
        else:
            surf.extend((i0 + k, xyz[k], valid[k]) for k in range(len(xyz)))
    edges, loops = [], 0
    if slam.mapper is not None:
        st = slam.mapper.state
        loops = int(st.n_loops)
        e = st.edges
        n = int(e.count)
        ei, ej, et, ev = (host(x)[:n] for x in (e.i, e.j, e.t, e.valid))
        kf_id, kf_t = host(st.store.kf_id), host(st.store.time)
        when = {int(k): float(t) for k, t in zip(kf_id, kf_t) if k >= 0}
        for a, b, tr, ok in zip(ei, ej, et, ev):
            if ok and abs(int(b) - int(a)) != 1 and int(a) in when \
                    and int(b) in when:
                edges.append((when[int(a)], when[int(b)], tr))
    return dict(data=data, fused=fused, odo=odo, surf=surf, edges=edges,
                loops=loops)

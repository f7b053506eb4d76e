"""ROS-free rosbag decoding (a copy of `lins_tpu/datasets/bag.py`): native
C++ fast path + pure-Python fallback.

Offline decoding of sensor_msgs/Imu and sensor_msgs/PointCloud2 into the
packed host arrays the pipeline consumes (the reference's online ROS
transport + `rosbag play` driver, SURVEY.md C2/C18/C27).  The C++ decoder
is the repository's `native/bagreader.cpp`, which this module only reads:
it compiles it with g++ on first use into
`lins_tpu_torch/_build/libbagreader.so`, beside the port's CUDA kernels,
and writes nothing under `native/`.  The Python parser is the reference
implementation used to cross-check it in tests.

Both support uncompressed (compression=none) bags; `rosbag decompress`
handles the rest offline.
"""
from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import tempfile
from dataclasses import dataclass, field

import numpy as np

from lins_tpu_torch.ops.build import _PKG, BUILD

NATIVE_SOURCE = os.path.join(os.path.dirname(_PKG),
                             "native", "bagreader.cpp")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


@dataclass
class BagData:
    imu_times: np.ndarray = field(default_factory=lambda: np.zeros(0))
    imu_acc: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    imu_gyr: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    cloud_times: list = field(default_factory=list)
    clouds: list = field(default_factory=list)      # each (N,3) float32
    rings: list = field(default_factory=list)       # each (N,) int32 or None


# ---------------------------------------------------------------------------
# Native path
# ---------------------------------------------------------------------------

def _build_native() -> str | None:
    """The decoder library, compiled from NATIVE_SOURCE into BUILD when
    missing or older than its source (a temporary file renamed into place,
    so concurrent builders never load a half-written library); None when
    g++ fails or is missing."""
    so = os.path.join(BUILD, "libbagreader.so")
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(NATIVE_SOURCE)):
        return so
    try:
        os.makedirs(BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        try:
            subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o",
                            tmp, NATIVE_SOURCE], check=True,
                           capture_output=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except Exception:
        return None
    return so


_lib = None


def _load_native():
    global _lib
    if _lib is not None:
        return _lib
    so = _build_native()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.bag_open.restype = ctypes.c_void_p
    lib.bag_open.argtypes = [ctypes.c_char_p] * 3
    lib.bag_error.restype = ctypes.c_char_p
    lib.bag_error.argtypes = [ctypes.c_void_p]
    lib.bag_num_imu.argtypes = [ctypes.c_void_p]
    lib.bag_num_clouds.argtypes = [ctypes.c_void_p]
    lib.bag_get_imu.argtypes = [ctypes.c_void_p] + [
        np.ctypeslib.ndpointer(np.float64)] * 3
    lib.bag_cloud_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bag_cloud_time.restype = ctypes.c_double
    lib.bag_cloud_time.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bag_get_cloud.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32),
        np.ctypeslib.ndpointer(np.int32)]
    lib.bag_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def read_bag_native(path: str, imu_topic: str, cloud_topic: str) -> BagData:
    lib = _load_native()
    if lib is None:
        raise RuntimeError("native bagreader unavailable (g++ build failed)")
    h = lib.bag_open(path.encode(), imu_topic.encode(), cloud_topic.encode())
    if not h:
        raise IOError(f"cannot open bag: {path}")
    try:
        err = lib.bag_error(h).decode()
        if err:
            raise RuntimeError(f"bagreader: {err}")
        n_imu = lib.bag_num_imu(h)
        out = BagData()
        out.imu_times = np.zeros(n_imu)
        out.imu_acc = np.zeros((n_imu, 3))
        out.imu_gyr = np.zeros((n_imu, 3))
        if n_imu:
            lib.bag_get_imu(h, out.imu_times, out.imu_acc, out.imu_gyr)
        for k in range(lib.bag_num_clouds(h)):
            n = lib.bag_cloud_size(h, k)
            xyz = np.zeros((n, 3), np.float32)
            ring = np.zeros(n, np.int32)
            if n:
                lib.bag_get_cloud(h, k, xyz, ring)
            out.cloud_times.append(lib.bag_cloud_time(h, k))
            out.clouds.append(xyz)
            out.rings.append(ring)
        return out
    finally:
        lib.bag_close(h)


# ---------------------------------------------------------------------------
# Pure-Python reference parser
# ---------------------------------------------------------------------------

def _parse_header(buf: bytes) -> dict:
    out = {}
    off = 0
    while off + 4 <= len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        fb = buf[off:off + flen]
        off += flen
        name, _, val = fb.partition(b"=")
        out[name.decode()] = val
    return out


def _iter_records(buf: bytes):
    off = 0
    while off + 4 <= len(buf):
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


def _parse_imu_msg(d: bytes, t: float):
    off = 12
    (slen,) = struct.unpack_from("<I", d, off)
    off += 4 + slen
    off += 13 * 8  # orientation + covariance
    gyr = np.frombuffer(d, np.float64, 3, off)
    off += 12 * 8
    acc = np.frombuffer(d, np.float64, 3, off)
    return t, np.asarray(acc), np.asarray(gyr)


def _parse_cloud_msg(d: bytes, t: float):
    off = 12
    (slen,) = struct.unpack_from("<I", d, off)
    off += 4 + slen
    height, width, nfields = struct.unpack_from("<III", d, off)
    off += 12
    fields = {}
    for _ in range(nfields):
        (nl,) = struct.unpack_from("<I", d, off)
        off += 4
        name = d[off:off + nl].decode()
        off += nl
        foff, dt, cnt = struct.unpack_from("<IBI", d, off)
        off += 9
        fields[name] = (foff, dt)
    off += 1
    point_step, row_step = struct.unpack_from("<II", d, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", d, off)
    off += 4
    raw = d[off:off + dlen]
    n = min(height * width, len(raw) // point_step if point_step else 0)
    xyz = np.zeros((n, 3), np.float32)
    for k, ax in enumerate("xyz"):
        o = fields[ax][0]
        xyz[:, k] = np.frombuffer(
            np.frombuffer(raw[:n * point_step], np.uint8)
            .reshape(n, point_step)[:, o:o + 4].tobytes(), np.float32)
    ring = None
    if "ring" in fields:
        o, dt = fields["ring"]
        w = 2 if dt == 4 else 4
        npdt = {4: np.uint16, 5: np.int32, 6: np.uint32}.get(dt)
        if npdt is not None:
            ring = np.frombuffer(
                np.frombuffer(raw[:n * point_step], np.uint8)
                .reshape(n, point_step)[:, o:o + w].tobytes(),
                npdt).astype(np.int32)
    return t, xyz, ring


def read_bag_python(path: str, imu_topic: str, cloud_topic: str) -> BagData:
    with open(path, "rb") as f:
        buf = f.read()
    magic = b"#ROSBAG V2.0\n"
    if not buf.startswith(magic):
        raise IOError("not a rosbag 2.0 file")
    out = BagData()
    conn_topic = {}
    imu_rows = []

    def handle(records, depth=0):
        for header, data in records:
            op = header.get("op", b"\x00")[0]
            if op == 0x07:
                (conn,) = struct.unpack("<I", header["conn"])
                conn_topic[conn] = header["topic"].decode()
            elif op == 0x02:
                (conn,) = struct.unpack("<I", header["conn"])
                secs, nsecs = struct.unpack("<II", header["time"])
                t = secs + 1e-9 * nsecs
                topic = conn_topic.get(conn)
                if topic == imu_topic:
                    imu_rows.append(_parse_imu_msg(data, t))
                elif topic == cloud_topic:
                    ct, xyz, ring = _parse_cloud_msg(data, t)
                    out.cloud_times.append(ct)
                    out.clouds.append(xyz)
                    out.rings.append(ring)
            elif op == 0x05 and depth < 2:
                comp = header.get("compression", b"none").decode()
                if comp != "none":
                    raise RuntimeError(
                        f"compressed chunk ({comp}); run rosbag decompress")
                handle(_iter_records(data), depth + 1)

    handle(_iter_records(buf[len(magic):]))
    if imu_rows:
        out.imu_times = np.asarray([r[0] for r in imu_rows])
        out.imu_acc = np.stack([r[1] for r in imu_rows])
        out.imu_gyr = np.stack([r[2] for r in imu_rows])
    return out


def read_bag(path: str, imu_topic: str = "/imu/data",
             cloud_topic: str = "/velodyne_points",
             prefer_native: bool = True) -> BagData:
    if prefer_native and _load_native() is not None:
        return read_bag_native(path, imu_topic, cloud_topic)
    return read_bag_python(path, imu_topic, cloud_topic)


def bag_to_sequence(data: BagData, cfg) -> dict:
    """Convert decoded bag data into the runner's sequence dict layout."""
    n = len(data.clouds)
    scans = np.zeros((n, cfg.max_points, 3), np.float32)
    counts = np.zeros(n, np.int32)
    for k, xyz in enumerate(data.clouds):
        good = np.isfinite(xyz).all(axis=1)
        pts = xyz[good][: cfg.max_points]
        scans[k, : len(pts)] = pts
        counts[k] = len(pts)
    return dict(
        scans_xyz=scans, scans_n=counts,
        scan_times=np.asarray(data.cloud_times) - cfg.scan_period,
        imu_times=data.imu_times, imu_acc=data.imu_acc, imu_gyr=data.imu_gyr)

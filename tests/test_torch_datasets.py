"""Port parity for the dataset loaders, lins_tpu_torch against lins_tpu:

  * a rosbag written by tests/test_bag.py's writer decodes to the
    reference's BagData with both parsers (native and Python), and
    `bag_to_sequence` gives equal arrays;
  * the port's native reader is compiled from the repository's
    native/bagreader.cpp into the port's build directory, and nothing
    under native/ changes;
  * a KITTI mini-sequence in the KITTI layout (as tests/test_kitti.py lays
    it out, with a turning trajectory and a calibration file) loads to the
    reference's arrays, the synthesised IMU within 1e-9 in float64."""
import os
import pathlib

import numpy as np
import pytest
import torch

from lins_tpu.config import HDL64, VLP16
from lins_tpu.datasets import bag as jbag
from lins_tpu.datasets import kitti as jkitti
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.datasets import bag as tbag
from lins_tpu_torch.datasets import kitti as tkitti
from lins_tpu_torch.ops import build
from test_bag import write_test_bag

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bag_file(tmp_path_factory):
    rng = np.random.default_rng(5)
    imu = [(100.0 + 0.0025 * i, rng.normal(0, 1, 3) + [0, 0, 9.81],
            rng.normal(0, 0.1, 3)) for i in range(60)]
    clouds = []
    for k in range(4):
        n = 300 + 23 * k
        xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        xyz[::37] = np.nan                 # dropped by bag_to_sequence
        clouds.append((100.05 + 0.1 * k, xyz, rng.integers(0, 16, n)))
    p = tmp_path_factory.mktemp("bags") / "test.bag"
    write_test_bag(str(p), imu, clouds)
    return str(p)


def _native_listing():
    return {p.name: p.stat().st_mtime_ns for p in (ROOT / "native").iterdir()}


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The port's native reader built afresh (into a temporary build
    directory), with native/'s listing and mtimes before and after."""
    before = _native_listing()
    assert tbag.BUILD == build.BUILD
    with pytest.MonkeyPatch.context() as mp:
        out = tmp_path_factory.mktemp("build")
        mp.setattr(tbag, "BUILD", str(out))
        mp.setattr(tbag, "_lib", None)
        lib = tbag._load_native()
        yield lib, out, before, _native_listing()


def test_native_builds_into_the_ports_build_dir(native_lib):
    lib, out, before, after = native_lib
    assert pathlib.Path(build.BUILD) == ROOT / "lins_tpu_torch" / "_build"
    assert tbag.NATIVE_SOURCE == str(ROOT / "native" / "bagreader.cpp")
    assert lib is not None
    assert sorted(p.name for p in out.iterdir()) == ["libbagreader.so"]
    assert after == before


def _assert_bags_equal(got, want):
    np.testing.assert_array_equal(got.imu_times, want.imu_times)
    np.testing.assert_array_equal(got.imu_acc, want.imu_acc)
    np.testing.assert_array_equal(got.imu_gyr, want.imu_gyr)
    assert got.cloud_times == want.cloud_times
    assert len(got.clouds) == len(want.clouds) == 4
    for a, b in zip(got.clouds, want.clouds):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.rings, want.rings):
        np.testing.assert_array_equal(a, b)


def test_python_parser_matches(bag_file):
    _assert_bags_equal(tbag.read_bag_python(bag_file, "/imu/data",
                                            "/velodyne_points"),
                       jbag.read_bag_python(bag_file, "/imu/data",
                                            "/velodyne_points"))


def test_native_parser_matches(bag_file, native_lib):
    want = jbag.read_bag_python(bag_file, "/imu/data", "/velodyne_points")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbag, "_lib", native_lib[0])
        got = tbag.read_bag_native(bag_file, "/imu/data", "/velodyne_points")
        _assert_bags_equal(got, want)
        _assert_bags_equal(tbag.read_bag(bag_file), want)


def test_bag_to_sequence(bag_file):
    cfg = VLP16.replace(max_points=320)
    raw = jbag.read_bag_python(bag_file, "/imu/data", "/velodyne_points")
    want = jbag.bag_to_sequence(raw, cfg)
    got = tbag.bag_to_sequence(
        tbag.read_bag_python(bag_file, "/imu/data", "/velodyne_points"),
        SlamConfig.from_dict(cfg.to_dict()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["scans_n"].tolist() == [291, 314, 320, 320]


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Six scans in the KITTI layout along a turning, climbing track, with
    a velodyne -> cam0 calibration."""
    root = tmp_path_factory.mktemp("kitti")
    seq = root / "sequences" / "04"
    (seq / "velodyne").mkdir(parents=True)
    (root / "poses").mkdir()
    rng = np.random.default_rng(0)
    n_scans, n_pts = 6, 1500
    times = np.arange(n_scans) * 0.1
    np.savetxt(seq / "times.txt", times)
    for k in range(n_scans):
        pts = np.zeros((n_pts, 4), np.float32)
        pts[:, :3] = rng.uniform(-30, 30, (n_pts, 3))
        pts[5, :3] = np.inf                   # dropped by the loader
        pts[:, 3] = rng.uniform(0, 1, n_pts)
        pts.tofile(seq / "velodyne" / f"{k:06d}.bin")
    poses = np.zeros((n_scans, 12))
    for k in range(n_scans):
        a = 0.2 * k
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]]
        T[:3, 3] = [1.5 * k * 0.1, 0.3 * k * k * 0.01, 0.05 * k]
        poses[k] = T[:3, :].reshape(-1)
    np.savetxt(root / "poses" / "04.txt", poses)
    (seq / "calib.txt").write_text(
        "P0: 1 0 0 0 0 1 0 0 0 0 1 0\n"
        "Tr: 0 -1 0 0.1 0 0 -1 -0.05 1 0 0 -0.2\n")
    return str(root)


@pytest.mark.parametrize("max_scans", [None, 4])
def test_kitti_sequence(kitti_root, max_scans):
    cfg = HDL64.replace(max_points=1024)
    want = jkitti.load_sequence(kitti_root, "04", cfg, max_scans=max_scans)
    got = tkitti.load_sequence(kitti_root, "04",
                               SlamConfig.from_dict(cfg.to_dict()),
                               max_scans=max_scans)
    assert set(got) == set(want) >= {"gt_pos", "imu_acc", "imu_gyr"}
    for k in ("scans_xyz", "scans_n", "scan_times", "gt_pos", "imu_times"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("imu_acc", "imu_gyr"):
        assert got[k].dtype == want[k].dtype == np.float64
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9,
                                   err_msg=k)
    assert np.abs(got["imu_gyr"]).max() > 0.5          # it turned
    assert got["scans_n"].tolist() == [1024] * len(got["scans_n"])


def test_kitti_readers(kitti_root):
    seq = os.path.join(kitti_root, "sequences", "04")
    f = os.path.join(seq, "velodyne", "000002.bin")
    np.testing.assert_array_equal(tkitti.read_velodyne_bin(f),
                                  jkitti.read_velodyne_bin(f))
    np.testing.assert_array_equal(tkitti.read_times(seq),
                                  jkitti.read_times(seq))
    poses = os.path.join(kitti_root, "poses", "04.txt")
    calib = os.path.join(seq, "calib.txt")
    for c in (None, calib):
        np.testing.assert_array_equal(tkitti.read_poses(poses, c),
                                      jkitti.read_poses(poses, c))

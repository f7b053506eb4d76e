"""The benchmark's frozen drive generator makes the port's drives, value
for value, at the TINY size."""
import numpy as np
import pytest

from benchmark import generator
from lins_tpu_torch.config import TINY
from lins_tpu_torch.datasets import synthetic

DRIVES = {
    "gentle": dict(kind="gentle", speed=1.5, acc_noise=0.01,
                   gyr_noise=0.001, seed=2 ** 31 + 7),
    "circuit": dict(kind="loop", speed=2.2, loop_scale=0.32, acc_noise=0.02,
                    gyr_noise=0.002, ba=(0.05, -0.03, 0.02),
                    bw=(0.002, -0.001, 0.0015), seed=3),
}


@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_frozen_generator_equals_the_ports(drive):
    kw = DRIVES[drive]
    want = synthetic.generate_sequence(TINY, n_scans=9, device="cpu", **kw)
    got = generator.generate_sequence(TINY, n_scans=9, device="cpu", **kw)
    for key, value in want.items():
        if key == "pose_fn":
            continue
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_the_seed_changes_only_the_imu_noise():
    a = generator.generate_sequence(TINY, n_scans=3, device="cpu",
                                    **DRIVES["gentle"])
    b = generator.generate_sequence(TINY, n_scans=3, device="cpu",
                                    **dict(DRIVES["gentle"], seed=5))
    np.testing.assert_array_equal(a["scans_xyz"], b["scans_xyz"])
    assert not np.array_equal(a["imu_acc"], b["imu_acc"])
    assert a["imu_acc"].shape == b["imu_acc"].shape

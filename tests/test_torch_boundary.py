"""The port's boundary: lins_tpu_torch and chip_smoke.py import neither JAX
nor the reference package; its entry points run on the card unless the
caller asks for the CPU; its config is the reference package's, field for
field."""
import ast
import dataclasses
import importlib
import pathlib

import pytest
import torch

from lins_tpu import config as jconfig
from lins_tpu_torch import config as tconfig

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "lins_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "lins_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    bad = [(name, line) for name, line in _imported_tops(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_a_card():
    """Importing builds nothing and needs no CUDA or triton."""
    from lins_tpu_torch.ops import build

    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(p for p in rel.parts if p != "__init__")
        importlib.import_module(name)
    assert not build._loaded


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")


def test_odometry_needs_a_card_by_default():
    _no_card()
    from lins_tpu_torch.odometry import LinsOdometry

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LinsOdometry(tconfig.VLP16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LinsOdometry(tconfig.VLP16, device="cuda")
    assert LinsOdometry(tconfig.VLP16, device="cpu").device.type == "cpu"


def test_slam_needs_a_card_by_default():
    _no_card()
    from lins_tpu_torch.slam import LinsSlam

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LinsSlam(tconfig.VLP16, enable_mapping=False)


def test_generate_sequence_needs_a_card_by_default():
    _no_card()
    from lins_tpu_torch.datasets.synthetic import generate_sequence

    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_sequence(tconfig.TINY, n_scans=1)


def test_tf32_off_once_a_driver_starts():
    from lins_tpu_torch.utils.device import resolve_device

    resolve_device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_config_matches_reference(preset):
    """Same fields and values, so one to_dict() drives both packages."""
    jfields = [f.name for f in dataclasses.fields(jconfig.SlamConfig)]
    tfields = [f.name for f in dataclasses.fields(tconfig.SlamConfig)]
    assert tfields == jfields
    j, t = jconfig.PRESETS[preset], tconfig.PRESETS[preset]
    assert t.to_dict() == j.to_dict()
    assert tconfig.SlamConfig.from_dict(j.to_dict()) == t
    for prop in ("grid_size", "segment_alpha_x", "segment_alpha_y",
                 "acc_noise", "gyr_noise", "acc_walk", "gyr_walk"):
        assert getattr(t, prop) == getattr(j, prop)


def test_config_files(tmp_path):
    y = tmp_path / "cfg.yaml"
    y.write_text("line_num: 16\nnum_iter: 30\nmax_lidar_nums: 200000\n"
                 "init_ba:\n  rows: 3\n  cols: 1\n  dt: d\n"
                 "  data: [-0.015774, 0.143237, -0.0263845]\n"
                 "some_future_knob: 42\n")
    cfg = tconfig.SlamConfig.from_yaml(str(y))
    assert cfg.to_dict() == jconfig.SlamConfig.from_yaml(str(y)).to_dict()
    assert cfg.max_points == 200000
    p = tmp_path / "cfg.json"
    tconfig.VLP16.save_json(str(p))
    assert tconfig.SlamConfig.from_json(str(p)) == tconfig.VLP16
    bad = tmp_path / "bad.yaml"
    bad.write_text("line_num: not_a_number\n")
    with pytest.raises(ValueError, match="line_num"):
        tconfig.SlamConfig.from_yaml(str(bad))


def test_exact_feature_mode_waits():
    """The "exact" feature mode no longer waits: one TINY scan goes through
    the port's front end in that mode on the CPU and gives every feature
    set, finite and within its cap, with the less-flat set made of voxel
    centroids rather than raw points (tests/test_torch_exact.py holds the
    mode to the reference package)."""
    from lins_tpu_torch.datasets.synthetic import generate_sequence
    from lins_tpu_torch.frontend.pipeline import process_cloud

    cfg = tconfig.TINY
    data = generate_sequence(cfg, n_scans=1, device="cpu")
    xyz = torch.as_tensor(data["scans_xyz"][0])
    n = torch.tensor(int(data["scans_n"][0]), dtype=torch.int32)
    feats = {m: process_cloud(xyz, n, cfg.replace(feature_mode=m))[2]
             for m in ("fast", "exact")}
    ex = feats["exact"]
    for name in ex._fields:
        got, cap = getattr(ex, name), getattr(feats["fast"], name)
        assert got.xyz.shape == cap.xyz.shape
        assert bool(torch.isfinite(got.xyz[got.valid]).all())
    assert int(ex.sharp.valid.sum()) > 0 and int(ex.flat.valid.sum()) > 0
    raw = xyz[:int(n)]

    def raw_share(f):
        lf = f.less_flat.xyz[f.less_flat.valid]
        assert int(lf.shape[0]) > 0
        return float((lf[:, None, :] == raw[None]).all(-1).any(-1)
                     .float().mean())

    assert raw_share(feats["fast"]) == 1.0 and raw_share(ex) < 1.0

"""The port's runner, `python -m lins_tpu_torch.run_slam`, on the CPU
against the reference package's `run_slam.py`:

  * every flag of run_slam.py, with the same default (read from its
    source), and the same config transforms;
  * a TINY radius run (`--no-loop-closure`, 8 synthetic scans) writes
    every output file, its summary has the reference runner's keys
    (run_slam.py:268-321), and its trajectory.tum is the run's
    `LinsSlam.trajectory_arrays()`;
  * streaming with checkpoints, and a resume from one;
  * `--multihost` without a coordinator prints the reference runner's
    enrollment line (single process) and runs; without a card the default
    device raises."""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from lins_tpu_torch import run_slam
from lins_tpu_torch.config import TINY
from lins_tpu_torch.utils import trajectory as traj

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the keys run_slam.py's summary.json has with mapping, a ground truth and
# the state dump (run_slam.py:268-321)
SUMMARY_KEYS = {"scans", "elapsed_s", "compile_s", "scans_per_sec",
                "keyframes", "loops", "loops_applied", "state_save_s",
                "ate_rmse_m", "rpe_m", "ate_kf_m"}
OUTPUTS = {"trajectory.tum", "trajectory_kf.tum", "metrics.jsonl",
           "global_map.ply", "final_state.npz", "summary.json",
           "spans.jsonl"}
BASE = ["--device", "cpu", "--preset", "tiny", "--synthetic", "gentle",
        "--scans", "8", "--no-loop-closure", "--map-format", "ply"]


def _reference_flags():
    """{option: default} of every add_argument in run_slam.py's source."""
    tree = ast.parse((ROOT / "run_slam.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            opt = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                d = kw["default"]
                out[opt] = (ast.literal_eval(d) if not isinstance(d, ast.Name)
                            else d.id)
            elif isinstance(kw.get("action"), ast.Constant):
                out[opt] = False
            else:
                out[opt] = None
    return out


def test_every_reference_flag():
    ref = _reference_flags()
    assert len(ref) >= 30 and "--lc-map" in ref
    actions = {a.option_strings[0]: a for a in
               run_slam.build_parser()._actions if a.option_strings}
    for opt, default in ref.items():
        assert opt in actions, opt
        assert actions[opt].default == default, opt
    extra = set(actions) - set(ref) - {"-h"}
    assert extra == {"--device"}
    assert actions["--device"].default == "cuda"


def test_config_transforms():
    """The flags' transforms in the reference runner's order, including
    --feature-scale's rounding to multiples of 128 (at least 128)."""
    args = run_slam.build_parser().parse_args(
        ["--synthetic", "gentle", "--preset", "tiny", "--no-loop-closure",
         "--window-no-loop", "--loop-frac", "0.1", "--loop-fitness", "0.5",
         "--lc-map", "radius", "--loop-rewrite-min", "0.7", "--pallas",
         "--no-pallas-select", "--full-queries", "--feature-scale", "1.3"])
    cfg = run_slam.configure(args)

    def sc(v):
        return max(128, int(-(-v * 1.3 // 128)) * 128)

    want = TINY.replace(
        loop_closure_enabled=True, loop_attempts=False,
        loop_consistency_frac=0.1, history_keyframe_fitness_score=0.5,
        lc_map_mode="radius", loop_rewrite_min_m=0.7, use_pallas=True,
        use_pallas_select=False, map_query_corner=None, map_query_surf=None)
    want = want.replace(
        max_sharp=sc(want.max_sharp), max_less_sharp=sc(want.max_less_sharp),
        max_flat=sc(want.max_flat), max_less_flat=sc(want.max_less_flat),
        max_outlier=sc(want.max_outlier), max_map_corner=sc(
            want.max_map_corner), max_map_surf=sc(want.max_map_surf))
    assert cfg == want
    plain = run_slam.configure(run_slam.build_parser().parse_args(
        ["--synthetic", "gentle", "--feature-scale", "0.01"]))
    assert plain.max_sharp == 128 and plain.map_query_corner == 128


@pytest.fixture(scope="module")
def replay_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("runner")
    args = run_slam.build_parser().parse_args(BASE + ["--out", str(out)])
    slam, summary = run_slam.run(args)
    return out, slam, summary


def test_outputs_and_summary(replay_run):
    out, slam, summary = replay_run
    assert {p.name for p in out.iterdir()} == OUTPUTS
    on_disk = json.loads((out / "summary.json").read_text())
    assert json.dumps(on_disk) == json.dumps(summary)
    assert set(summary) == SUMMARY_KEYS
    assert summary["scans"] == 7 and summary["loops"] == 0
    assert summary["keyframes"] >= 2 and summary["ate_rmse_m"] < 0.25
    assert slam.mapper.state.lmap.sel.max() >= 0       # the radius map ran
    stages = [json.loads(s)["stage"] for s in
              (out / "metrics.jsonl").read_text().splitlines()]
    assert stages.count("odometry") == 6 and stages.count("mapping") >= 2
    ply = (out / "global_map.ply").read_bytes()
    assert ply.startswith(b"ply\nformat binary_little_endian 1.0\n")


def test_trajectory_is_the_runs(replay_run, tmp_path):
    out, slam, _ = replay_run
    ts, ps, qs = slam.trajectory_arrays()
    traj.write_tum(str(tmp_path / "want.tum"), ts, ps, qs)
    assert (out / "trajectory.tum").read_bytes() == (
        tmp_path / "want.tum").read_bytes()
    t, p, _ = traj.read_tum(str(out / "trajectory.tum"))
    assert len(t) == 7 and np.abs(p - ps).max() <= 5e-7
    kf_t, _, _ = traj.read_tum(str(out / "trajectory_kf.tum"))
    assert len(kf_t) == int(slam.mapper.state.store.count)


def test_checkpoints_and_resume(tmp_path, capsys):
    """Streaming with a checkpoint every 4 scans, then a second run resumed
    from the first checkpoint."""
    first, second = tmp_path / "a", tmp_path / "b"
    assert run_slam.main(BASE + ["--checkpoint-every", "4", "--out",
                                 str(first)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == SUMMARY_KEYS
    names = {p.name for p in first.iterdir()}
    assert names == OUTPUTS | {"ckpt_00004.npz", "ckpt_00008.npz"}
    run_slam.main(BASE + ["--stream", "--resume",
                          str(first / "ckpt_00004.npz"), "--no-state",
                          "--map-format", "none", "--out", str(second)])
    summary = json.loads((second / "summary.json").read_text())
    assert set(summary) == SUMMARY_KEYS - {"state_save_s"}
    # it went on after the checkpoint's scan 4: scans 5-8
    assert summary["scans"] == 4
    assert summary["keyframes"] >= 2 and summary["ate_rmse_m"] < 0.25
    t, _, _ = traj.read_tum(str(second / "trajectory.tum"))
    t_first, _, _ = traj.read_tum(str(first / "trajectory.tum"))
    np.testing.assert_array_equal(t, t_first[-4:])


def test_multihost_raises(tmp_path, capsys, monkeypatch):
    """No longer raises: without JAX_COORDINATOR the runner stays a single
    process, prints the enrollment line with the reference runner's keys
    (run_slam.py:132-138), and runs.  (Two enrolled processes:
    tests/test_torch_multihost.py.)"""
    for var in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert run_slam.main(BASE + ["--multihost", "--map-format", "none",
                                 "--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == dict(multihost=False, process_index=0,
                                        process_count=1, global_devices=1)
    assert json.loads(lines[-1])["scans"] == 7


def test_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the runner runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_slam.main(["--preset", "tiny", "--synthetic", "gentle",
                       "--scans", "4", "--out", str(tmp_path)])

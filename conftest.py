"""Marks for every pytest run in this repo.

`slow` and `heavy` (pytest.ini) name the same tests here: the hook below
gives every test that carries either mark, or is named in SLOW, both marks
before `-m` selects.  So the default run (`-m "not heavy"`) and a run with
`-m 'not slow'` leave out the same tests.  Run them as their own shard:

    python -m pytest tests/ -q -m slow -p no:randomly -n 6 --dist loadfile
"""
import pytest

# JAX-package end-to-end tests that each take over two minutes of one CPU
# worker.  They drive only the reference package `lins_tpu`, and the port's
# tests hold the same behaviours (replay against streaming, resume, loop
# closure, the radius map, the multichip dry run, mapping against drift).
# With `--dist loadfile` each file runs whole on one worker, so the longest
# file sets the suite's wall time.
SLOW = (
    "tests/test_slam_integration.py::TestLongHorizon::"
    "test_mapping_bounds_drift",
    "tests/test_slam_integration.py::TestReplayMode::"
    "test_replay_matches_streaming",
    "tests/test_slam_integration.py::TestCheckpointResume::"
    "test_resume_continues_trajectory",
    "tests/test_slam_integration.py::TestLoopClosureEndToEnd::"
    "test_loop_fires_in_full_replay",
    "tests/test_slam_integration.py::TestRadiusMapLoopClosure::"
    "test_loop_fires_with_radius_map",
    "tests/test_parallel.py::TestBatchedReplay::test_dryrun_multichip",
)


def _check_slow_ids(items):
    """Stop the run when an id in SLOW names nothing in its file, once that
    file was collected: a renamed test would otherwise slip back into the
    default run unmarked."""
    modules = {item.nodeid.split("::")[0]: item.module for item in items
               if getattr(item, "module", None) is not None}
    for nodeid in SLOW:
        path, *names = nodeid.split("::")
        obj = modules.get(path)
        if obj is None:
            continue
        for name in names:
            obj = getattr(obj, name, None)
        if obj is None:
            raise pytest.UsageError(f"conftest.py: SLOW names no test: "
                                    f"{nodeid}")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    _check_slow_ids(items)
    for item in items:
        if (item.nodeid in SLOW or item.get_closest_marker("slow")
                or item.get_closest_marker("heavy")):
            item.add_marker(pytest.mark.slow)
            item.add_marker(pytest.mark.heavy)

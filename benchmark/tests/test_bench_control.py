"""The check on the precision of the front end's clouds: the port handed
its scans rounded to TF32's 10-bit mantissa (and, on a card, TF32 on in
its matmuls) must come out not correct, by the front end's late surf
points, while the sound run at the same size is correct.  On the CPU at
the VLP-16 sensor's width, with a short drive; on the card it is read at
the cells' sizes (`--control tf32-clouds`)."""
import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def vlp16_cell():
    cell = harness.load_cell("vlp16-replay")
    cell.traffic = dict(cell.traffic, chunk=8)
    return cell


def _run(cell, **flags):
    old = tiny.SCANS
    tiny.SCANS = 6 + 2 * 8
    try:
        return tiny.run_tiny(cell, seconds=0.1, **flags)[0]
    finally:
        tiny.SCANS = old


def test_control_fails_where_the_program_passes(vlp16_cell):
    sound = _run(vlp16_cell)
    control = _run(vlp16_cell, control="tf32-clouds")
    assert sound["correct"] is True, sound["compared"]
    assert control["correct"] is False, control["compared"]
    s, c = sound["got"]["surf_end_p50_mm"], control["got"]["surf_end_p50_mm"]
    assert c >= 3 * s, (s, c)

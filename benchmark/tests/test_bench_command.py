"""The command itself: without a card it exits 2 and prints no result; on
a card (marked `cuda`) a short run prints the contract's last line."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

CMD = [sys.executable, "benchmark/run.py", "--workload", "vlp16-replay",
       "--seed", str(2 ** 31 + 99)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(CMD + ["--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True)
    assert out.returncode == 2
    assert out.stdout == ""


@pytest.mark.cuda
def test_command_on_the_card(card):
    out = subprocess.run(CMD + ["--seconds", "5", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=360, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "compared"
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["replay_scans_per_s"]["value"] > 0

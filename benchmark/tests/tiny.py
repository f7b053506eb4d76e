"""Cells of BENCHMARK.json shrunk for the CPU: the TINY sensor, chunks of
8 scans, short drives and windows, two streams; the run goes through
`run.execute`, everything of a run but the look for a card."""
from __future__ import annotations

import time

import torch

from benchmark import harness
from benchmark.run import execute, parse

CHUNK = 8
SCANS = 6 + 3 * CHUNK
SEED = 2 ** 31 + 12345     # above 32 signed bits, as the driver's are


def tiny_cell(name: str, **spec):
    cell = harness.load_cell(name, **spec)
    cell.config = dict(cell.config, preset="TINY")
    traffic = dict(cell.traffic)
    traffic["chunk"] = CHUNK
    traffic.setdefault("streamed", 6)
    if "speeds" in traffic:
        traffic["speeds"] = traffic["speeds"][:2]
    if "profile_scans" in traffic:
        traffic["profile_scans"] = 4
    cell.traffic = traffic
    return cell


def run_tiny(cell, seconds=1.0, trace=0, seed=SEED, limits=None,
             **flags):
    """(result, run record) of the cell on the CPU at the TINY size."""
    torch.set_num_threads(2)
    if limits is not None:
        cell.limits = limits
    argv = ["--workload", cell.name, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    for k, v in flags.items():
        argv += [f"--{k}", v]
    extra = {"max_keyframes": 128} if cell.config["preset"] == "TINY" else {}
    return execute(cell, parse(argv), torch.device("cpu"), time.time(),
                   cfg_extra=extra, n_scans=SCANS)

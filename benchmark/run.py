"""The benchmark of `lins_tpu_torch` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout and prints, as
the last line of standard output, one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device (and with --trace 1 busy_s,
window_s and a breakdown), and last the numbers compared with their limits
(also the last lines of standard error).  Without a CUDA device, or with
fewer than the cell asks for, it exits 2 and prints no result; if JAX or
the JAX package is loaded once the window has closed, it exits 3.

`--control tf32` runs the port with TF32 on in its matmuls, the precision
just below its own; `--control tf32-clouds` also hands it its scans
rounded to TF32's 10-bit mantissa, the check that the front end keeps its
clouds in float32.  `--fault frozen|altered|half|loopedge` plants a fault
under the timed path (benchmark/drive.py).  The benchmark's own runs pass
neither.
"""
from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches of the program's builds stay inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "tf32-clouds"),
                   default=None)
    p.add_argument("--fault", choices=("frozen", "altered", "half",
                                       "loopedge"), default=None)
    return p.parse_args(argv)


def execute(cell, args, device, t_process, cfg_extra=None, n_scans=None):
    """Run the cell in this process on `device`; returns the result dict
    (without the device section) and the mode's run record.  The CPU tests
    call it with a shrunken sensor (`cfg_extra`) and drive (`n_scans`)."""
    import torch

    from benchmark import compare, harness
    from benchmark.drive import Context

    cfg = harness.slam_config(cell.config, **(cfg_extra or {}))
    tracer = harness.Tracer(bool(args.trace), device)
    ctx = Context(cell, cfg, args.seed, args.seconds, tracer, device,
                  control=args.control, fault=args.fault, n_scans=n_scans)
    mode = harness.load_mode(cell.traffic["mode"])
    ctx.mark("imports and card")
    rec = mode.run(ctx)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    setup_s = ctx.t_window_wall - t_process
    outputs = rec["collect"]()
    rec["release"]()
    prof = ctx.profiled
    profile = harness.reduce_profile(prof) if prof is not None else None
    trace = harness.Trace(tracer, window_scans=rec["produced"],
                          profile=profile)
    if prof is not None:
        from benchmark import work

        trace.assoc_bound_s = work.assoc_bound_s(prof.assoc_calls)
        trace.assoc_calls = len(prof.assoc_calls)
        prof.assoc_calls.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = compare.numbers(outputs, cell.traffic)
    got["missing"] = rec["attempted"] - rec["produced"]
    correct, shown = compare.judge(got, cell.limits)
    if args.control and not torch.backends.cuda.matmul.allow_tf32:
        shown["tf32_kept"] = {"value": 0, "limit": ">= 1"}
        correct = False
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = harness.load_reader(m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(rec["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": rec["attempted"],
              "failed": rec["attempted"] - rec["produced"],
              "metrics": metrics, "peak": peak, "got": got,
              "setup": ctx.setup_marks(t_process)}
    if profile is not None:
        result["busy_s"] = profile["busy_s"]
        result["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["compared"] = shown
    return result, rec


def result_line(result: dict, kind: str, count: int, trace: bool) -> dict:
    """The last line's object; `compared` comes last."""
    dev = {"platform": "gpu", "kind": kind, "count": count,
           "memory_peak_bytes": int(result["peak"])}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": dev}
    if trace:
        dev["busy_s"] = result.get("busy_s", 0.0)
        dev["window_s"] = result.get("window_s", 0.0)
        if "breakdown" in result:
            line["breakdown"] = result["breakdown"]
    line["compared"] = result["compared"]
    return line


def main(argv=None):
    args = parse(argv)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"benchmark: the cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, rec = execute(cell, args, device, T_PROCESS)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: the run loaded {found}; the port must run "
              f"without JAX or the JAX package", file=sys.stderr)
        return 3
    line = result_line(result, torch.cuda.get_device_name(0), cell.chips,
                       bool(args.trace))
    print(f"benchmark: {rec['note']}; {rec['drives']} drive(s); window "
          f"{rec['window_s']:.3f} s; set-up {json.dumps(result['setup'])}; "
          f"numbers {json.dumps(result['got'])}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

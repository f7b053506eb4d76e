"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port."""
import ast
import subprocess
import sys

from benchmark import harness


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_forbidden_names_compared_whole():
    assert harness.forbidden_modules(["lins_tpu_torch", "lins_tpu_torch.slam",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["lins_tpu", "lins_tpu.slam", "jax",
                                      "jaxlib.xla", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla", "lins_tpu", "lins_tpu.slam"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "compare.py", "so3.py", "generator.py"):
        for mod in _imports(harness.BENCH / name):
            assert mod.split(".")[0] in ("__future__", "math", "dataclasses",
                                         "typing", "numpy", "torch",
                                         "benchmark"), (name, mod)
            assert mod not in ("benchmark.drive", "benchmark.harness",
                               "benchmark.run"), (name, mod)


def test_a_run_loads_no_jax():
    """The modules a run imports (the harness, every mode and reader, the
    port) leave no JAX or JAX package in sys.modules."""
    code = (
        "import sys\n"
        "from benchmark import harness, run, compare, reference, work\n"
        "for m in ('replay', 'live', 'multistream'): harness.load_mode(m)\n"
        "spec = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "for m in spec['per_layer']: harness.load_reader(m['name'])\n"
        "import lins_tpu_torch.slam, lins_tpu_torch.parallel.replay\n"
        "print(harness.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True,
                         )
    assert out.stdout.strip() == "[]"

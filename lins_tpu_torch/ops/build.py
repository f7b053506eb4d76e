"""Build and load the port's CUDA kernels (plain C interface, `ctypes`).

Each `lins_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for Hopper
(`sm_90a`) into `lins_tpu_torch/_build/lib<name>.so` at first use and loaded
with `ctypes`.  A library newer than its source and than every shared
header (`csrc/*.cuh`) is reused.  Nothing here runs at import time (the CPU
tests import every module of the port): `nvcc` is reached only when a
kernel launches or `build_all` is called.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
KERNELS = ("label_components", "label_blocked", "select_candidates",
           "topk_smallest", "assoc_normal_equations")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from lins_tpu_torch/csrc with the CUDA toolkit")


def library_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not os.path.exists(lib):
        return True
    srcs = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(s) for s in srcs)


def _start(name: str, verbose: bool):
    """Start one nvcc; it writes a temporary file renamed into place by
    `_finish`, so concurrent builders never load a half-written library."""
    cmd = [_nvcc(), *NVCC_FLAGS]
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, library_path(name))
    return out


def build_all(verbose: bool = False, force: bool = False) -> dict:
    """Build every stale kernel library, all nvcc processes started
    together.  Returns {name: compiler output} for the ones built."""
    todo = [k for k in KERNELS if force or _stale(k)]
    started = {k: _start(k, verbose) for k in todo}
    return {k: _finish(k, *started[k]) for k in todo}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if stale."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            _finish(name, *_start(name, verbose=False))
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib


def require(name, arg, t, dtype, shape, device):
    """Raise unless tensor `t` (argument `arg` of kernel wrapper `name`)
    lies on `device` with `dtype`, `shape` and a contiguous layout: what a
    kernel reading raw pointers takes."""
    if t.device != device:
        raise ValueError(f"{name}: {arg} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} is not contiguous")

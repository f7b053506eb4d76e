"""Nearest-C candidate selection: the CUDA kernels K3 and K6 and their plain
PyTorch versions.

`select_candidates` replaces the TPU kernel
`lins_tpu/ops/pallas_select.py::select_candidates` (body `_select_kernel`):
per query row, the squared distance to each candidate of its gathered
neighbourhood block, masked to `_BIG` where the candidate is not ok, the
query is not valid or the candidate is a parked tombstone (d2 >= 1e17),
then the C+1 nearest in ascending order, ties to the lowest cell-major flat
index.  The wrapper finishes as the reference does: `cand_ok = d2 <
1.5e38`, empty slots at +inf and parked on the query point, and `d2C`
either the first DROPPED distance (the C+1-th, `first_dropped=True`, the
reference's kernel path) or the C-th KEPT one (`first_dropped=False`, the
reference's sort path).  Both are in the C+1 columns the kernel extracts.

`topk_smallest` replaces `tools/r4_mosaic_canary.py::kernel_probe` (body
`topk_kernel`): the C smallest values of each row, ascending, as a stable
sort gives them (-0.0 and +0.0 equal, the lower index first).  Its kernel
is `csrc/topk_smallest.cu`.

On a CUDA tensor each wrapper launches its kernel (`csrc/select_candidates.cu`
for K3; design and bound in each source's header) or raises; there is no
fallback.  On a CPU tensor
it runs the plain version.  The plain versions compute the same distance
with the same separate roundings and take the first C+1 of a stable sort,
so on the card kernel and plain agree exactly.  They keep the input dtype:
float64 on the CPU reproduces the reference's sort path (whose kernel
path does not run in float64).
"""
from __future__ import annotations

import ctypes

import torch

from lins_tpu_torch.ops.build import require as _require

# "infinity" that survives arithmetic without NaN risk (the reference's)
_BIG = 3.0e38
# squared distance above which a candidate is a parked tombstone
# (grid_nn._FAR2 of the reference)
_FAR2 = 1.0e17
# dynamic shared memory a block may use without opting in: the default
# 48 KB less room for the kernel's static reduction buffers.  K3 keeps a
# row's keys there: the largest row on the mapping path (27 cells x 216
# slots) takes 23,328 B; a longer row would need cudaFuncSetAttribute's
# opt-in in the kernel's launcher.  K6 takes rows of the same length: its
# sort buffer (opted in above 48 KB) holds at most 16,384 words then.
_SMEM_LIMIT = 47 * 1024


def masked_d2(query, q_valid, cand, ok):
    """(Q, nb*cap) squared distances of the gathered block (Q, nb, 3, cap)
    to the queries, cell-major, as ((dx*dx + dy*dy) + dz*dz) with each
    operation rounded alone; `_BIG` where masked."""
    diff = cand - query[:, None, :, None]
    dx, dy, dz = diff[:, :, 0], diff[:, :, 1], diff[:, :, 2]
    d2 = (dx * dx + dy * dy) + dz * dz
    keep = ok & q_valid[:, None, None] & (d2 < _FAR2)
    return torch.where(keep, d2, _BIG).reshape(d2.shape[0], -1)


def _planes(cand):
    """(Q, 3, nb*cap) coordinate planes in the flat cell-major order."""
    Q = cand.shape[0]
    return cand.transpose(1, 2).reshape(Q, 3, -1)


def _finish(query, d2o, xyzo, C, first_dropped):
    d2k = d2o[:, :C]
    cand_ok = d2k < _BIG * 0.5
    d2k = torch.where(cand_ok, d2k, torch.inf)
    cand = torch.where(cand_ok[:, :, None], xyzo[:, :C],
                       query[:, None, :].to(xyzo.dtype))
    if first_dropped:
        last = d2o[:, C]
        d2C = torch.where(last < _BIG * 0.5, last, torch.inf)
    else:
        d2C = d2k[:, C - 1]
    return cand, cand_ok, d2k, d2C


def select_candidates_plain(query, q_valid, cand, ok, C: int,
                            first_dropped: bool = True):
    """Plain PyTorch K3: query (Q,3), q_valid (Q,), cand (Q, nb, 3, cap)
    gathered block, ok (Q, nb, cap).  Returns (cand (Q,C,3), cand_ok (Q,C),
    d2k (Q,C), d2C (Q,)) in the input dtype."""
    select_candidates_plain.calls += 1
    d2o, xyzo = select_raw_plain(query, q_valid, cand, ok, C)
    return _finish(query, d2o, xyzo, C, first_dropped)


select_candidates_plain.calls = 0


def select_raw_plain(query, q_valid, cand, ok, C: int):
    """The plain counterpart of `launch_select`: the C+1 nearest as
    (d2 (Q, C+1), xyz (Q, C+1, 3)), masked lanes at `_BIG`, before
    `_finish`."""
    d2 = masked_d2(query, q_valid, cand, ok)
    order = torch.sort(d2, dim=1, stable=True).indices[:, :C + 1]
    d2o = torch.gather(d2, 1, order)
    xyzo = torch.take_along_dim(_planes(cand), order[:, None, :], dim=2)
    return d2o, xyzo.transpose(1, 2)


# each kernel's C entry and its argument types
_ENTRIES = {
    "select_candidates": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 3,
    "topk_smallest": [ctypes.c_void_p] + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 2,
}
_LIBS: dict = {}


def _entry(name):
    """The C entry `<name>_launch` of the built library `name`, with its
    signature, set up on first use."""
    fn = _LIBS.get(name)
    if fn is None:
        from lins_tpu_torch.ops import build

        fn = getattr(build.load(name), f"{name}_launch")
        fn.argtypes = _ENTRIES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn


def select_candidates(query, q_valid, cand, ok, C: int,
                      first_dropped: bool = True):
    """Nearest-C selection of each query's gathered candidate block.

    query (Q,3), q_valid (Q,) bool, cand (Q, nb, 3, cap) (the grid's
    `cells[bb]` neighbourhood, read in place), ok (Q, nb, cap) bool.
    Returns (cand (Q,C,3), cand_ok (Q,C), d2k (Q,C), d2C (Q,)).

    CUDA tensors (float32): one launch of K3, counted in
    `select_candidates.launches`.  CPU tensors: `select_candidates_plain`.
    """
    if cand.device.type == "cpu":
        return select_candidates_plain(query, q_valid, cand, ok, C,
                                       first_dropped)
    d2o, xyzo = launch_select(query, q_valid, cand, ok, C)
    return _finish(query, d2o, xyzo, C, first_dropped)


def launch_select(query, q_valid, cand, ok, C: int):
    """K3 itself on CUDA tensors: checks, one launch, and the kernel's raw
    outputs (d2 (Q, C+1), xyz (Q, C+1, 3)) before `select_candidates`
    finishes them; counted in `select_candidates.launches`."""
    dev = cand.device
    name = "select_candidates"
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    Q, nb, _, cap = cand.shape
    B = nb * cap
    _require(name, "cand", cand, torch.float32, (Q, nb, 3, cap), dev)
    _require(name, "query", query, torch.float32, (Q, 3), dev)
    _require(name, "q_valid", q_valid, torch.bool, (Q,), dev)
    _require(name, "ok", ok, torch.bool, (Q, nb, cap), dev)
    if not 1 <= C < B:
        raise ValueError(f"{name}: needs 1 <= C and C+1 <= nb*cap = {B}, "
                         f"got C={C}")
    if 4 * B > _SMEM_LIMIT:
        raise ValueError(f"{name}: a row of {B} candidates needs {4 * B} B "
                         f"of shared memory (limit {_SMEM_LIMIT})")
    R = C + 1
    d2o = torch.empty((Q, R), dtype=torch.float32, device=dev)
    xyzo = torch.empty((Q, R, 3), dtype=torch.float32, device=dev)
    if Q > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry("select_candidates")(
            query.data_ptr(), q_valid.data_ptr(), cand.data_ptr(),
            ok.data_ptr(), Q, nb, cap, R, d2o.data_ptr(), xyzo.data_ptr(),
            stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        select_candidates.launches += 1
    return d2o, xyzo


select_candidates.launches = 0


def topk_smallest_plain(d2, C: int):
    """Plain PyTorch K6: the C smallest values of each row of (Q, B),
    ascending."""
    topk_smallest_plain.calls += 1
    return torch.sort(d2, dim=1, stable=True).values[:, :C]


topk_smallest_plain.calls = 0


def topk_smallest(d2, C: int):
    """The C smallest values of each row of a (Q, B) block, ascending.

    CUDA tensors (float32, no NaN): one launch of K6, counted in
    `topk_smallest.launches`, bit-equal to `topk_smallest_plain`.  CPU
    tensors: `topk_smallest_plain`."""
    dev = d2.device
    if dev.type == "cpu":
        return topk_smallest_plain(d2, C)
    if dev.type != "cuda":
        raise ValueError(f"topk_smallest: unsupported device {dev}")
    Q, B = d2.shape
    _require("topk_smallest", "d2", d2, torch.float32, (Q, B), dev)
    if not 1 <= C <= B:
        raise ValueError(f"topk_smallest: needs 1 <= C <= B = {B}, got {C}")
    if 4 * B > _SMEM_LIMIT:
        raise ValueError(f"topk_smallest: rows of at most {_SMEM_LIMIT // 4} "
                         f"values, got {B} (the kernel's sort buffer, up to "
                         f"8 B a value at C = B, lives in shared memory)")
    out = torch.empty((Q, C), dtype=torch.float32, device=dev)
    if Q > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry("topk_smallest")(d2.data_ptr(), Q, B, C,
                                      out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"topk_smallest kernel launch failed: CUDA "
                               f"error {err}")
        topk_smallest.launches += 1
    return out


topk_smallest.launches = 0

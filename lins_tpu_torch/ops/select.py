"""Nearest-C candidate gather and selection: the CUDA kernels K3 and K6 and
their plain PyTorch versions.

`select_candidates` replaces the TPU kernel
`lins_tpu/ops/pallas_select.py::select_candidates` (body `_select_kernel`)
together with the gather around it in `lins_tpu/ops/grid_nn.py::
gather_candidates`.  Per query row it reads the row's nb neighbour buckets
`bb` of the map grid in place (`cells` (table, 3, cap), `cnt` (table,)):
slots below the bucket's count, of buckets that no earlier neighbour cell
of the row hashed to; the squared distance to each, masked to `_BIG` where
the query is not valid or the slot is a parked tombstone (d2 >= 1e17); then
the C+1 nearest in ascending order, ties to the lowest cell-major flat
index.  It returns them finished as the reference does: `cand_ok = d2 <
1.5e38`, empty slots at +inf and parked on the query point, and `d2C`
either the first DROPPED distance (the C+1-th, `first_dropped=True`, the
reference's kernel path) or the C-th KEPT one (`first_dropped=False`, the
reference's sort path).

`topk_smallest` replaces `tools/r4_mosaic_canary.py::kernel_probe` (body
`topk_kernel`): the C smallest values of each row, ascending, as a stable
sort gives them (-0.0 and +0.0 equal, the lower index first).  Its kernel
is `csrc/topk_smallest.cu`.

On a CUDA tensor each wrapper launches its kernel (`csrc/select_candidates.cu`
for K3; design and bound in each source's header) or raises; there is no
fallback.  On a CPU tensor it runs the plain version.  The plain versions
compute the same distance with the same separate roundings and take the
first C+1 of a stable sort, so on the card kernel and plain agree exactly.
They keep the input dtype: float64 on the CPU reproduces the reference's
sort path (whose kernel path does not run in float64).
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
# K6's rows live in shared memory: its sort buffer (opted in above 48 KB)
# holds at most 16,384 words when rows are at most this many bytes
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


def gather_block(bb, cells, cnt):
    """Each query's whole neighbourhood block, read from the grid at the
    row's buckets `bb` (Q, nb): (cand (Q, nb, 3, cap), ok (Q, nb, cap)).
    `ok` masks slots at or above a bucket's count and buckets that an
    earlier neighbour cell of the same row hashed to (they would contribute
    the same candidates twice)."""
    bb = bb.long()
    n_off = bb.shape[1]
    tri = torch.ones((n_off, n_off), dtype=torch.bool,
                     device=bb.device).tril(-1)
    dup = torch.any((bb[:, :, None] == bb[:, None, :]) & tri, dim=-1)
    ok = ((torch.arange(cells.shape[2], dtype=torch.int32, device=bb.device)
           < cnt[bb][:, :, None]) & ~dup[:, :, None])
    return cells[bb], ok


def select_block_plain(query, q_valid, cand, ok, C: int,
                       first_dropped: bool = True):
    """The selection of a gathered block, in plain PyTorch: query (Q,3),
    q_valid (Q,), cand (Q, nb, 3, cap), ok (Q, nb, cap).  Returns (cand
    (Q,C,3), cand_ok (Q,C), d2k (Q,C), d2C (Q,)) in the input dtype."""
    d2 = masked_d2(query, q_valid, cand, ok)
    order = torch.sort(d2, dim=1, stable=True).indices[:, :C + 1]
    d2o = torch.gather(d2, 1, order)
    xyzo = torch.take_along_dim(_planes(cand), order[:, None, :], dim=2)
    return _finish(query, d2o, xyzo.transpose(1, 2), C, first_dropped)


def select_candidates_plain(query, q_valid, bb, cells, cnt, C: int,
                            first_dropped: bool = True):
    """Plain PyTorch K3: `gather_block` + `select_block_plain`, on the
    arguments of `select_candidates`."""
    select_candidates_plain.calls += 1
    cand, ok = gather_block(bb, cells, cnt)
    return select_block_plain(query, q_valid, cand, ok, C, first_dropped)


select_candidates_plain.calls = 0


# each kernel's C entry and its argument types
_ENTRIES = {
    "select_candidates": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_void_p] * 5,
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


def select_candidates(query, q_valid, bb, cells, cnt, C: int,
                      first_dropped: bool = True):
    """The C nearest candidates of each query in its neighbour buckets.

    query (Q,3), q_valid (Q,) bool, bb (Q, nb) int32 bucket ids (nb <= 32),
    cells (table, 3, cap) and cnt (table,) int32: the map grid, read in
    place.  Returns (cand (Q,C,3), cand_ok (Q,C), d2k (Q,C), d2C (Q,)).

    CUDA tensors (float32): one launch of K3, counted in
    `select_candidates.launches`.  CPU tensors: `select_candidates_plain`.
    """
    dev = cells.device
    if dev.type == "cpu":
        return select_candidates_plain(query, q_valid, bb, cells, cnt, C,
                                       first_dropped)
    name = "select_candidates"
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if bb.dim() != 2 or cells.dim() != 3 or cells.shape[1] != 3:
        raise ValueError(f"{name}: bb must be (Q, nb) and cells (table, 3, "
                         f"cap), got {tuple(bb.shape)} and "
                         f"{tuple(cells.shape)}")
    Q, nb = bb.shape
    table, _, cap = cells.shape
    _require(name, "query", query, torch.float32, (Q, 3), dev)
    _require(name, "q_valid", q_valid, torch.bool, (Q,), dev)
    _require(name, "bb", bb, torch.int32, (Q, nb), dev)
    _require(name, "cells", cells, torch.float32, (table, 3, cap), dev)
    _require(name, "cnt", cnt, torch.int32, (table,), dev)
    if not 1 <= nb <= 32:
        raise ValueError(f"{name}: a row reads 1 to 32 buckets, got {nb}")
    if not 1 <= C < nb * cap:
        raise ValueError(f"{name}: needs 1 <= C, C+1 <= nb*cap = "
                         f"{nb * cap}, got C={C}")
    cand = torch.empty((Q, C, 3), dtype=torch.float32, device=dev)
    cand_ok = torch.empty((Q, C), dtype=torch.bool, device=dev)
    d2k = torch.empty((Q, C), dtype=torch.float32, device=dev)
    d2C = torch.empty((Q,), dtype=torch.float32, device=dev)
    if Q > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(name)(
            query.data_ptr(), q_valid.data_ptr(), bb.data_ptr(),
            cells.data_ptr(), cnt.data_ptr(), Q, nb, cap, C,
            int(first_dropped), cand.data_ptr(), cand_ok.data_ptr(),
            d2k.data_ptr(), d2C.data_ptr(), stream)
        if err == -1:
            raise ValueError(f"{name}: refused by its launcher: C={C} needs "
                             f"a sort buffer over 256 words, or rows of "
                             f"{nb * cap} slots need more shared memory a "
                             f"block than the card offers")
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        select_candidates.launches += 1
    return cand, cand_ok, d2k, d2C


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

"""Grid connected-components labelling: the CUDA kernels K1 and K2 and
their plain PyTorch versions.

`label_components` is the one entry point.  Contract (that of
`label_from_edges` in `lins_tpu/frontend/segmentation.py`): from boolean
edge masks
  e_right[..., i, j]: edge (i,j)-(i,j+1 mod S)   (wraps at the seam)
  e_down [..., i, j]: edge (i,j)-(i+1,j)         (no wrap)
  eligible[..., i, j]: the cell takes part
return int32 labels, each eligible cell holding the smallest flat id i*S+j
of its 4-connected component and each ineligible cell 2^30.  The label
being the least member is load-bearing: `segment_from_labels` reads the
component's lowest row from it.

`route(L, S)` picks the kernel by the port's own shared memory (the
reference routes by its TPU's VMEM, `lins_tpu/odometry/estimator.py:
241-286`; labels are exact either way, so the outputs are the same):
  * K1 (`csrc/label_components.cu`, replaces `lins_tpu/ops/pallas_label.py
    ::label_components_pallas`) when a whole scan fits one block's shared
    memory: one launch, a thread-block cluster per scan of up to 8 blocks
    of whole rows, one union-find over the cluster's distributed shared
    memory (init, one union pass, one compression; no rounds);
  * K2 (`csrc/label_blocked.cu`, replaces `label_components_blocked`) for
    taller grids with L a multiple of 16, up to 128 rows (HDL-64, OS1-64):
    one launch, a thread-block cluster per scan, one block per 8- or 16-row
    piece (hook + pointer-jump rounds in each piece, `csrc/label_grid.cuh`),
    the pieces joined across the seams in distributed shared memory.
On a CUDA tensor the wrapper launches its kernel or raises; there is no
fallback.  On a CPU tensor it runs the kernel's plain version:
`label_components_plain` iterates the union-find propagation of
`label_from_edges` to the same fixpoint; `label_blocked_plain` has K2's
structure (plain K1 on the masked blocks, then the seam merge of the
reference iterated to its fixpoint).
"""
from __future__ import annotations

import collections
import ctypes

import torch

BIG = 2 ** 30
# shared memory a block may opt in to on Hopper (H100/H200)
_SMEM_LIMIT = 232448
# rows of one block of the reference's blocked labelling, and the most
# such blocks K2's cluster takes (the portable cluster size)
BLOCK_ROWS = 16
CLUSTER_BLOCKS = 8


def _smem_bytes(L: int, S: int) -> int:
    """Shared memory of one block of `csrc/label_grid.cuh` labelling an
    L x S grid (an int32 label and a flag byte per cell): the bound `route`
    sends to K1, and each of K2's pieces must meet."""
    return L * S * 5


def route(L: int, S: int) -> str:
    """The kernel that labels an L x S grid: "K1" when the grid fits one
    block's shared memory (K1 spreads it over a cluster, but keeps this
    bound of the body it replaced, so that the routing does not change),
    else "K2" when L is a multiple of 16, at most 8 16-row
    blocks (one cluster) and a 16-row block fits; raises ValueError for any
    other grid."""
    if _smem_bytes(L, S) <= _SMEM_LIMIT:
        return "K1"
    if (L % BLOCK_ROWS == 0 and L // BLOCK_ROWS <= CLUSTER_BLOCKS
            and _smem_bytes(BLOCK_ROWS, S) <= _SMEM_LIMIT):
        return "K2"
    raise ValueError(
        f"label_components: a {L}x{S} grid needs {_smem_bytes(L, S)} B of "
        f"shared memory per block (limit {_SMEM_LIMIT}) and is not a stack "
        f"of at most {CLUSTER_BLOCKS} {BLOCK_ROWS}-row blocks that fit")


def piece_rows(L: int) -> int:
    """Rows of one K2 block for a scan of L rows: 8 where L / 8 blocks
    still make a portable cluster, else 16.  Every sensor preset routes to
    K2 with 64 rows (8-row blocks); the 16-row blocks exist only so that
    80- to 128-row grids, which K2 accepted before, keep working."""
    return 8 if L // 8 <= CLUSTER_BLOCKS else BLOCK_ROWS


def _as_batch(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 3 else x.unsqueeze(0)


def label_components_plain(e_right, e_down, eligible):
    """Plain PyTorch labelling, (L, S) or (K, L, S) -> int32 of the same
    shape: min-neighbour propagation + union-find hook + pointer doubling
    (label_from_edges), iterated until nothing changes.  Reads a flag on
    the host each round, so it is for CPU tensors and for checking the
    kernel; `label_components` never takes it for a CUDA tensor."""
    label_components_plain.calls += 1
    squeeze = eligible.dim() == 2
    er, ed, el = (_as_batch(t).bool() for t in (e_right, e_down, eligible))
    K, L, S = el.shape
    LS = L * S
    dev = el.device
    e_left = torch.roll(er, 1, dims=2)
    e_up = torch.cat([torch.zeros_like(ed[:, :1]), ed[:, :-1]], dim=1)
    big = torch.full((), BIG, dtype=torch.int32, device=dev)

    flat_ids = torch.arange(LS, dtype=torch.int32, device=dev).reshape(L, S)
    lab = torch.where(el, flat_ids, big)
    # per-scan offset into one (K * (LS + 1)) scatter table
    offs = (torch.arange(K, device=dev) * (LS + 1))[:, None]
    big_row = torch.full((K, 1, S), BIG, dtype=torch.int32, device=dev)

    def neighbor_min(lb):
        right = torch.roll(lb, -1, dims=2)
        left = torch.roll(lb, 1, dims=2)
        down = torch.cat([lb[:, 1:], big_row], dim=1)
        up = torch.cat([big_row, lb[:, :-1]], dim=1)
        m = lb
        m = torch.minimum(m, torch.where(er, right, big))
        m = torch.minimum(m, torch.where(e_left, left, big))
        m = torch.minimum(m, torch.where(ed, down, big))
        m = torch.minimum(m, torch.where(e_up, up, big))
        return torch.where(el, m, big)

    while True:
        prev = lab.reshape(K, LS)
        flat = neighbor_min(lab).reshape(K, LS)
        # hook: children scatter-min their new value onto their previous
        # representative
        A = torch.full((K * (LS + 1),), BIG, dtype=torch.int32, device=dev)
        A = A.scatter_reduce(0, (torch.clamp(prev, max=LS) + offs).reshape(-1),
                             flat.reshape(-1), "amin")
        A = A.reshape(K, LS + 1)
        flat = torch.minimum(flat, A[:, :LS])
        # pointer doubling
        for _ in range(2):
            ext = torch.cat([flat, big.expand(K, 1)], dim=1)
            flat = torch.minimum(
                flat, torch.gather(ext, 1, torch.clamp(flat, max=LS).long()))
        new = torch.where(el, flat.reshape(K, L, S), big)
        done = torch.equal(new, lab)
        lab = new
        if done:
            break
    return lab[0] if squeeze else lab


label_components_plain.calls = 0


def label_blocked_plain(e_right, e_down, eligible):
    """Plain PyTorch version of K2, (L, S) or (K, L, S) with L a multiple of
    16 -> int32 labels: `label_components_plain` on the 16-row blocks with
    the seam `e_down` edges masked, labels offset by the block's first flat
    id, then the seam merge of `label_components_blocked` (min-hook of the
    seam pairs' parents + two pointer-doubling steps) repeated until it
    changes nothing.  Reads a flag on the host each round."""
    label_blocked_plain.calls += 1
    squeeze = eligible.dim() == 2
    er, ed, el = (_as_batch(t).bool() for t in (e_right, e_down, eligible))
    K, L, S = el.shape
    R, LS = BLOCK_ROWS, L * S
    nb = L // R
    dev = el.device
    seam = (torch.arange(L, device=dev) % R == R - 1)[:, None]
    lab_b = label_components_plain(*(t.reshape(K * nb, R, S) for t in
                                     (er, ed & ~seam, el)))
    offs = (torch.arange(nb, dtype=torch.int32, device=dev)
            * (R * S))[None, :, None, None]
    lab_b = lab_b.reshape(K, nb, R, S)
    lab = torch.where(lab_b < BIG, lab_b + offs, BIG).reshape(K, L, S)

    # the labels on both sides of each kept seam edge, LS where there is none
    rows = torch.arange(nb - 1, device=dev) * R + (R - 1)
    la, lb = lab[:, rows], lab[:, rows + 1]
    ok = ed[:, rows] & (la < BIG) & (lb < BIG)
    a = torch.where(ok, la, LS).reshape(K, -1).long()
    b = torch.where(ok, lb, LS).reshape(K, -1).long()
    parent = torch.arange(LS + 1, device=dev).repeat(K, 1)
    while True:
        pa, pb = torch.gather(parent, 1, a), torch.gather(parent, 1, b)
        m = torch.minimum(pa, pb)
        new = parent.scatter_reduce(1, pa, m, "amin").scatter_reduce(
            1, pb, m, "amin")
        new = torch.gather(new, 1, new)
        new = torch.gather(new, 1, new)
        if torch.equal(new, parent):
            break
        parent = new
    root = torch.gather(parent, 1, torch.clamp(lab, max=LS).reshape(K, LS)
                        .long()).reshape(K, L, S).to(torch.int32)
    out = torch.where(lab < BIG, root, BIG)
    return out[0] if squeeze else out


label_blocked_plain.calls = 0


def _checked(name, e_right, e_down, eligible):
    """The three masks as contiguous (K, L, S) card tensors, after the
    checks the kernels rely on."""
    if eligible.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {eligible.device}")
    ts = [_as_batch(t) for t in (e_right, e_down, eligible)]
    shape = ts[2].shape
    for what, t in zip(("e_right", "e_down", "eligible"), ts):
        if t.dim() != 3 or t.shape != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != ts[2].device:
            raise ValueError(f"{name}: {what} on {t.device}")
        if t.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"{name}: {what} is {t.dtype}, expected bool "
                            f"or uint8")
    return [t.contiguous() for t in ts]


def _call(lib_name, fn_name, *args):
    """Launch a kernel through its library's C function (pointers and the
    stream as void*, sizes as int); raise ValueError when the launcher
    refused the grid (-1, nothing launched), RuntimeError on a CUDA
    error."""
    from lins_tpu_torch.ops import build

    fn = getattr(build.load(lib_name), fn_name)
    fn.argtypes = [ctypes.c_int if isinstance(a, int) else ctypes.c_void_p
                   for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(a if isinstance(a, int) else a.data_ptr() for a in args),
             torch.cuda.current_stream(args[0].device).cuda_stream)
    if err == -1:
        raise ValueError(f"{fn_name}: refused by its launcher: "
                         f"{tuple(a for a in args if isinstance(a, int))}")
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")


def _label_blocked(e_right, e_down, eligible):
    """K2, the wrapper `label_components` calls for the grids `route`
    sends to K2.

    CUDA tensors: one launch over the whole batch (a cluster of
    L / `piece_rows(L)` blocks per scan), counted in
    `_label_blocked.launches`.  CPU tensors: `label_blocked_plain`.
    """
    L, S = eligible.shape[-2:]
    if route(L, S) != "K2":
        raise ValueError(f"_label_blocked: route({L}, {S}) is not K2")
    if eligible.device.type == "cpu":
        return label_blocked_plain(e_right, e_down, eligible)
    squeeze = eligible.dim() == 2
    er, ed, el = _checked("_label_blocked", e_right, e_down, eligible)
    K = el.shape[0]
    out = torch.empty(el.shape, dtype=torch.int32, device=el.device)
    if K > 0:
        _call("label_blocked", "label_blocked_launch", er, ed, el, out, K, L,
              S, piece_rows(L))
        _label_blocked.launches += 1
    return out[0] if squeeze else out


_label_blocked.launches = 0


def resident_clusters(L: int, S: int, rows: int) -> int:
    """How many of K2's clusters (L / rows blocks of rows x S cells) the
    current card holds at once (cudaOccupancyMaxActiveClusters)."""
    from lins_tpu_torch.ops import build

    n = ctypes.c_int(-1)
    fn = build.load("label_blocked").label_blocked_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(L, S, rows, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"label_blocked_clusters failed: CUDA error {err}")
    return n.value


def k1_layout(K: int, L: int, S: int) -> dict:
    """K1's layout for K scans of L x S cells, as its launcher picks it:
    blocks a scan (`pieces`, the cluster), `rows` a block, `threads` and
    shared memory bytes (`smem`) a block, and how many such clusters the
    current card holds at once (`clusters`, cudaOccupancyMaxActiveClusters;
    the launcher halves the threads while it is under K)."""
    from lins_tpu_torch.ops import build

    vals = [ctypes.c_int(-1) for _ in range(5)]
    fn = build.load("label_components").label_components_layout
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 5
    fn.restype = ctypes.c_int
    err = fn(K, L, S, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"label_components_layout failed: error {err}")
    return dict(zip(("pieces", "rows", "threads", "smem", "clusters"),
                    (v.value for v in vals)))


def label_components(e_right, e_down, eligible):
    """Connected-component labels of (L, S) or (K, L, S) edge masks, int32,
    by the kernel `route(L, S)` picks.

    K1 on CUDA tensors: one launch over the whole batch (a cluster of
    `k1_layout(K, L, S)["pieces"]` blocks per scan; none for K = 0), counted
    in `label_components.launches` and, by its K, in
    `label_components.batches`; K2 is counted in
    `_label_blocked.launches`.  CPU tensors: the picked kernel's plain
    version.
    """
    L, S = eligible.shape[-2:]
    if route(L, S) == "K2":
        return _label_blocked(e_right, e_down, eligible)
    if eligible.device.type == "cpu":
        return label_components_plain(e_right, e_down, eligible)
    squeeze = eligible.dim() == 2
    er, ed, el = _checked("label_components", e_right, e_down, eligible)
    K = el.shape[0]
    out = torch.empty(el.shape, dtype=torch.int32, device=el.device)
    if K > 0:
        _call("label_components", "label_components_launch", er, ed, el, out,
              K, L, S)
        label_components.launches += 1
        label_components.batches[K] += 1
    return out[0] if squeeze else out


label_components.launches = 0
label_components.batches = collections.Counter()

"""Fixed-shape voxel hashing and voxel-grid downsampling (port of
`lins_tpu/ops/voxel.py`; pcl::VoxelGrid equivalent, leaf sizes of
lidar_mapping_node.cpp:283-291).

Centroid per voxel over a masked point set, all static shapes: a stable
lexicographic sort by the exact integer voxel coordinates, centroids from
cumulative-sum differences at run starts, valid centroids compacted to the
front.  The cumulative sums are float64 in every builder of the port
(`run_sums`), a recorded departure from the reference.
"""
from __future__ import annotations

import torch

from lins_tpu_torch.frontend.projection import div_const

_M32 = 0xFFFFFFFF
IMAX = 2 ** 31 - 1
IMIN = -2 ** 31


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h * c mod 2^32 for int64 tensors holding uint32 values, with no
    product above 2^49 (no int64 overflow): the high half of `c` only
    reaches the result through its low 16 bits."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def hash3(v: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Murmur-style mixed hash of integer voxel coords (..., 3) -> int32,
    bit-equal to the reference's uint32 arithmetic with wraparound.

    Eager PyTorch has almost no uint32 arithmetic, so the words live in
    int64 masked to 32 bits after every multiply and shift, and the result
    is reinterpreted as int32 in two's complement."""
    x = v.to(torch.int64) & _M32
    h = _mul32((x[..., 0] + seed) & _M32, 0x9E3779B1)
    h = _mul32(h ^ x[..., 1], 0x85EBCA77)
    h = _mul32(h ^ x[..., 2], 0xC2B2AE3D)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return torch.where(h > IMAX, h - 2 ** 32, h).to(torch.int32)


def pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key ordering like the int32 pair (hi, lo)
    lexicographically."""
    return hi.to(torch.int64) * 2 ** 32 + (lo.to(torch.int64) - IMIN)


def lex_order(keys, dim: int = -1) -> torch.Tensor:
    """Stable lexicographic argsort along `dim` over int64 keys given most
    significant first: stable sorts from the least significant key up, as
    the reference's multi-key `lax.sort` orders rows (stably)."""
    order = None
    for k in reversed(keys):
        kk = k if order is None else torch.gather(k, dim, order)
        o = torch.sort(kk, dim=dim, stable=True).indices
        order = o if order is None else torch.gather(order, dim, o)
    return order


def reverse_cummin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Suffix minimum along `dim` (associative_scan(min, reverse=True))."""
    return torch.cummin(x.flip(dim), dim).values.flip(dim)


def run_sums(x: torch.Tensor, keep: torch.Tensor, next_pos: torch.Tensor):
    """Run sums, counts and means of the rows of a sorted (..., N, C)
    block: row i gets those of the kept rows in [i, next_pos[i]), next_pos
    (..., N) int64 the end of row i's run (the values are read at run
    starts).

    Departure from the reference, which takes the prefix sums in the
    points' dtype (in float32 a prefix over a window map reaches ~1e5 m
    and each difference loses centroid digits): the prefix sums are
    float64, scanned along the innermost axis of a contiguous (..., C, N)
    copy, and each mean is divided in float64 and rounded once to x's
    dtype.  Counts are int32 prefix sums.  No float `index_add_`: its
    order is not fixed on the card.  Returns (sums float64 (..., N, C),
    counts int32 (..., N), means (..., N, C) in x's dtype)."""
    N = x.shape[-2]
    xt = torch.where(keep[..., None], x, 0.0).transpose(-1, -2).to(
        torch.float64, memory_format=torch.contiguous_format)
    z = torch.zeros(xt.shape[:-1] + (1,), dtype=torch.float64,
                    device=x.device)
    cs = torch.cat([z, torch.cumsum(xt, dim=-1)], dim=-1)
    sums = (torch.gather(cs, -1, next_pos[..., None, :].expand(xt.shape))
            - cs[..., :N])
    cm = torch.cat([torch.zeros_like(next_pos[..., :1], dtype=torch.int32),
                    torch.cumsum(keep.to(torch.int32), dim=-1,
                                 dtype=torch.int32)], dim=-1)
    cnt = torch.gather(cm, -1, next_pos) - cm[..., :N]
    means = sums / torch.clamp(cnt, min=1)[..., None, :]
    return (sums.transpose(-1, -2), cnt,
            means.transpose(-1, -2).to(
                x.dtype, memory_format=torch.contiguous_format))


def voxel_downsample(xyz: torch.Tensor, mask: torch.Tensor, leaf: float,
                     cap: int | None = None):
    """Downsample a masked (N,3) cloud to voxel centroids.

    Voxel identity is the exact integer voxel coordinate triple (three sort
    keys); no hash ever merges two voxels.  Returns (xyz (cap,3), valid
    (cap,)) with centroids compacted to the front; cap defaults to N.
    """
    N = xyz.shape[0]
    cap = cap or N
    dev = xyz.device
    v = torch.floor(div_const(xyz, leaf)).to(torch.int32)
    v = torch.where(mask[:, None], v, IMAX)
    order = lex_order([pair_key(v[:, 0], v[:, 1]), v[:, 2].to(torch.int64)])
    k = v[order]
    xs = xyz[order]
    ms = k[:, 0] != IMAX
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    start = torch.cat([true1, torch.any(k[1:] != k[:-1], dim=1)]) & ms
    nxt = torch.cat([start[1:], true1])
    pos = torch.where(nxt, torch.arange(1, N + 1, device=dev), N)
    next_pos = reverse_cummin(pos, 0)
    cent = run_sums(xs, ms, next_pos)[2]

    # compact run-start centroids to the front: scatter by cumsum rank into
    # a buffer one row longer, whose last row takes the dropped rows
    m = min(N, cap)
    rank = torch.cumsum(start.to(torch.int64), dim=0) - 1
    dest = torch.where(start & (rank < m), rank, m)
    out = torch.zeros((m + 1, 3), dtype=xs.dtype, device=dev)
    out[dest] = torch.where(start[:, None], cent, 0.0)
    ok = torch.zeros(m + 1, dtype=torch.bool, device=dev)
    ok[dest] = start
    return out[:m], ok[:m]


def top_k_nn(query: torch.Tensor, q_valid: torch.Tensor, ref: torch.Tensor,
             r_valid: torch.Tensor, k: int = 5, chunk: int = 8192):
    """k nearest neighbours of each query in ref by brute force, chunked so
    the distance matrix never grows beyond (Q, chunk) (the reference's
    replacement of the mapping KD-trees, lidar_mapping_node.cpp:1355-1357,
    1465).  Returns (idx (Q,k) int32, d2 (Q,k)); invalid refs are at +inf
    and invalid queries get +inf distances.

    The distance is the reference's expanded form qq + rr - 2·q·rᵀ, whose
    rounding decides near ties.  Ties keep the lower index, as `lax.top_k`
    does on the concatenated (best so far, new chunk) row: a first-index
    argmin for k=1, a stable sort otherwise.  The (Q, chunk) block is
    formed in place (256 MiB in float32 at 8192 x 8192)."""
    Q, R = query.shape[0], ref.shape[0]
    dev = query.device
    qq = torch.sum(query * query, dim=-1, keepdim=True)
    best_d = torch.full((Q, k), torch.inf, dtype=query.dtype, device=dev)
    best_i = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    for c0 in range(0, R, chunk):
        r, rv = ref[c0:c0 + chunk], r_valid[c0:c0 + chunk]
        d2 = (qq + torch.sum(r * r, dim=-1)[None, :]).sub_(
            torch.matmul(query, r.T).mul_(2.0))
        d2.clamp_(min=0.0).masked_fill_(~rv[None, :], torch.inf)
        if k == 1:
            a = torch.argmin(d2, dim=1, keepdim=True)
            m = torch.gather(d2, 1, a)
            take = m < best_d
            best_d = torch.where(take, m, best_d)
            best_i = torch.where(take, (a + c0).to(torch.int32), best_i)
        else:
            ids = torch.arange(c0, c0 + r.shape[0], dtype=torch.int32,
                               device=dev).expand(Q, -1)
            cat_d = torch.cat([best_d, d2], dim=1)
            sel = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
            best_d = torch.gather(cat_d, 1, sel)
            best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1, sel)
    best_d = torch.where(q_valid[:, None], best_d, torch.inf)
    return best_i, best_d

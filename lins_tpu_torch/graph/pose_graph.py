"""SE(3) pose-graph optimisation (port of `lins_tpu/graph/pose_graph.py`;
reference C22, lidar_mapping_node.cpp:1654-1795 — PriorFactor /
BetweenFactor / iSAM2).

iSAM2 becomes a batched Gauss-Newton re-solve over the whole graph, as in
the reference package.  Per iteration:
  * per-edge 6-dim residuals r = [log(q_m⁻¹ q_i⁻¹ q_j), R_iᵀ(p_j-p_i) - t_m]
  * per-edge 6x12 Jacobians by forward-mode autodiff
    (`torch.func.vmap(torch.func.jacfwd(...))`, the reference's
    `vmap(jacfwd)`), through the port's `so3` and its small-angle branches;
  * scatter-add of the four 6x6 blocks into the dense (6K, 6K) normal matrix;
  * one Cholesky solve (`cholesky_ex` + two triangular solves: nothing is
    read back to the host, a failed factorisation becomes a non-finite step,
    as JAX's Cholesky returns NaN) and a boxplus update.
A failed step is a no-op iteration.  Edges and nodes live in fixed-capacity
masked arrays.

`optimize_cg` solves the same problem matrix-free, as the reference does
above 1024 keyframes, where the dense (6K)² matrix walls out: per Gauss-
Newton iteration the per-edge residuals and Jacobians, the gradient and
the 6x6 block diagonal by scatter-adds, then a fixed number of
block-Jacobi-preconditioned CG iterations whose (H + diag) v products are
per-edge 6x6 contractions and scatter-adds (O(E) memory).  The blocks are
inverted by a batched `torch.linalg.inv_ex`, and the non-finite guard
stays on the device: no host read.  `parallel/dist_graph.py` shards the same edge terms over
devices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from lins_tpu_torch.geom import so3
from lins_tpu_torch.mapping.keyframes import put_row


class EdgeSet(NamedTuple):
    """Fixed-capacity between-factor set (odometry + loop edges)."""

    i: torch.Tensor        # (E,) int32 source node (absolute keyframe id)
    j: torch.Tensor        # (E,) int32 target node
    t: torch.Tensor        # (E,3) measured translation (in i's frame)
    q: torch.Tensor        # (E,4) measured rotation i->j (wxyz)
    w_rot: torch.Tensor    # (E,) rotation information weight (1/sigma^2)
    w_pos: torch.Tensor    # (E,) translation information weight
    valid: torch.Tensor    # (E,)
    count: torch.Tensor    # () int32


def empty_edges(cap: int, dtype=torch.float32, device=None) -> EdgeSet:
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return EdgeSet(
        i=z(cap, dt=torch.int32), j=z(cap, dt=torch.int32), t=z(cap, 3),
        q=torch.cat([torch.ones((cap, 1), dtype=dtype, device=device),
                     z(cap, 3)], dim=1),
        w_rot=z(cap), w_pos=z(cap), valid=z(cap, dt=torch.bool),
        count=z(dt=torch.int32))


def add_edge(e: EdgeSet, i, j, t, q, w_rot, w_pos) -> EdgeSet:
    """Append an edge at ring slot count % E (the oldest edge retires, as
    the oldest keyframes do)."""
    k = torch.remainder(e.count, e.i.shape[0])
    true = torch.ones((), dtype=torch.bool, device=e.valid.device)
    return e._replace(
        i=put_row(e.i, k, i), j=put_row(e.j, k, j), t=put_row(e.t, k, t),
        q=put_row(e.q, k, q), w_rot=put_row(e.w_rot, k, w_rot),
        w_pos=put_row(e.w_pos, k, w_pos), valid=put_row(e.valid, k, true),
        count=e.count + 1)


def live_view(edges: EdgeSet, count, K: int) -> EdgeSet:
    """Absolute keyframe-id endpoints as ring slots of a K-capacity store,
    with edges that touch an evicted keyframe (id < count - K) retired."""
    oldest = torch.clamp(count - K, min=0)
    ok = (edges.valid & (edges.i >= oldest) & (edges.j >= oldest)
          & (edges.i < count) & (edges.j < count))
    return edges._replace(i=torch.remainder(edges.i, K).to(torch.int32),
                          j=torch.remainder(edges.j, K).to(torch.int32),
                          valid=ok)


def relative_pose(p_i, q_i, p_j, q_j):
    """(t, q) of node j expressed in node i's frame."""
    q_rel = so3.quat_normalize(so3.quat_mul(so3.quat_inv(q_i), q_j))
    t_rel = so3.quat_rotate_inv(q_i, p_j - p_i)
    return t_rel, q_rel


def _edge_residual(xi_i, xi_j, p_i, q_i, p_j, q_j, t_m, q_m):
    """6-dim residual at tangent perturbations (xi = [dtheta(3), dp(3)])."""
    qi = so3.quat_mul(q_i, so3.exp_axis(xi_i[..., 0:3]))
    qj = so3.quat_mul(q_j, so3.exp_axis(xi_j[..., 0:3]))
    pi = p_i + xi_i[..., 3:6]
    pj = p_j + xi_j[..., 3:6]
    r_rot = so3.log_quat(so3.quat_mul(so3.quat_inv(q_m),
                                      so3.quat_mul(so3.quat_inv(qi), qj)))
    r_pos = so3.quat_rotate_inv(qi, pj - pi) - t_m
    return torch.cat([r_rot, r_pos], dim=-1)


def _edge_blocks(p_i, q_i, p_j, q_j, t_m, q_m, w_rot, w_pos):
    """Per edge (batched over the leading axis): residual (E,6), exact
    Jacobians d r / d xi_i and d r / d xi_j (E,6,6) at xi = 0, and the
    information weights (E,6).

    At xi = 0 the perturbation's `exp_axis` sits on its small-angle branch
    (the identity quaternion), whose tangent is zero, so the rotation
    columns come out zero in both packages; the branch not taken has a
    non-finite tangent there, which `torch.where` does not pass on."""
    z = torch.zeros(6, dtype=p_i.dtype, device=p_i.device)

    def one(p_i, q_i, p_j, q_j, t_m, q_m):
        def f(xi_i, xi_j):
            r = _edge_residual(xi_i, xi_j, p_i, q_i, p_j, q_j, t_m, q_m)
            return r, r
        (Ji, Jj), r = torch.func.jacfwd(f, argnums=(0, 1), has_aux=True)(z, z)
        return r, Ji, Jj

    r, Ji, Jj = torch.func.vmap(one)(p_i, q_i, p_j, q_j, t_m, q_m)
    w = torch.cat([w_rot[:, None].expand(-1, 3), w_pos[:, None].expand(-1, 3)],
                  dim=1)
    return r, Ji, Jj, w


def _active_mask(active, K: int, device):
    """A node count (0-dim) or a (K,) bool live mask, as a (K,) mask."""
    active = torch.as_tensor(active, device=device)
    if active.dim() == 0:
        return torch.arange(K, device=device) < active
    return active


def _robust_scale(r, w, edges: EdgeSet, huber_delta: float, K: int):
    """Per-edge IRLS Huber factor min(1, delta/||r||_W) on LOOP edges
    (odometry between-factors join consecutive ids, so modulo-K adjacency
    classifies live_view's ring slots, whose wrap edge is (K-1, 0))."""
    if huber_delta <= 0.0:
        return torch.ones(r.shape[0], dtype=r.dtype, device=r.device)
    rnorm = torch.sqrt(torch.clamp(torch.sum(w * r * r, dim=1), min=1e-30))
    is_loop = torch.remainder(edges.j - edges.i, K) != 1
    scale = torch.clamp(huber_delta / rnorm, max=1.0)
    return torch.where(is_loop, scale, 1.0).to(r.dtype)


def _block_index(a, b, K: int):
    """Flat indices into a (6K, 6K) matrix of the 6x6 blocks (a[e], b[e])."""
    r6 = torch.arange(6, device=a.device)
    rows = a.long()[:, None, None] * 6 + r6[None, :, None]
    cols = b.long()[:, None, None] * 6 + r6[None, None, :]
    return rows * (6 * K) + cols


def build_normal_system(pos, quat, edges: EdgeSet, huber_delta: float = 0.0):
    """Dense block normal equations (H (K,6,K,6), g (K,6)) of an edge set;
    huber_delta > 0 IRLS-downweights loop edges (_robust_scale).  The block
    scatter-adds accumulate in no fixed order on the card."""
    K = pos.shape[0]
    ii, jj = edges.i.long(), edges.j.long()
    r, Ji, Jj, w = _edge_blocks(pos[ii], quat[ii], pos[jj], quat[jj],
                                edges.t, edges.q, edges.w_rot, edges.w_pos)
    w = w * _robust_scale(r, w, edges, huber_delta, K)[:, None]
    ok = edges.valid[:, None]
    rw = torch.where(ok, r * w, 0.0)
    Jiw = torch.where(ok[..., None], Ji * w[:, :, None], 0.0)
    Jjw = torch.where(ok[..., None], Jj * w[:, :, None], 0.0)
    Ji_m = torch.where(ok[..., None], Ji, 0.0)
    Jj_m = torch.where(ok[..., None], Jj, 0.0)

    blocks = torch.stack([torch.einsum("eri,erj->eij", Jiw, Ji_m),
                          torch.einsum("eri,erj->eij", Jiw, Jj_m),
                          torch.einsum("eri,erj->eij", Jjw, Ji_m),
                          torch.einsum("eri,erj->eij", Jjw, Jj_m)])
    idx = torch.stack([_block_index(edges.i, edges.i, K),
                       _block_index(edges.i, edges.j, K),
                       _block_index(edges.j, edges.i, K),
                       _block_index(edges.j, edges.j, K)])
    H = torch.zeros(36 * K * K, dtype=pos.dtype, device=pos.device)
    H.index_add_(0, idx.reshape(-1), blocks.reshape(-1))
    g = torch.zeros((K, 6), dtype=pos.dtype, device=pos.device)
    g.index_add_(0, ii, torch.einsum("eri,er->ei", Ji_m, rw))
    g.index_add_(0, jj, torch.einsum("eri,er->ei", Jj_m, rw))
    return H.reshape(K, 6, K, 6), g


def _diag_weights(active, K: int, prior_slot, prior_w, damping, dtype):
    """The gauge prior on `prior_slot` and on dead slots, damping on the
    rest (K,)."""
    node_ids = torch.arange(K, device=active.device)
    pw = torch.full((), prior_w, dtype=dtype, device=active.device)
    return torch.where(node_ids == prior_slot, pw,
                       torch.where(active, damping, pw)).to(dtype)


def solve_and_clamp(H, g, active, prior_w, damping, prior_slot=0):
    """Add the gauge prior and damping, Cholesky-solve, zero the inactive
    nodes' updates.  A factorisation that fails (info != 0) gives a
    non-finite step."""
    K = g.shape[0]
    diag_w = _diag_weights(active, K, prior_slot, prior_w, damping, g.dtype)
    Hd = H.reshape(6 * K, 6 * K) + torch.diag(
        torch.repeat_interleave(diag_w, 6))
    L, info = torch.linalg.cholesky_ex(Hd)
    y = torch.linalg.solve_triangular(L, g.reshape(-1, 1), upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    dx = torch.where(info == 0, -x.reshape(K, 6), torch.nan)
    return torch.where(active[:, None], dx, 0.0)


def gn_update(pos, quat, dx, active):
    """The boxplus update of one Gauss-Newton iteration: inactive nodes
    stay, and a step with any non-finite entry is a no-op (the reference's
    NaN scrub, lidar_mapping_node.cpp:738-750)."""
    dx = torch.where(active[:, None], dx, 0.0)
    dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
    quat = so3.quat_normalize(so3.quat_mul(quat, so3.exp_axis(dx[:, 0:3])))
    return pos + dx[:, 3:6], quat


def optimize(pos, quat, active, edges: EdgeSet, iters: int = 8,
             prior_w: float = 1e6, damping: float = 1e-6, prior_slot=0,
             huber_delta: float = 0.0):
    """Batched Gauss-Newton over the pose graph: `iters` fixed iterations.
    pos (K,3), quat (K,4); `active` is a node count or a (K,) live mask;
    `prior_slot` carries the gauge prior (the oldest live node once node 0
    has been evicted).  A step with any non-finite entry is a no-op (the
    reference's NaN scrub, lidar_mapping_node.cpp:738-750).  Returns
    (pos, quat)."""
    active = _active_mask(active, pos.shape[0], pos.device)
    for _ in range(iters):
        H, g = build_normal_system(pos, quat, edges, huber_delta)
        dx = solve_and_clamp(H, g, active, prior_w, damping, prior_slot)
        pos, quat = gn_update(pos, quat, dx, active)
    return pos, quat


# --- sparse (matrix-free) solve -------------------------------------------

def _edge_system(pos, quat, edges: EdgeSet, huber_delta: float = 0.0):
    """Per-edge residuals (E,6), Jacobians (E,6,6) x 2 and weights (E,6),
    zero on invalid edges; huber_delta > 0 IRLS-downweights loop edges."""
    ii, jj = edges.i.long(), edges.j.long()
    r, Ji, Jj, w = _edge_blocks(pos[ii], quat[ii], pos[jj], quat[jj],
                                edges.t, edges.q, edges.w_rot, edges.w_pos)
    w = w * _robust_scale(r, w, edges, huber_delta, pos.shape[0])[:, None]
    ok = edges.valid
    return (torch.where(ok[:, None], r, 0.0),
            torch.where(ok[:, None, None], Ji, 0.0),
            torch.where(ok[:, None, None], Jj, 0.0),
            torch.where(ok[:, None], w, 0.0))


def _gradient_and_diag(r, Ji, Jj, w, i, j, K: int):
    """g = Jᵀ W r (K,6) and the block diagonal of H (K,6,6), by scatter-adds
    (in no fixed order on the card)."""
    ii, jj = i.long(), j.long()
    g = torch.zeros((K, 6), dtype=r.dtype, device=r.device)
    g.index_add_(0, ii, torch.einsum("eri,er->ei", Ji, w * r))
    g.index_add_(0, jj, torch.einsum("eri,er->ei", Jj, w * r))
    D = torch.zeros((K, 6, 6), dtype=r.dtype, device=r.device)
    D.index_add_(0, ii, torch.einsum("eri,er,erj->eij", Ji, w, Ji))
    D.index_add_(0, jj, torch.einsum("eri,er,erj->eij", Jj, w, Jj))
    return g, D


def _hv(v, Ji, Jj, w, i, j, diag_w, K: int):
    """Matrix-free (H + diag(diag_w)) @ v for v (K,6)."""
    ii, jj = i.long(), j.long()
    re = w * (torch.einsum("erc,ec->er", Ji, v[ii])
              + torch.einsum("erc,ec->er", Jj, v[jj]))
    out = torch.zeros((K, 6), dtype=v.dtype, device=v.device)
    out.index_add_(0, ii, torch.einsum("erc,er->ec", Ji, re))
    out.index_add_(0, jj, torch.einsum("erc,er->ec", Jj, re))
    return out + diag_w[:, None] * v


def _pcg(matvec, Minv, b, iters: int):
    """Preconditioned CG on an SPD system, a fixed number of iterations (a
    zero denominator gives a zero step, as in the reference)."""
    x = torch.zeros_like(b)
    r = b
    z = Minv(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        hp = matvec(p)
        denom = torch.sum(p * hp)
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * hp
        z = Minv(r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.where(rz == 0, 1.0, rz) * p
        rz = rz_new
    return x


def block_inverse(D):
    """Batched inverse of the (K,6,6) preconditioner blocks with no host
    read (`inv_ex`, its error check on the device): a singular block
    becomes NaN, which the step's finite guard turns into a no-op, as the
    reference's `jnp.linalg.inv` gives NaN."""
    inv, info = torch.linalg.inv_ex(D)
    return torch.where(info[:, None, None] == 0, inv, torch.nan)


def optimize_cg(pos, quat, active, edges: EdgeSet, iters: int = 8,
                cg_iters: int = 64, prior_w: float = 1e6,
                damping: float = 1e-3, prior_slot=0, huber_delta: float = 0.0):
    """Sparse pose-graph Gauss-Newton: the problem of `optimize`, solved
    matrix-free by block-Jacobi-preconditioned CG, `cg_iters` fixed
    iterations per GN iteration.  O(E) memory, where the dense path needs
    (6K)²; the reference's mapper takes it above 1024 keyframes."""
    K = pos.shape[0]
    active = _active_mask(active, K, pos.device)
    diag_w = _diag_weights(active, K, prior_slot, prior_w, damping, pos.dtype)
    eye = torch.eye(6, dtype=pos.dtype, device=pos.device)
    for _ in range(iters):
        r, Ji, Jj, w = _edge_system(pos, quat, edges, huber_delta)
        g, D = _gradient_and_diag(r, Ji, Jj, w, edges.i, edges.j, K)
        Dinv = block_inverse(D + eye * diag_w[:, None, None])
        dx = -_pcg(lambda v: _hv(v, Ji, Jj, w, edges.i, edges.j, diag_w, K),
                   lambda v: torch.einsum("kij,kj->ki", Dinv, v), g, cg_iters)
        pos, quat = gn_update(pos, quat, dx, active)
    return pos, quat


def graph_cost(pos, quat, edges: EdgeSet):
    """Weighted SSE of all edge residuals (tests, telemetry)."""
    ii, jj = edges.i.long(), edges.j.long()
    z = torch.zeros_like(edges.t[:, :1]).expand(-1, 6)
    r = _edge_residual(z, z, pos[ii], quat[ii], pos[jj], quat[jj], edges.t,
                       edges.q)
    w = torch.cat([edges.w_rot[:, None].expand(-1, 3),
                   edges.w_pos[:, None].expand(-1, 3)], dim=1)
    return torch.sum(torch.where(edges.valid[:, None], w * r * r, 0.0))

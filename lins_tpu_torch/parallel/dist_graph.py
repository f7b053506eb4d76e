"""Edge-sharded pose-graph solves over a mesh (port of
`lins_tpu/parallel/dist_graph.py`; SURVEY.md §2 P3).

The edge set is split over the mesh's shards; every shard builds the
contribution of its own edges, the contributions are summed over the mesh
(`Mesh.psum`: the local shards in order, then `all_reduce` across
processes), and the node state is replicated.  The dense solve reduces the
normal system once per Gauss-Newton iteration; the sparse solve reduces
the gradient and block diagonal once per GN iteration and the Hv product
once per CG iteration.
"""
from __future__ import annotations

import torch

from lins_tpu_torch.graph import pose_graph as pg
from lins_tpu_torch.parallel.multihost import Mesh


def pad_edges(edges: pg.EdgeSet, n_devices: int) -> pg.EdgeSet:
    """Pad the edge arrays so that the capacity divides the mesh size
    (padding: invalid edges with the identity rotation)."""
    E = edges.i.shape[0]
    E_pad = -(-E // n_devices) * n_devices
    if E_pad == E:
        return edges
    pad = E_pad - E

    def padf(x, fill=0):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=x.device)])

    q = padf(edges.q)
    q[E:, 0] = 1.0
    return pg.EdgeSet(i=padf(edges.i), j=padf(edges.j), t=padf(edges.t), q=q,
                      w_rot=padf(edges.w_rot), w_pos=padf(edges.w_pos),
                      valid=padf(edges.valid, False), count=edges.count)


def shard_edges(mesh: Mesh, edges: pg.EdgeSet):
    """This process's shards of the padded edge set, each on its device:
    mesh shard s holds rows [s E/n, (s+1) E/n)."""
    edges = pad_edges(edges, mesh.size)
    per = edges.i.shape[0] // mesh.size
    out = []
    for d, dev in enumerate(mesh.devices):
        lo = (mesh.offset + d) * per
        out.append(pg.EdgeSet(*(x[lo:lo + per].to(dev) for x in edges[:-1]),
                              edges.count.to(dev)))
    return out


def _replicas(mesh: Mesh, *xs):
    """The node state on every local shard's device."""
    return [[x.to(dev) for x in xs] for dev in mesh.devices]


def make_sharded_optimizer(mesh: Mesh, K: int, iters: int = 8,
                           prior_w: float = 1e6, damping: float = 1e-6):
    """Edge-sharded dense Gauss-Newton over graphs of K node slots.

    Returns fn(pos (K,3), quat (K,4), n_nodes (a count or (K,) mask), edges,
    prior_slot=0) -> (pos, quat): per iteration each shard builds the normal
    system of its edges, one `psum` sums them, and the replicated solve
    (`pose_graph.solve_and_clamp`) runs once on the first device."""
    def apply(pos, quat, n_nodes, edges: pg.EdgeSet, prior_slot=0):
        dev = mesh.devices[0]
        pos, quat = pos.to(dev), quat.to(dev)
        active = pg._active_mask(n_nodes, K, dev)
        shards = shard_edges(mesh, edges)
        for _ in range(iters):
            parts = [pg.build_normal_system(p, q, e)
                     for (p, q), e in zip(_replicas(mesh, pos, quat), shards)]
            H = mesh.psum([h for h, _ in parts])
            g = mesh.psum([g for _, g in parts])
            dx = pg.solve_and_clamp(H, g, active, prior_w, damping,
                                    prior_slot)
            pos, quat = pg.gn_update(pos, quat, dx, active)
        return pos, quat

    return apply


def make_sharded_cg_optimizer(mesh: Mesh, K: int, iters: int = 8,
                              cg_iters: int = 64, prior_w: float = 1e6,
                              damping: float = 1e-3):
    """Edge-sharded sparse Gauss-Newton (`pose_graph.optimize_cg`): the
    gradient and block diagonal summed once per GN iteration, the Hv
    product once per CG iteration, the node state and the CG vectors
    replicated.  O(E/n + K) memory a shard.  Same signature as
    `make_sharded_optimizer`'s function."""
    def apply(pos, quat, n_nodes, edges: pg.EdgeSet, prior_slot=0):
        dev = mesh.devices[0]
        dtype = pos.dtype
        pos, quat = pos.to(dev), quat.to(dev)
        active = pg._active_mask(n_nodes, K, dev)
        diag_w = pg._diag_weights(active, K, prior_slot, prior_w, damping,
                                  dtype)
        eye = torch.eye(6, dtype=dtype, device=dev)
        shards = shard_edges(mesh, edges)
        zeros = [torch.zeros(K, dtype=dtype, device=d) for d in mesh.devices]
        for _ in range(iters):
            systems = [pg._edge_system(p, q, e)
                       for (p, q), e in zip(_replicas(mesh, pos, quat),
                                            shards)]
            parts = [pg._gradient_and_diag(*s, e.i, e.j, K)
                     for s, e in zip(systems, shards)]
            g = mesh.psum([g for g, _ in parts])
            D = mesh.psum([D for _, D in parts])
            Dinv = pg.block_inverse(D + eye * diag_w[:, None, None])

            def matvec(v):
                hv = mesh.psum([
                    pg._hv(v.to(z.device), Ji, Jj, w, e.i, e.j, z, K)
                    for (_, Ji, Jj, w), e, z in zip(systems, shards, zeros)])
                return hv + diag_w[:, None] * v

            dx = -pg._pcg(matvec,
                          lambda v: torch.einsum("kij,kj->ki", Dinv, v), g,
                          cg_iters)
            pos, quat = pg.gn_update(pos, quat, dx, active)
        return pos, quat

    return apply

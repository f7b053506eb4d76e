"""Pose-graph factors (port of the edge part of
`lins_tpu/graph/pose_graph.py`; reference C22, lidar_mapping_node.cpp:
1654-1795).

The mapping step writes one odometry between-factor per keyframe
(saveKeyFramesAndFactor, :1693-1703) into a fixed-capacity ring of edges.
The solve over them (`live_view`, `optimize`, `optimize_cg`) belongs to
loop closure, the port's slice 3.
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


def relative_pose(p_i, q_i, p_j, q_j):
    """(t, q) of node j expressed in node i's frame."""
    q_rel = so3.quat_normalize(so3.quat_mul(so3.quat_inv(q_i), q_j))
    t_rel = so3.quat_rotate_inv(q_i, p_j - p_i)
    return t_rel, q_rel

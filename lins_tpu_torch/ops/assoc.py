"""Fused scan-to-scan association and normal equations: the CUDA kernels K4
and K5 and their plain PyTorch versions.

`surf_normal_equations` replaces the TPU kernel
`attic/pallas_assoc.py::surf_normal_equations` (body `_surf_kernel`) and
`corner_normal_equations` replaces `corner_normal_equations` (body
`_corner_kernel`).  Per query point of the new scan (a flat point for K4, a
sharp one for K5):

  1. de-skew it into the scan's start frame at the linearisation pose
     (rn, qbn): exp(rel·φ) ⊗ p + rel·rn, φ = log(qbn);
  2. its tripod among the previous scan's reference set (less-flat for K4,
     less-sharp for K5): i1 the nearest valid reference; K4 then i2 the
     nearest on ring[i1] other than i1 and i3 the nearest on another ring
     within ±2; K5 i2 the nearest on another ring within ±2;
  3. the point-to-plane (K4) or point-to-line (K5) residual, its direction
     and the distance weight s, as `odometry/association.py` forms them; the
     row is kept (`ok`) when the query is valid, every tripod distance is
     below max_d2, s > 0.1, the residual is not 0 and the plane (line) is
     not degenerate;
  4. the row J6 = [H_att, s·jac] and its residual column, summed over the
     kept rows into (J6ᵀJ6 (6,6), J6ᵀr (6,), Σr², n_matched).

Two row forms, fixed per call:
  "ieskf"  H_att = ((−Rᵀc) × p)·Rinv(−φ), R = R(qbn), residual column
           lidar_scale·s·res (`lins_tpu/odometry/ieskf.py::
           _measurement_blocks`);
  "gn"     H_att = (−R_sᵀc) × p with each point's own de-skew rotation
           R_s = R(exp(rel·φ)), residual column −0.05·s·res
           (`lins_tpu/odometry/gn_icp.py::gn_step`).
c is s·jac, and p the query point before the de-skew (`Matches.point`).

The selection and scaling are those of the reference package's production
path, `lins_tpu/odometry/ieskf.py::_blocks_xla`, and not the attic
kernel's, in four places: ties go to the first lowest index (the attic
averages every reference tied at the minimum, `_normalized_onehot`, which
only stood in for a gather on the TPU); K4's same-ring search leaves out
only i1 (the attic leaves out every reference at d1 or nearer); the
residual column carries lidar_scale (1.0 in every preset); the weight
state is a host int (`iter_count >= icp_freq`), because the loops run
fixed trips.  Wherever every minimum is unique the result equals the attic
kernel's.  The summed K4 and K5 blocks equal `_blocks_xla`'s JtJ and Jtr,
and sqrt(Σr²_surf + Σr²_corner) is its `res_norm`.  Masked rows add exact
zeros by selection, so a padded row with non-finite coordinates cannot
turn the sums into NaN.  The attic's query count (a multiple of its
128-row tile) is not carried over.

Distances are direct differences, d2 = (dx·dx + dy·dy) + dz·dz with each
operation rounded on its own, not the reference's expansion
|a|² + |b|² − 2a·b (`lins_tpu/odometry/association.py:52-63`), which in
float32 loses about 1e-3 m² at 30 m.  A NaN distance counts as no
candidate (the reference's argmin would take it).  The plain versions
compute the de-skew, the distances and everything the row's `ok` depends
on with the kernel's operations in the kernel's order, one PyTorch op per
operation, so on the card the kernel's neighbour picks and counts equal the
plain version's; the sums differ by float32 rounding order only.

On a CUDA tensor each wrapper launches `csrc/assoc_normal_equations.cu`
(design and bound in its header) or raises; there is no fallback, and the
card takes float32 only.  The kernel reads each reference set in the
layout `ring_layout` makes once a scan (valid rows in ring order, a
ring-offset table), so pass 1 visits the valid rows only and pass 2 the
±2 ring window only; the original index rides along, so ties still go to
the first lowest index.  On a CPU tensor it runs the plain version in the
input dtype (the float64 parity tests reach it so).
`scan_normal_equations` is the odometry's entry: both sets of one trip in
one launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lins_tpu_torch.geom import so3
from lins_tpu_torch.ops import build

SURF, CORNER = "surf", "corner"
FORMS = {"ieskf": 0, "gn": 1}
# the GN fallback's residual column: b = -0.05 * s * res (gn_icp.gn_step)
GN_RES_SCALE = -0.05
# rings the card's reference layout can hold (csrc kRings): a ring is the
# low byte of each laid-out row's word
_RINGS = 256
# references the layout can index: the word is (index << 8 | ring) as int32
_MAX_REFS = 2 ** 23
# floats of each query's row in the kernel's scratch (csrc kRow)
_ROW = 8


class Queries(NamedTuple):
    """A query set: the new scan's flat (K4) or sharp (K5) features."""

    xyz: torch.Tensor     # (Q, 3)
    rel: torch.Tensor     # (Q,) relative time in the sweep, [0, 1]
    valid: torch.Tensor   # (Q,) bool


class References(NamedTuple):
    """A reference set: the previous scan's less-flat or less-sharp
    features in its end frame.  `packed` and `offsets` are the card's
    layout of it (`ring_layout`), made once per scan; None on the CPU."""

    xyz: torch.Tensor     # (R, 3)
    ring: torch.Tensor    # (R,) int, in [0, _RINGS)
    valid: torch.Tensor   # (R,) bool
    packed: torch.Tensor | None     # (R, 4) float32
    offsets: torch.Tensor | None    # (_RINGS + 1,) int32


def queries(fc, dtype) -> Queries:
    """A FeatureCloud (or anything with xyz, rel_time, valid) as a query
    set in `dtype`."""
    return Queries(fc.xyz.to(dtype).contiguous(),
                   fc.rel_time.to(dtype).contiguous(), fc.valid.contiguous())


def ring_layout(xyz, ring, valid):
    """The card's layout of a reference set, on the set's device with no
    host read: (packed (R, 4) float32, offsets (_RINGS + 1,) int32).

    The first offsets[_RINGS] rows of `packed` are the valid references
    with finite coordinates, in ring order and, within a ring, in
    ascending original index (a stable sort on the ring); each is x, y, z
    in float32 and the word (index << 8 | ring) as int32 bits.  offsets[r]
    is the first row of ring r.  The rows past the valid ones are the rest
    of the set, in the same form, and are never read.  Rings lie in
    [0, _RINGS) (every sensor preset has at most 128)."""
    xyz = xyz.to(torch.float32)
    ok = valid & torch.isfinite(xyz).all(dim=1)
    key = torch.where(ok, ring.to(torch.int32), _RINGS)
    skey, order = torch.sort(key, stable=True)
    word = (order.to(torch.int32) << 8) | (skey & (_RINGS - 1))
    packed = torch.cat([xyz[order], word.view(torch.float32)[:, None]],
                       dim=1).contiguous()
    offsets = torch.searchsorted(
        skey, torch.arange(_RINGS + 1, dtype=torch.int32, device=xyz.device),
        out_int32=True)
    return packed, offsets


def references(xyz, ring, valid) -> References:
    """A reference set; on the card it is also laid out for the kernel
    (`ring_layout`) once, outside the trip loops."""
    packed = offsets = None
    if xyz.device.type != "cpu":
        packed, offsets = ring_layout(xyz, ring, valid)
    return References(xyz, ring, valid, packed, offsets)


def reference_sets(last_surf: dict, last_corner: dict, dtype):
    """The odometry's two reference dicts ({xyz, ring, valid}) as
    References in `dtype`."""
    return tuple(references(d["xyz"].to(dtype), d["ring"], d["valid"])
                 for d in (last_surf, last_corner))


def pose_scalars(rn, qbn, form: str):
    """The trip's pose scalars, on the pose's device: rn (3), φ = log(qbn)
    (3) and, for the "ieskf" form, qbn (4; Rᵀc is c rotated by its
    conjugate) and Rinv(−φ) row-major (9).  The kernel reads them by
    pointer (no host read per trip)."""
    phi = so3.log_quat(qbn)
    parts = [rn, phi]
    if form == "ieskf":
        parts += [qbn, so3.rinv_left(-phi).reshape(-1)]
    return torch.cat(parts).contiguous()


POSE_SIZE = {"ieskf": 19, "gn": 6}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _norm(x, y, z):
    return torch.sqrt((x * x + y * y) + z * z)


def _rotate_inv(w, x, y, z, c):
    """c rotated by the conjugate of the unit quaternion (w, x, y, z)
    (= Rᵀc), as `so3.quat_rotate` forms a rotation."""
    uv = _cross(-x, -y, -z, *c)
    uuv = _cross(-x, -y, -z, *uv)
    return [c[k] + 2.0 * (w * uv[k] + uuv[k]) for k in range(3)]


def deskew(xyz, rel, pose):
    """exp(rel·φ) ⊗ p + rel·rn, as the kernel forms it.  Returns the
    de-skewed coordinates (x, y, z) and each point's rotation quaternion
    (w, ux, uy, uz)."""
    vx, vy, vz = rel * pose[3], rel * pose[4], rel * pose[5]
    theta = _norm(vx, vy, vz)
    small = theta < 1e-10
    safe = torch.where(small, 1.0, theta)
    half = theta * 0.5
    sh, ch = torch.sin(half), torch.cos(half)
    w = torch.where(small, 1.0, ch)
    ux, uy, uz = (torch.where(small, 0.0, (v / safe) * sh)
                  for v in (vx, vy, vz))
    px, py, pz = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    uvx, uvy, uvz = _cross(ux, uy, uz, px, py, pz)
    cx, cy, cz = _cross(ux, uy, uz, uvx, uvy, uvz)
    ox = (px + 2.0 * (w * uvx + cx)) + rel * pose[0]
    oy = (py + 2.0 * (w * uvy + cy)) + rel * pose[1]
    oz = (pz + 2.0 * (w * uvz + cz)) + rel * pose[2]
    return (ox, oy, oz), (w, ux, uy, uz)


def pairwise_d2(p, r):
    """(Q, R) squared distances ((dx·dx + dy·dy) + dz·dz), each operation
    rounded alone, p a triple of (Q,) coordinates, r (R, 3)."""
    d2 = p[0][:, None] - r[None, :, 0]
    d2.mul_(d2)
    d = torch.empty_like(d2)
    for k in (1, 2):
        torch.sub(p[k][:, None], r[None, :, k], out=d)
        d2.add_(d.mul_(d))
    return d2


def _argmin(D):
    """First lowest index of each row and its value."""
    idx = torch.argmin(D, dim=1)
    return idx, torch.gather(D, 1, idx[:, None])[:, 0]


def _tripod(kind, p0, ref: References):
    """Indices and distances of each query's tripod (the kernel's two
    passes): i1, d1, then (i2, d2m[, i3, d3m])."""
    inf = torch.inf
    D = pairwise_d2(p0, ref.xyz)
    D.nan_to_num_(nan=inf, posinf=inf).masked_fill_(~ref.valid[None, :], inf)
    i1, d1 = _argmin(D)
    ring = ref.ring.to(torch.int32)
    gap = (ring[None, :] - ring[i1][:, None]).abs_()
    buf = torch.where((gap <= 2) & (gap != 0), D, inf)
    far = _argmin(buf)
    if kind == CORNER:
        return i1, d1, far
    buf.copy_(D).masked_fill_(gap != 0, inf)
    buf[torch.arange(buf.shape[0], device=buf.device), i1] = inf
    return i1, d1, _argmin(buf), far


def _rows(kind, q: Queries, ref: References, pose, form, weighted: bool,
          max_d2: float, res_scale: float):
    """(Q, 8) rows [H_att, s·jac, residual column, ok] with exact zeros
    where the row is not kept."""
    if ref.xyz.shape[0] == 0:      # no reference: no row is kept
        return q.xyz.new_zeros((q.xyz.shape[0], 8))
    p0, (qw, qx, qy, qz) = deskew(q.xyz, q.rel, pose)
    tri = _tripod(kind, p0, ref)
    i1, d1 = tri[0], tri[1]
    matched = q.valid & (d1 < max_d2)
    for _, dm in tri[2:]:
        matched = matched & (dm < max_d2)
    r = ref.xyz
    P1 = r[i1]
    P2 = r[tri[2][0]]
    if kind == SURF:
        P3 = r[tri[3][0]]
        a = [P1[:, k] - P2[:, k] for k in range(3)]
        b = [P1[:, k] - P3[:, k] for k in range(3)]
        Mx, My, Mz = _cross(*a, *b)
        m = _norm(Mx, My, Mz)
        m_safe = torch.clamp(m, min=1e-12)
        dp = [p0[k] - P1[:, k] for k in range(3)]
        res = ((dp[0] * Mx + dp[1] * My) + dp[2] * Mz) / m_safe
        jac = (Mx / m_safe, My / m_safe, Mz / m_safe)
        pn = _norm(*p0)
        w = 1.0 - 1.8 * torch.abs(res) / torch.sqrt(torch.sqrt(
            torch.clamp(pn, min=1e-12)))
        degenerate = m
    else:
        a = [p0[k] - P1[:, k] for k in range(3)]
        b = [p0[k] - P2[:, k] for k in range(3)]
        Pc = _cross(*a, *b)
        rr = _norm(*Pc)
        d12 = _norm(*(P1[:, k] - P2[:, k] for k in range(3)))
        denom = torch.clamp(d12 * rr, min=1e-12)
        res = rr / torch.clamp(d12, min=1e-12)
        e = [P2[:, k] - P1[:, k] for k in range(3)]
        jac = tuple(c / denom for c in _cross(*Pc, *e))
        w = 1.0 - 1.8 * torch.abs(res)
        degenerate = rr
    s = w if weighted else torch.ones_like(w)
    ok = matched & (s > 0.1) & (res != 0.0) & (degenerate > 1e-12)
    c = [s * j for j in jac]
    rw = res_scale * (s * res)
    px, py, pz = q.xyz[:, 0], q.xyz[:, 1], q.xyz[:, 2]
    if form == "ieskf":          # g = (−Rᵀc) × p, H_att = g·Rinv
        t = _rotate_inv(*pose[6:10], c)
        g = _cross(*(-x for x in t), px, py, pz)
        V = pose[10:19].reshape(3, 3)
        h = [(g[0] * V[0, j] + g[1] * V[1, j]) + g[2] * V[2, j]
             for j in range(3)]
    else:                        # H_att = (−R_sᵀc) × p
        t = _rotate_inv(qw, qx, qy, qz, c)
        h = list(_cross(*(-x for x in t), px, py, pz))
    rows = torch.stack(h + c + [rw, torch.ones_like(rw)], dim=1)
    return torch.where(ok[:, None], rows, 0.0)


def _sums(rows):
    """(JtJ (6,6), Jtr (6,), Σr², n_matched int32) of kept rows."""
    J6, rw = rows[:, :6], rows[:, 6]
    return (J6.T @ J6, J6.T @ rw, torch.sum(rw * rw),
            torch.sum(rows[:, 7] > 0).to(torch.int32))


def _plain(kind, q: Queries, ref: References, pose, form, weighted, max_d2,
           res_scale):
    _PLAIN[kind].calls += 1
    return _sums(_rows(kind, q, ref, pose, form, weighted, max_d2,
                       res_scale))


def _res_scale(form, lidar_scale):
    return float(lidar_scale) if form == "ieskf" else GN_RES_SCALE


def _args(q_xyz, q_rel, q_valid, r_xyz, r_ring, r_valid, rn, qbn,
          iter_count, icp_freq, form):
    if form not in FORMS:
        raise ValueError(f"unknown row form {form!r}; one of {list(FORMS)}")
    return (Queries(q_xyz.contiguous(), q_rel.contiguous(),
                    q_valid.contiguous()),
            references(r_xyz, r_ring, r_valid), pose_scalars(rn, qbn, form),
            int(iter_count) >= icp_freq)


def surf_normal_equations_plain(q_xyz, q_rel, q_valid, r_xyz, r_ring,
                                r_valid, rn, qbn, iter_count, max_d2=25.0,
                                icp_freq=1, form="ieskf", lidar_scale=1.0):
    """Plain PyTorch K4 in the input dtype: (JtJ (6,6), Jtr (6,), Σr²,
    n_matched)."""
    q, ref, pose, weighted = _args(q_xyz, q_rel, q_valid, r_xyz, r_ring,
                                   r_valid, rn, qbn, iter_count, icp_freq,
                                   form)
    return _plain(SURF, q, ref, pose, form, weighted, max_d2,
                  _res_scale(form, lidar_scale))


def corner_normal_equations_plain(q_xyz, q_rel, q_valid, r_xyz, r_ring,
                                  r_valid, rn, qbn, iter_count, max_d2=25.0,
                                  icp_freq=1, form="ieskf", lidar_scale=1.0):
    """Plain PyTorch K5 in the input dtype (as K4, point-to-line)."""
    q, ref, pose, weighted = _args(q_xyz, q_rel, q_valid, r_xyz, r_ring,
                                   r_valid, rn, qbn, iter_count, icp_freq,
                                   form)
    return _plain(CORNER, q, ref, pose, form, weighted, max_d2,
                  _res_scale(form, lidar_scale))


surf_normal_equations_plain.calls = 0
corner_normal_equations_plain.calls = 0
_PLAIN = {SURF: surf_normal_equations_plain,
          CORNER: corner_normal_equations_plain}


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_LIB = []
# per (device, stream): the kernel's ticket counter, which its last block
# resets to 0; launches on one stream run in order, so they never share a
# counter at the same time
_COUNTERS: dict = {}


def _lib():
    if not _LIB:
        lib = build.load("assoc_normal_equations")
        set_args = [ctypes.c_void_p] * 5 + [ctypes.c_int]
        lib.assoc_normal_equations_launch.argtypes = (
            set_args + set_args + [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_float,
                                   ctypes.c_float] + [ctypes.c_void_p] * 5)
        lib.assoc_normal_equations_launch.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def _require(arg, t, dtype, shape, device):
    build.require("assoc_normal_equations", arg, t, dtype, shape, device)


def _set_args(kind, pair, dev):
    """The launcher's six arguments of one set (null and 0 when absent)."""
    if pair is None:
        return [None] * 5 + [0]
    q, ref = pair
    Q, R = q.xyz.shape[0], ref.xyz.shape[0]
    f32 = torch.float32
    _require(f"{kind} query xyz", q.xyz, f32, (Q, 3), dev)
    _require(f"{kind} query rel", q.rel, f32, (Q,), dev)
    _require(f"{kind} query valid", q.valid, torch.bool, (Q,), dev)
    if ref.packed is None:
        raise ValueError(f"assoc_normal_equations: the {kind} reference set "
                         f"is not laid out (ops/assoc.references)")
    if R >= _MAX_REFS:
        raise ValueError(f"assoc_normal_equations: {R} {kind} references, "
                         f"the layout indexes fewer than {_MAX_REFS}")
    _require(f"{kind} packed references", ref.packed, f32, (R, 4), dev)
    _require(f"{kind} ring offsets", ref.offsets, torch.int32,
             (_RINGS + 1,), dev)
    return [q.xyz.data_ptr(), q.rel.data_ptr(), q.valid.data_ptr(),
            ref.packed.data_ptr(), ref.offsets.data_ptr(), Q]


def launch(surf, corner, pose, form: str, weighted: bool, max_d2: float,
           res_scale: float):
    """K4 and K5 on CUDA tensors in one launch: `surf` and `corner` are
    (Queries, References) pairs or None.  Returns ((JtJ, Jtr, Σr², n) of
    surf, the same of corner); an absent set gives zeros.  Each set that
    the launch computes adds one to its wrapper's `launches`.

    The last-block sum takes the ticket counter of the current stream
    (one per device and stream): launches on one stream run in order, and
    launches on two streams never share a counter.  A captured launch keeps
    its capture stream's counter, so its graph replays on that stream."""
    dev = pose.device
    if dev.type != "cuda":
        raise ValueError(f"assoc_normal_equations: unsupported device {dev}")
    _require("pose scalars", pose, torch.float32, (POSE_SIZE[form],), dev)
    args = _set_args(SURF, surf, dev) + _set_args(CORNER, corner, dev)
    Qs, Qc = args[5], args[11]
    alloc = torch.empty if Qs + Qc > 0 else torch.zeros
    out = alloc((2, 44), dtype=torch.float32, device=dev)
    out_n = alloc((2,), dtype=torch.int32, device=dev)
    if Qs + Qc > 0:
        rows = torch.empty((Qs + Qc, _ROW), dtype=torch.float32,
                           device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        counter = _COUNTERS.get((dev, stream))
        if counter is None:
            counter = _COUNTERS[(dev, stream)] = torch.zeros(
                (1,), dtype=torch.int32, device=dev)
        err = _lib().assoc_normal_equations_launch(
            *args, pose.data_ptr(), FORMS[form], int(bool(weighted)),
            float(max_d2), float(res_scale), rows.data_ptr(),
            counter.data_ptr(), out.data_ptr(), out_n.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"assoc_normal_equations kernel launch "
                               f"failed: CUDA error {err}")
        if surf is not None and Qs > 0:
            surf_normal_equations.launches += 1
        if corner is not None and Qc > 0:
            corner_normal_equations.launches += 1
    return tuple((out[s, :36].view(6, 6), out[s, 36:42], out[s, 42],
                  out_n[s]) for s in range(2))


def surf_normal_equations(q_xyz, q_rel, q_valid, r_xyz, r_ring, r_valid, rn,
                          qbn, iter_count, max_d2=25.0, icp_freq=1,
                          form="ieskf", lidar_scale=1.0):
    """Fused surf association + normal equations (K4), the attic's
    contract with `_blocks_xla`'s selection: (JtJ (6,6), Jtr (6,), Σr²,
    n_matched).

    CUDA tensors (float32): one launch of K4, counted in
    `surf_normal_equations.launches`.  CPU tensors:
    `surf_normal_equations_plain`."""
    if q_xyz.device.type == "cpu":
        return surf_normal_equations_plain(
            q_xyz, q_rel, q_valid, r_xyz, r_ring, r_valid, rn, qbn,
            iter_count, max_d2, icp_freq, form, lidar_scale)
    q, ref, pose, weighted = _args(q_xyz, q_rel, q_valid, r_xyz, r_ring,
                                   r_valid, rn, qbn, iter_count, icp_freq,
                                   form)
    return launch((q, ref), None, pose, form, weighted, max_d2,
                  _res_scale(form, lidar_scale))[0]


def corner_normal_equations(q_xyz, q_rel, q_valid, r_xyz, r_ring, r_valid,
                            rn, qbn, iter_count, max_d2=25.0, icp_freq=1,
                            form="ieskf", lidar_scale=1.0):
    """Fused corner association + normal equations (K5), as
    `surf_normal_equations` with point-to-line rows."""
    if q_xyz.device.type == "cpu":
        return corner_normal_equations_plain(
            q_xyz, q_rel, q_valid, r_xyz, r_ring, r_valid, rn, qbn,
            iter_count, max_d2, icp_freq, form, lidar_scale)
    q, ref, pose, weighted = _args(q_xyz, q_rel, q_valid, r_xyz, r_ring,
                                   r_valid, rn, qbn, iter_count, icp_freq,
                                   form)
    return launch(None, (q, ref), pose, form, weighted, max_d2,
                  _res_scale(form, lidar_scale))[1]


surf_normal_equations.launches = 0
corner_normal_equations.launches = 0


def scan_normal_equations(flat: Queries, sharp: Queries, surf: References,
                          corner: References, rn, qbn, iter_count: int, cfg,
                          form: str):
    """One trip's association of a scan against the previous one: K4 on
    (flat, surf) and K5 on (sharp, corner) at the pose (rn, qbn), in one
    launch on the card and by the plain versions on the CPU.  Returns
    ((JtJ, Jtr, Σr², n) of surf, the same of corner)."""
    pose = pose_scalars(rn, qbn, form)
    weighted = iter_count >= cfg.icp_freq
    max_d2 = cfg.nearest_feature_search_sq_dist
    scale = _res_scale(form, cfg.lidar_scale)
    if pose.device.type == "cpu":
        return (_plain(SURF, flat, surf, pose, form, weighted, max_d2, scale),
                _plain(CORNER, sharp, corner, pose, form, weighted, max_d2,
                       scale))
    return launch((flat, surf), (sharp, corner), pose, form, weighted,
                  max_d2, scale)

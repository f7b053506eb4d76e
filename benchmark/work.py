"""The yardstick's own count of what the odometry's association (K4/K5,
one `assoc_normal_equations` launch a trip) has to do, and the card's
published peaks.  It counts from each launch's inputs what the function
computes (its definition), not how a kernel computes it, so a redesign or
a fusion of the kernel reads the same work.  A copy of the counting in
`chip_smoke._k45_work`, written here in plain PyTorch.

The bound of one launch is the larger of its bytes at the HBM rate and its
operations at the float32 rate outside the tensor cores.
"""
from __future__ import annotations

import math

import torch

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s float32
# (non-tensor), both at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations a (query, reference) distance takes: 3 differences, 3
# products, 2 sums and a compare
OPS_PER_PAIR = 9
RINGS = 256           # the ring-offset table's rows, less one
OUT_WORDS = 45        # JtJ (36), Jtr (6), sum r^2, count, per set


def _wrap_pi(x):
    return x - 2.0 * math.pi * torch.floor((x + math.pi) / (2.0 * math.pi))


def _log_quat(q):
    vec = q[..., 1:4]
    mag = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    small = mag < 1e-10
    safe = torch.where(small, torch.ones_like(mag), mag)
    angle = _wrap_pi(2.0 * torch.atan2(mag, q[..., 0:1]))
    return torch.where(small, vec, vec / safe * angle)


def _deskew(xyz, rel, rn, phi):
    """Each query moved by rel·(rn, φ): exp(rel·φ) ⊗ p + rel·rn."""
    v = rel[:, None] * phi[None, :]
    theta = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    small = theta < 1e-10
    safe = torch.where(small, torch.ones_like(theta), theta)
    w = torch.where(small, torch.ones_like(theta), torch.cos(theta * 0.5))
    u = torch.where(small, torch.zeros_like(v), v / safe *
                    torch.sin(theta * 0.5))
    uv = torch.linalg.cross(u, xyz, dim=1)
    return xyz + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=1)) \
        + rel[:, None] * rn[None, :]


def set_work(kind: str, q, ref, rn, qbn, max_d2: float):
    """(bytes, operations) tensors of one set (kind "surf" or "corner"):
    pass 1 every valid query against every valid reference; pass 2 each
    query whose nearest reference lies within max_d2 against the valid
    references of the rings within ±2 of that reference's ring (less the
    nearest itself for surf, less its own ring for corner)."""
    dev = q.xyz.device
    Q, R = q.xyz.shape[0], ref.xyz.shape[0]
    nbytes = torch.tensor(Q * 17 + R * 16 + (RINGS + 1) * 4 + OUT_WORDS * 4,
                          dtype=torch.float64, device=dev)
    r_ok = ref.valid & torch.isfinite(ref.xyz).all(dim=1)
    n_q, n_r = q.valid.sum(), r_ok.sum()
    if Q == 0 or R == 0:
        return nbytes, torch.zeros((), dtype=torch.float64, device=dev)
    p0 = _deskew(q.xyz.float(), q.rel.float(), rn.float(),
                 _log_quat(qbn.float()))
    d2 = ((p0[:, None, :] - ref.xyz.float()[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(r_ok[None, :], d2, torch.inf)
    d1, i1 = d2.min(dim=1)
    near = q.valid & (d1 < max_d2)
    ring = ref.ring.long()
    gap = (ring[None, :] - ring[i1][:, None]).abs()
    window = (gap <= 2) & r_ok[None, :]
    if kind == "corner":
        window &= gap != 0
    pairs = (n_q * n_r + (window & near[:, None]).sum()
             - (near.sum() if kind == "surf" else 0))
    return nbytes, OPS_PER_PAIR * pairs.to(torch.float64)


def launch_bound_s(call) -> torch.Tensor:
    """The bound (seconds, a device scalar) of one recorded launch
    (flat, sharp, surf refs, corner refs, rn, qbn, form, max_d2)."""
    flat, sharp, surf, corner, rn, qbn, form, max_d2 = call
    pose_words = 19 if form == "ieskf" else 6
    b1, o1 = set_work("surf", flat, surf, rn, qbn, max_d2)
    b2, o2 = set_work("corner", sharp, corner, rn, qbn, max_d2)
    nbytes = b1 + b2 + pose_words * 4
    return torch.maximum(nbytes / HBM_BYTES_PER_S, (o1 + o2) / FP32_OPS_PER_S)


def assoc_bound_s(calls) -> float | None:
    """The summed bound of the recorded launches, one host read at the
    end; None when there were none."""
    launched = [c for c in calls
                if c[0].xyz.shape[0] + c[1].xyz.shape[0] > 0]
    if not launched:
        return None
    total = torch.zeros((), dtype=torch.float64,
                        device=launched[0][4].device)
    for c in launched:
        total = total + launch_bound_s(c)
    return float(total)

"""Closed-form batched 3x3 linear algebra (port of `lins_tpu/ops/lin3.py`).

The scan-to-map fits call a symmetric 3x3 eigen-decomposition (the corner
PCA, lidar_mapping_node.cpp:1394-1399) and a 3x3 solve (the surf plane fit,
:1477-1484) on every query of every Gauss-Newton trip.  These analytic
forms are elementwise tensor math: `torch.linalg.eigh` would read its
status on the host.

Degenerate inputs (repeated eigenvalues, singular systems) return finite
garbage instead of NaN; every call site masks those cases by its own
validity test (linearity ratio / plane-fit tightness).
"""
from __future__ import annotations

import math

import torch


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _det3(M):
    """Determinant of (..., 3, 3) by the triple product of its columns."""
    return torch.sum(M[..., :, 0] * _cross(M[..., :, 1], M[..., :, 2]),
                     dim=-1)


def eigh_sym3x3(A: torch.Tensor):
    """Eigenvalues (ascending) + eigenvectors of symmetric (..., 3, 3).

    Trigonometric closed form (Smith 1961) for the eigenvalues; the
    eigenvector of eigenvalue λ_i comes from Cayley-Hamilton: the columns of
    (A - λ_j I)(A - λ_k I) span the λ_i eigenspace.  Returns (w (..., 3),
    V (..., 3, 3)) with V[..., :, i] the unit eigenvector of w[..., i].
    """
    dtype, dev = A.dtype, A.device
    eps = 1e-20
    I = torch.eye(3, dtype=dtype, device=dev)

    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    Aq = A - q[..., None, None] * I
    p2 = torch.sum(Aq * Aq, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=eps))
    B = Aq / p[..., None, None]
    r = torch.clamp(_det3(B) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    w2 = q + 2.0 * p * torch.cos(phi)                        # largest
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    w1 = 3.0 * q - w2 - w0
    # isotropic case (p2 ~ 0): all eigenvalues = q
    iso = p2 < eps
    w0 = torch.where(iso, q, w0)
    w1 = torch.where(iso, q, w1)
    w2 = torch.where(iso, q, w2)
    w = torch.stack([w0, w1, w2], dim=-1)

    def eigvec(lj, lk):
        # columns of (A - lj I)(A - lk I) span the remaining eigenspace;
        # take the longest column
        M = (A - lj[..., None, None] * I) @ (A - lk[..., None, None] * I)
        n2 = torch.sum(M * M, dim=-2)                        # column norms²
        sel = torch.argmax(n2, dim=-1)
        v = torch.take_along_dim(M, sel[..., None, None], dim=-1)[..., 0]
        nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = v / torch.clamp(nrm, min=1e-12)
        # fully degenerate: fall back to e_x (callers mask these)
        return torch.where(nrm > 1e-12, v, I[:, 0])

    v0 = eigvec(w1, w2)
    v2 = eigvec(w0, w1)
    v1 = _cross(v2, v0)
    n1 = torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    v1 = torch.where(n1 > 1e-12, v1 / torch.clamp(n1, min=1e-12), v0)
    return w, torch.stack([v0, v1, v2], dim=-1)


def solve_sym3x3(A: torch.Tensor, b: torch.Tensor):
    """Solve (..., 3, 3) @ x = (..., 3) for SYMMETRIC A by the adjugate
    (Cramer): x = (x12 b0 + x20 b1 + x01 b2) / det with x_ij = c_i × c_j of
    A's columns.  Singular systems give large-but-finite results (det held
    away from 0); callers mask them by their own fit checks."""
    c0, c1, c2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    x12 = _cross(c1, c2)
    x20 = _cross(c2, c0)
    x01 = _cross(c0, c1)
    det = torch.sum(c0 * x12, dim=-1)
    det_safe = torch.where(torch.abs(det) > 1e-20, det,
                           torch.full_like(det, 1e-20))
    return (x12 * b[..., 0, None] + x20 * b[..., 1, None]
            + x01 * b[..., 2, None]) / det_safe[..., None]

"""Orientation assignment and corner rejection.

Reference semantics (assign_eig_ori + assign_orientations,
sift.c:926-1167): per keypoint, on its Gaussian pyramid level, a
Gaussian-weighted structure tensor and mean gradient over a sphere of
radius 3*sigma (sigma = 1.5 * keypoint scale, sift.c:41-42); reject if the
mean gradient is negligible (sift.c:996-999); eigendecompose; reject if an
adjacent eigenvalue magnitude ratio exceeds 0.90 (sift.c:1011-1015); R from
the two largest eigenvectors, each signed so the directional derivative
along it is positive, plus their cross product (sift.c:1017-1059); reject
if the corner score min |cos(angle(eigvec, mean grad))| is below
corner_thresh (sift.c:1091-1102).

The moments come from ops.ori_kernel; the rest is batched tensor math.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops.ori_kernel import ori_moments
from .params import DetectorParams


class OrientationResult(NamedTuple):
    R: torch.Tensor              # f32[K, 3, 3]
    accepted: torch.Tensor       # bool[K]
    # Raw stage predicates, in the reference's short-circuit order
    # (grad -> ratio -> corner, sift.c:996-1102).
    reject_grad: torch.Tensor    # bool[K]
    reject_ratio: torch.Tensor   # bool[K]
    reject_corner: torch.Tensor  # bool[K]


def eigh3x3(A: torch.Tensor):
    """Batched symmetric 3x3 eigendecomposition by 6 fixed sweeps of
    cyclic Jacobi rotations: eigenvalues ascending, eigenvectors in
    columns (the convention of LAPACK dsyevd used by eigen_Mat_rm,
    imutil.c:960-1067). Same arithmetic as sift3d_tpu/orientation.py:110
    eigh3x3."""
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    V = [[torch.full_like(A[..., 0, 0], float(i == j)) for j in range(3)]
         for i in range(3)]
    one = torch.ones_like(A[..., 0, 0])
    zero = torch.zeros_like(one)

    for _ in range(6):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            app, aqq, apq = a[p][p], a[q][q], a[p][q]
            # Rotation angle zeroing a_pq (Golub & Van Loan 8.4); the
            # already-zero case keeps c = 1, s = 0.
            safe = apq.abs() > 0.0
            tau = (aqq - app) / torch.where(safe, 2.0 * apq, one)
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tau == 0.0, one, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = torch.where(safe, t * c, zero)
            c = torch.where(safe, c, one)
            # a' = J^T a J: columns p, q, then rows p, q.
            new = [row[:] for row in a]
            for k in range(3):
                akp, akq = a[k][p], a[k][q]
                new[k][p] = c * akp - s * akq
                new[k][q] = s * akp + c * akq
            rows2 = [row[:] for row in new]
            for k in range(3):
                apk, aqk = new[p][k], new[q][k]
                rows2[p][k] = c * apk - s * aqk
                rows2[q][k] = s * apk + c * aqk
            a = rows2
            for k in range(3):
                vp, vq = V[k][p], V[k][q]
                V[k][p] = c * vp - s * vq
                V[k][q] = s * vp + c * vq

    w = torch.stack([a[0][0], a[1][1], a[2][2]], dim=-1)
    Vm = torch.stack([torch.stack(r, dim=-1) for r in V], dim=-2)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    Vm = torch.gather(Vm, -1, order[..., None, :].expand_as(Vm))
    return w, Vm


def assign_orientations(levels: torch.Tensor, lvl: torch.Tensor,
                        coords: torch.Tensor, sd: torch.Tensor,
                        units: tuple[float, float, float],
                        params: DetectorParams) -> OrientationResult:
    """Orientation of K keypoints of one octave.

    levels f32[nl, nx, ny, nz] (the octave's keypoint levels); lvl int[K]
    level index; coords int[K, 3]; sd f32[K] absolute scale."""
    fp = torch.cat([coords.to(torch.float32), sd[:, None]], dim=1)
    A, vd = ori_moments(levels, lvl, fp.contiguous(), units,
                        params.ori_sig_fctr, params.ori_rad_fctr)

    L, Q = eigh3x3(A)

    grad_sq = (vd * vd).sum(dim=-1)
    reject_grad = grad_sq < np.float32(params.ori_grad_thresh)

    # Ratio test (sift.c:1011-1015): C computes fabs(l_i / l_{i+1}); inf
    # compares > thresh (reject), NaN compares false (keep).
    thr = np.float32(params.max_eig_ratio)

    def gt(r):
        return torch.where(torch.isnan(r), False, r > thr)
    reject_ratio = (gt((L[:, 0] / L[:, 1]).abs())
                    | gt((L[:, 1] / L[:, 2]).abs()))

    # Sign fixing + corner score (sift.c:1017-1059).
    v2, v1 = Q[:, :, 2], Q[:, :, 1]
    d2 = (vd * v2).sum(dim=-1)
    d1 = (vd * v1).sum(dim=-1)
    gnorm = torch.sqrt(grad_sq)
    cos2 = d2 / (torch.linalg.vector_norm(v2, dim=-1) * gnorm)
    cos1 = d1 / (torch.linalg.vector_norm(v1, dim=-1) * gnorm)
    corner = torch.minimum(cos2.abs(), cos1.abs())
    r0 = v2 * torch.where(d2 > 0.0, 1.0, -1.0)[:, None]
    r1 = v1 * torch.where(d1 > 0.0, 1.0, -1.0)[:, None]
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    R = torch.stack([r0, r1, r2], dim=-1)
    reject_corner = corner < np.float32(params.corner_thresh)

    accepted = ~reject_grad & ~reject_ratio & ~reject_corner
    return OrientationResult(R, accepted, reject_grad, reject_ratio,
                             reject_corner)

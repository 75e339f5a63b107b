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

All of it runs in ops.ori_kernel: one kernel launch per octave on the
card, the plain PyTorch version on the CPU. Centers may be fractional
(subvoxel refinement) and scales per keypoint, as in
sift3d_tpu/orientation.py:176-216.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops.ori_kernel import eigh3x3_plain as eigh3x3  # noqa: F401
from .ops.ori_kernel import Orientation, orient
from .params import DetectorParams


class OrientationResult(NamedTuple):
    R: torch.Tensor              # f32[K, 3, 3]
    # accepted and the raw stage predicates (grad -> ratio -> corner,
    # sift.c:996-1102), as ops.ori_kernel.Orientation holds them.
    flags: torch.Tensor          # bool[K, 4]

    accepted = Orientation.accepted
    reject_grad = Orientation.reject_grad
    reject_ratio = Orientation.reject_ratio
    reject_corner = Orientation.reject_corner


def assign_orientations(levels: torch.Tensor, lvl: torch.Tensor,
                        coords: torch.Tensor, sd: torch.Tensor,
                        units: tuple[float, float, float],
                        params: DetectorParams, *,
                        centers: torch.Tensor | None = None,
                        sd_max: float | None = None,
                        fractional: bool = False, z_origin: int = 0,
                        global_nz: int | None = None) -> OrientationResult:
    """Orientation of K keypoints of one octave.

    levels f32[nl, nx, ny, nz] (the octave's keypoint levels); lvl i64[K]
    level index; coords i64[K, 3] integer anchors; sd f32[K] absolute
    scale, at most sd_max (default: its max); centers f32[K, 3] the window
    centers (default: coords), within a voxel of coords when fractional.
    levels may be a z-slab whose row 0 is global z z_origin of a volume
    global_nz deep."""
    o = orient(levels, lvl, coords, sd, units, params, centers=centers,
               sd_max=sd_max, fractional=fractional, z_origin=z_origin,
               global_nz=global_nz)
    return OrientationResult(o.R, o.flags)

"""DoG extrema detection.

Reference semantics (detect_extrema, sift.c:735-871): for each DoG level
triple the level's own max |DoG| scales the relative peak threshold
(sift.c:821-829); an interior voxel is a candidate iff |value| clears the
threshold and the value is strictly above (or below) every compared
neighbor (see ops/extrema_kernel.py). Candidates carry integer voxel
coordinates at octave resolution and strength |DoG| (sift.c:851-864), in
the reference's scan order: level, then z, y, x (PYR_LOOP with s inner,
sift.c:814; SIFT3D_IM_LOOP_LIMITED_START, immacros.h:78-82).

Shapes are dynamic here: the mask is compacted with ``nonzero`` and a sort
on the (level, z, y, x) key, with no fixed candidate capacity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops.extrema_kernel import extrema_mask
from .params import DetectorParams


class OctaveCandidates(NamedTuple):
    """All extrema candidates of one octave, in (level, z, y, x) order."""
    coords: torch.Tensor     # i64[N, 3] voxel coords at octave resolution
    level: torch.Tensor      # i64[N] keypoint level index li (raw s = li)
    strength: torch.Tensor   # f32[N] |DoG|
    counts: torch.Tensor     # i64[num_kp_levels] candidates per level


def detect_extrema_octave(dog_oct: torch.Tensor, dogmax: torch.Tensor,
                          params: DetectorParams) -> OctaveCandidates:
    """Extrema of every keypoint level of one octave.

    dog_oct f32[num_dog_levels, nx, ny, nz]; dogmax f32[num_dog_levels]
    the per-level max |DoG| (from the pyramid builder)."""
    Ld, nx, ny, nz = dog_oct.shape
    nl = Ld - 2
    thr = torch.tensor(params.peak_thresh, dtype=torch.float32,
                       device=dog_oct.device) * dogmax[1:Ld - 1]
    mask = extrema_mask(dog_oct, thr.contiguous(), params.cuboid_extrema)
    counts = mask.reshape(nl, -1).sum(dim=1)
    lvl, xx, yy, zz = torch.nonzero(mask, as_tuple=True)
    key = ((lvl * nz + zz) * ny + yy) * nx + xx
    order = torch.argsort(key)
    lvl, xx, yy, zz = lvl[order], xx[order], yy[order], zz[order]
    strength = dog_oct[1 + lvl, xx, yy, zz].abs()
    return OctaveCandidates(torch.stack([xx, yy, zz], dim=-1), lvl,
                            strength, counts)

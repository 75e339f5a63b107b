"""DoG extrema detection.

Reference semantics (detect_extrema, sift.c:735-871): for each DoG level
triple the level's own max |DoG| scales the relative peak threshold
(sift.c:821-829); an interior voxel is a candidate iff |value| clears the
threshold and the value is strictly above (or below) every compared
neighbor (see ops/extrema_kernel.py). Candidates carry integer voxel
coordinates at octave resolution and strength |DoG| (sift.c:851-864), in
the reference's scan order: level, then z, y, x (PYR_LOOP with s inner,
sift.c:814; SIFT3D_IM_LOOP_LIMITED_START, immacros.h:78-82).

Shapes are dynamic here: the stencil gives every candidate's (level, z, y,
x) key (ops.extrema_kernel), and a sort on the key puts them in scan
order. A batch of volumes' octaves goes through one stencil launch and one
count read; the key's most significant part is the volume, so the sorted
candidates are volume-major, each volume's in its scan order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops.extrema_kernel import extrema_candidates
from .params import DetectorParams


class OctaveCandidates(NamedTuple):
    """All extrema candidates of one octave, in (level, z, y, x) order; of
    a batch, volume by volume, each in that order."""
    coords: torch.Tensor     # i64[N, 3] voxel coords at octave resolution
    level: torch.Tensor      # i64[N] keypoint level index li (raw s = li)
    strength: torch.Tensor   # f32[N] |DoG|
    counts: torch.Tensor     # i64[num_kp_levels] (batch: [B, nl]) per level
    batch: torch.Tensor | None = None   # i64[N] volume of each (batch only)


def detect_extrema_octave(dog_oct: torch.Tensor, dogmax: torch.Tensor,
                          params: DetectorParams, z_origin: int = 0,
                          global_nz: int | None = None,
                          z_rows=None) -> OctaveCandidates:
    """Extrema of every keypoint level of one octave.

    dog_oct f32[num_dog_levels, nx, ny, nz]; dogmax f32[num_dog_levels]
    the per-level max |DoG| (from the pyramid builder). A batch, dog_oct
    f32[B, num_dog_levels, nx, ny, nz] and dogmax f32[B, num_dog_levels],
    gives every volume's candidates and each one's volume in `batch`.
    A z-slab of a volume global_nz deep (a shard's rows z_rows = [lo, hi)
    of the slab, with their halo; slab row 0 at global z z_origin; dogmax
    the whole volume's) gives the candidates of those rows, in global
    coordinates and in the volume's order."""
    *lead, Ld, nx, ny, nz = dog_oct.shape
    gnz = nz if global_nz is None else int(global_nz)
    # A Python scalar: multiplied in f32 on either device (the scalar
    # rounded to f32 first), with nothing to upload.
    thr = dogmax[..., 1:Ld - 1] * params.peak_thresh
    keys, counts = extrema_candidates(dog_oct, thr.contiguous(),
                                      params.cuboid_extrema,
                                      z_origin=z_origin, global_nz=global_nz,
                                      z_rows=z_rows)
    keys = torch.sort(keys).values
    xx, r = keys % nx, keys // nx
    yy, r = r % ny, r // ny
    zz, lvl = r % gnz, r // gnz
    coords = torch.stack([xx, yy, zz], dim=-1)
    zs = zz - z_origin if z_origin else zz     # the slab row
    if not lead:
        strength = dog_oct[1 + lvl, xx, yy, zs].abs()
        return OctaveCandidates(coords, lvl, strength, counts)
    nl = Ld - 2
    b, lvl = lvl // nl, lvl % nl
    strength = dog_oct[b, 1 + lvl, xx, yy, zs].abs()
    return OctaveCandidates(coords, lvl, strength, counts, b)

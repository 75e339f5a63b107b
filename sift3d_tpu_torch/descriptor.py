"""Icosahedral gradient-orientation-histogram descriptors.

Reference semantics (extract_descrip and helpers, sift.c:1295-1536): per
keypoint, on its Gaussian pyramid level, a sphere of radius
2 * (7.0711 * sd) in real-world units; each voxel offset is rotated into
the keypoint frame by R^T; 4x4x4 spatial bins cover the cube inscribed in
the sphere and voxels outside it are rejected (sift.c:1483-1492); the
Gaussian-weighted gradient, rotated by R^T, adds its magnitude to a
[64 x 12] histogram by trilinear spatial x barycentric icosahedral
interpolation (sift.c:1340-1397). Then L2-normalize, truncate at
0.2*128/768 and renormalize (sift.c:1508-1526); coordinates are scaled to
base-octave voxels (sift.c:1528-1533).

The window prep (gradients, loop-bound / sphere / bin masks, R^T
rotation, Gaussian weight) and the histogram run in ops.desc_kernel: one
kernel launch per octave on the card, where the prep never reaches device
memory; on the CPU the plain version, the prep as batched tensor math (as
the TPU package kept it in XLA, sift3d_tpu/descriptor.py:216
_prep_window) and then the histogram contraction.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.desc_kernel import desc_fused
from .params import DESC_NUMEL, DetectorParams


def _row_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum of each row of a [K, 768] as a fixed tree of elementwise adds
    (halves down to 3 columns, then left to right): the same bits for a
    row whatever K, the device or the launch configuration, so that a
    keypoint's descriptor does not depend on the batch or shard it is
    extracted in (torch's reductions pick their order by shape)."""
    while a.shape[-1] % 2 == 0:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    out = a[..., 0]
    for j in range(1, a.shape[-1]):
        out = out + a[..., j]
    return out[..., None]


def normalize(hist: torch.Tensor, params: DetectorParams) -> torch.Tensor:
    """L2-normalize, truncate, renormalize each row of hist [K, D]
    (sift.c:1402-1429, 1508-1526)."""
    def norm1(h):
        nrm = torch.sqrt(_row_sum(h * h)) \
            + float(np.float32(2.220446049250313e-16))
        return h * (1.0 / nrm)
    h = norm1(hist)
    h = torch.clamp(h, max=float(np.float32(params.trunc_thresh)))
    return norm1(h)


def octave_histograms(levels: torch.Tensor, lvl: torch.Tensor,
                      centers: torch.Tensor, R: torch.Tensor,
                      sd: torch.Tensor, octave: int, units,
                      params: DetectorParams, sd_max: float,
                      fractional: bool = False, z_origin: int = 0,
                      global_nz: int | None = None):
    """Descriptor histograms of K keypoints of one octave, before
    normalize (which the callers run once for several octaves or shards:
    its row sums are per row).

    levels f32[nl, nx, ny, nz]; lvl i64[K] level index; centers f32[K, 3]
    (integer-valued, or fractional after subvoxel refinement); R f32[K, 3,
    3]; sd f32[K], each <= sd_max. levels may be a z-slab whose row 0 is
    global z z_origin of a volume global_nz deep.
    Returns (hist f32[K, 768], xyz f32[K, 3] base-octave coordinates)."""
    K = centers.shape[0]
    hist = desc_fused(levels, lvl, centers, R, sd, units, params, sd_max,
                      fractional, z_origin, global_nz)
    # [(cz, cy), (cx, v)] -> flat hist index x + 4y + 16z, vertex minor
    # (DESC_MAT_GET_COL, sift.c:136-137): the row-major order already.
    return hist.reshape(K, DESC_NUMEL), centers * float(2.0 ** octave)

"""Keypoint windows: extents, placement and batched gathers.

The reference iterates a sphere in real-world units around each keypoint
(IM_LOOP_SPHERE_START, sift.c:86-109), with per-axis voxel loop bounds
[max(floor(c - rad/u), 1), min(ceil(c + rad/u), n - 2)]. A cube of
``window_extent`` voxels per axis, placed by the clip rule of
``window_starts``, holds that loop range plus the 1-voxel gradient border
(it shifts near the volume edges instead of shrinking).

A z-slab of a larger volume (a shard's rows with their halo) is read
through ``z_view = (z_origin, global_nz)``: slab row 0 sits at global z
``z_origin``, windows are placed against the global depth, and
coordinates and origins stay global (sift3d_tpu/windows.py:27-64).
"""

from __future__ import annotations

import math

import torch


def window_extent(radius_vox: float, n: int, margin: int = 0) -> int:
    """Window size along one axis: diameter + 1-voxel gradient border
    (+ margin), clipped to the level size."""
    return min(2 * math.ceil(radius_vox) + 3 + margin, n)


def window_starts(coords: torch.Tensor, extents, dims) -> torch.Tensor:
    """i64[K, 3] window origins: centered on coords as far as the level
    allows (``clip(c - (G-1)//2, 0, n - G)`` per axis)."""
    cols = [torch.clamp(coords[:, a] - (extents[a] - 1) // 2, 0,
                        dims[a] - extents[a]) for a in range(3)]
    return torch.stack(cols, dim=1)


def gather_windows(levels: torch.Tensor, lvl: torch.Tensor,
                   coords: torch.Tensor, extents, z_view=None):
    """Windows f32[K, Gx, Gy, Gz] of levels[lvl[k]] around coords[k], and
    their (global) origins i64[K, 3]; z_view = (z_origin, global_nz) for a
    z-slab, which must hold every window (ValueError)."""
    z0, dims = 0, tuple(levels.shape[1:])
    if z_view is not None:
        z0, dims = int(z_view[0]), dims[:2] + (int(z_view[1]),)
    start = window_starts(coords, extents, dims)
    slab = z0 != 0 or dims[2] != levels.shape[3]
    if slab and len(start) and (
            int(start[:, 2].min()) < z0 or int(start[:, 2].max())
            + extents[2] > z0 + levels.shape[3]):
        raise ValueError(f"a window leaves the z-slab (rows {z0}.."
                         f"{z0 + levels.shape[3] - 1})")
    dev = levels.device
    ix, iy, iz = (start[:, a, None] - (z0 if a == 2 else 0)
                  + torch.arange(extents[a], device=dev) for a in range(3))
    win = levels[lvl[:, None, None, None], ix[:, :, None, None],
                 iy[:, None, :, None], iz[:, None, None, :]]
    return win, start

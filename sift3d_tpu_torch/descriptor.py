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

The per-keypoint window prep (gradients, loop-bound / sphere / bin masks,
R^T rotation, Gaussian weight) is batched tensor math, as the TPU package
kept it in XLA (sift3d_tpu/descriptor.py:216 _prep_window); the histogram
comes from ops.desc_kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops.desc_kernel import desc_hist
from .params import DESC_NUMEL, ICOS_NVERT, NHIST_PER_DIM, DetectorParams
from .windows import gather_windows, window_extent

_SQRT2 = math.sqrt(2.0)
# Keypoints per prep batch: bounds the prep's transient memory to about
# this many window voxels (~80 bytes each).
_PREP_VOXELS = 12_000_000


def level_radius(sd: float, params: DetectorParams) -> float:
    """Descriptor window radius at scale sd, in f32 as the C code."""
    sigma = np.float32(np.float32(sd) * np.float32(params.desc_sig_fctr))
    return float(np.float32(params.desc_rad_fctr) * sigma)


def prep_windows(levels: torch.Tensor, lvl: torch.Tensor,
                 coords: torch.Tensor, centers: torch.Tensor,
                 R: torch.Tensor, sd: torch.Tensor, units, extents,
                 params: DetectorParams):
    """(grot, vbins) f32[K, 3, N] for the histogram kernel, N the window
    interior's voxel count; masked voxels get a zero gradient."""
    nb = NHIST_PER_DIM
    K = coords.shape[0]
    dev = levels.device
    n = levels.shape[1:]
    sigma = sd * float(np.float32(params.desc_sig_fctr))
    win_radius = sigma * float(np.float32(params.desc_rad_fctr))
    half_width = win_radius / float(np.float32(_SQRT2))
    bin_fctr = 1.0 / (2.0 * half_width / float(nb))

    win, start = gather_windows(levels, lvl, coords, extents)
    u = [float(np.float32(x)) for x in units]
    inv = [float(np.float32(1.0) / np.float32(x)) for x in units]
    g3 = (0.5 * (win[:, 2:, 1:-1, 1:-1] - win[:, :-2, 1:-1, 1:-1]) * inv[0],
          0.5 * (win[:, 1:-1, 2:, 1:-1] - win[:, 1:-1, :-2, 1:-1]) * inv[1],
          0.5 * (win[:, 1:-1, 1:-1, 2:] - win[:, 1:-1, 1:-1, :-2]) * inv[2])
    ishape = tuple(e - 2 for e in extents)

    def col(t):   # [K] -> broadcastable [K, 1, 1, 1]
        return t.reshape(K, 1, 1, 1)

    mask = torch.ones((K,) + ishape, dtype=torch.bool, device=dev)
    d3 = []
    for a in range(3):
        shape = [K, 1, 1, 1]
        shape[1 + a] = ishape[a]
        idx = (start[:, a, None] + 1
               + torch.arange(ishape[a], device=dev)).reshape(shape)
        c = centers[:, a]
        lo = torch.clamp(torch.floor(c - win_radius / u[a]), min=1.0)
        hi = torch.clamp(torch.ceil(c + win_radius / u[a]),
                         max=float(n[a] - 2))
        mask &= (idx >= col(lo.long())) & (idx <= col(hi.long()))
        d3.append((idx.float() - col(c)) * u[a])
    sq = d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2]
    mask &= sq <= col(win_radius * win_radius)

    # vkp = R^T vim, one output component at a time.
    vbins = []
    for j in range(3):
        vkp = (d3[0] * col(R[:, 0, j]) + d3[1] * col(R[:, 1, j])
               + d3[2] * col(R[:, 2, j]))
        vb = (vkp + col(half_width)) * col(bin_fctr)
        mask &= (vb >= 0.0) & (vb < float(nb))
        vbins.append(vb.reshape(K, -1))
    s = col(sigma)
    w = torch.where(mask, torch.exp(-0.5 * sq / (s * s)), 0.0)
    wg = [w * g for g in g3]
    grot = [(wg[0] * col(R[:, 0, j]) + wg[1] * col(R[:, 1, j])
             + wg[2] * col(R[:, 2, j])).reshape(K, -1) for j in range(3)]
    return torch.stack(grot, dim=1), torch.stack(vbins, dim=1)


def normalize(hist: torch.Tensor, params: DetectorParams) -> torch.Tensor:
    """L2-normalize, truncate, renormalize each row of hist [K, D]
    (sift.c:1402-1429, 1508-1526)."""
    def norm1(h):
        nrm = torch.sqrt((h * h).sum(dim=-1, keepdim=True)) \
            + float(np.float32(2.220446049250313e-16))
        return h * (1.0 / nrm)
    h = norm1(hist)
    h = torch.clamp(h, max=float(np.float32(params.trunc_thresh)))
    return norm1(h)


def extract_descriptors(levels: torch.Tensor, lvl: torch.Tensor,
                        centers: torch.Tensor, R: torch.Tensor,
                        sd: torch.Tensor, octave: int, units,
                        params: DetectorParams, sd_max: float):
    """Descriptors of K keypoints of one octave.

    levels f32[nl, nx, ny, nz]; lvl int[K] level index; centers f32[K, 3]
    (integer-valued); R f32[K, 3, 3]; sd f32[K]; sd_max sizes the windows.
    Returns (desc f32[K, 768], xyz f32[K, 3] base-octave coordinates)."""
    K = centers.shape[0]
    dims = levels.shape[1:]
    rad = level_radius(sd_max, params)
    extents = tuple(window_extent(rad / units[a], dims[a])
                    for a in range(3))
    coords = centers.round().long()
    nvox = int(np.prod([e - 2 for e in extents]))
    step = max(1, _PREP_VOXELS // nvox)
    hists = []
    for s in range(0, K, step):
        sl = slice(s, s + step)
        grot, vbins = prep_windows(levels, lvl[sl], coords[sl], centers[sl],
                                   R[sl], sd[sl], units, extents, params)
        hists.append(desc_hist(grot, vbins, params.bary_eps))
    nb = NHIST_PER_DIM
    hist = (torch.cat(hists) if hists else
            torch.zeros((0, nb * nb, nb * ICOS_NVERT), device=levels.device))
    # [(cz, cy), (cx, v)] -> flat hist index x + 4y + 16z, vertex minor
    # (DESC_MAT_GET_COL, sift.c:136-137): the row-major order already.
    desc = normalize(hist.reshape(K, DESC_NUMEL), params)
    xyz = centers * float(2.0 ** octave)
    return desc, xyz

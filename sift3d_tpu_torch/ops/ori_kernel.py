"""Orientation window moments.

Replaces the TPU kernel ``sift3d_tpu/ops/ori_kernel.py:167
ori_moments_pallas``. Per keypoint k, on pyramid level lvl[k] and around
center (cx, cy, cz) with scale sd (fp[k] = (cx, cy, cz, sd)): central-
difference gradients times 1/units (IM_GET_GRAD_ISO, sift.c:140-145), the
reference's loop bounds [max(floor(c - rad/u), 1), min(ceil(c + rad/u),
n-2)] computed in f32 and the sphere |d| <= rad (IM_LOOP_SPHERE_START,
sift.c:86-109), with sigma = ori_sig_fctr * sd, rad = ori_rad_fctr *
sigma, and the weight exp(-r^2 / (2 sigma^2)). Outputs the structure
tensor A = sum w g g^T f32[K, 3, 3] and vd = sum w g f32[K, 3]
(assign_eig_ori, sift.c:963-989).

CUDA kernel (csrc/ori.cu, ``s3d_ori_moments``): one block per keypoint;
its threads stride over the voxels of the loop-bound box, read the level
in place (no window is gathered into memory) and accumulate the 9 moment
sums in f32 registers, then a warp-shuffle + shared-memory block
reduction. One launch covers a whole octave (the level index is per
keypoint).

Bound on the H100: latency — a few hundred keypoints of ~10^4 voxels each
is a small, gather-like read; a block per keypoint gives every SM work at
256^3 densities. The sums run in another order than the plain version
(tolerance: rel 1e-5).

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..windows import gather_windows, window_extent
from . import _build

launches = 0   # kernel launches on CUDA tensors (chip_smoke.py reads it)


def _moments_chunk(levels, lvl, fp, units, sig_fctr, rad_fctr, extents):
    n = levels.shape[1:]
    center, sd = fp[:, :3], fp[:, 3]
    win, start = gather_windows(levels, lvl, center.round().long(), extents)
    K = fp.shape[0]
    sigma = sd * np.float32(sig_fctr)
    rad = sigma * np.float32(rad_fctr)
    u = [np.float32(x) for x in units]
    inv = [np.float32(1.0) / x for x in u]
    gx = 0.5 * (win[:, 2:, 1:-1, 1:-1] - win[:, :-2, 1:-1, 1:-1]) * inv[0]
    gy = 0.5 * (win[:, 1:-1, 2:, 1:-1] - win[:, 1:-1, :-2, 1:-1]) * inv[1]
    gz = 0.5 * (win[:, 1:-1, 1:-1, 2:] - win[:, 1:-1, 1:-1, :-2]) * inv[2]

    mask = torch.ones(gx.shape, dtype=torch.bool, device=levels.device)
    sq = torch.zeros(gx.shape, dtype=torch.float32, device=levels.device)
    for a in range(3):
        shape = [K, 1, 1, 1]
        shape[1 + a] = extents[a] - 2
        idx = (start[:, a, None] + 1
               + torch.arange(extents[a] - 2, device=levels.device))
        idx = idx.reshape(shape)
        c = center[:, a]
        lo = torch.clamp(torch.floor(c - rad / u[a]), min=1.0)
        hi = torch.clamp(torch.ceil(c + rad / u[a]), max=float(n[a] - 2))
        mask &= ((idx >= lo.long().reshape(K, 1, 1, 1))
                 & (idx <= hi.long().reshape(K, 1, 1, 1)))
        d = (idx.float() - c.reshape(K, 1, 1, 1)) * u[a]
        sq = sq + d * d
    r = rad.reshape(K, 1, 1, 1)
    s = sigma.reshape(K, 1, 1, 1)
    mask &= sq <= r * r
    w = torch.where(mask, torch.exp(-0.5 * sq / (s * s)), 0.0)
    g = torch.stack([gx, gy, gz], dim=-1).reshape(K, -1, 3)
    wg = w.reshape(K, -1, 1) * g
    return torch.einsum("kvi,kvj->kij", wg, g), wg.sum(dim=1)


def ori_moments_plain(levels: torch.Tensor, lvl: torch.Tensor,
                      fp: torch.Tensor, units, sig_fctr: float,
                      rad_fctr: float, chunk: int = 256):
    """Plain version: gathered windows and masked sums, as
    sift3d_tpu/orientation.py:48 _window_moments."""
    n = levels.shape[1:]
    rad_max = sig_fctr * float(fp[:, 3].max()) * rad_fctr
    extents = tuple(window_extent(rad_max / units[a], n[a])
                    for a in range(3))
    parts = [_moments_chunk(levels, lvl[s:s + chunk], fp[s:s + chunk],
                            units, sig_fctr, rad_fctr, extents)
             for s in range(0, fp.shape[0], chunk)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def ori_moments(levels: torch.Tensor, lvl: torch.Tensor, fp: torch.Tensor,
                units, sig_fctr: float, rad_fctr: float):
    """Window moments (A f32[K, 3, 3], vd f32[K, 3]) of K keypoints.

    levels f32[L, nx, ny, nz]; lvl int[K] level per keypoint;
    fp f32[K, 4] = (cx, cy, cz, sd) with integer-valued centers."""
    global launches
    K = fp.shape[0]
    if levels.device.type == "cpu":
        return ori_moments_plain(levels, lvl, fp, units, sig_fctr, rad_fctr)
    L, nx, ny, nz = levels.shape
    lvl = lvl.to(torch.int32).contiguous()
    _build.check_cuda("ori_moments levels", levels, torch.float32)
    _build.check_cuda("ori_moments lvl", lvl, torch.int32, (K,))
    _build.check_cuda("ori_moments fp", fp, torch.float32, (K, 4))
    out = torch.empty((K, 12), dtype=torch.float32, device=levels.device)
    if K == 0:
        return out[:, :9].reshape(0, 3, 3), out[:, 9:]
    u = [np.float32(x) for x in units]
    inv = [np.float32(1.0) / x for x in u]
    _build.call("s3d_ori_moments", levels.data_ptr(), lvl.data_ptr(),
                fp.data_ptr(), out.data_ptr(), K, nx, ny, nz,
                *(float(x) for x in u), *(float(x) for x in inv),
                float(np.float32(sig_fctr)), float(np.float32(rad_fctr)),
                _build.stream_ptr(levels))
    launches += 1
    return out[:, :9].reshape(K, 3, 3), out[:, 9:].contiguous()

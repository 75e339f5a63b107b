"""DoG extrema stencil mask.

Replaces the TPU kernel
``sift3d_tpu/ops/extrema_kernel.py:384 extrema_mask_pallas``. For one
octave's DoG stack dog f32[nl + 2, nx, ny, nz] and per-level thresholds
thr f32[nl], it writes mask int8[nl, nx, ny, nz]: voxel (x, y, z) of
keypoint level l (DoG level l + 1) is set when it lies in the interior
[1, n-2]^3, |DoG| > thr[l] (as ``v > thr or v < -thr``), and the value is
strictly greater, or strictly less, than every compared neighbor
(detect_extrema, sift.c:735-871): the 6 face neighbors plus the centers of
DoG levels l and l + 2 (sift.c:797-810), or the full 3x3x3 cube in all
three levels under ``cuboid`` (80 neighbors, sift.c:761-796). The border is
zero.

CUDA kernel (csrc/extrema.cu, ``s3d_extrema_mask``): one thread per voxel
of [nl, nx, ny, nz], neighbors read straight from device memory.

Bound on the H100: device-memory bandwidth — three DoG levels read per
keypoint level (neighbors hit L1/L2) and one byte written per voxel. The
compaction (nonzero + key sort) stays in torch, as it stayed in XLA on
the TPU; fusing it into the stencil with a warp ballot and an atomic
counter is later work.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0   # kernel launches on CUDA tensors (chip_smoke.py reads it)

_FACE_OFFSETS = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                 (0, 0, -1), (0, 0, 1)]
_CUBE_OFFSETS = [(dx, dy, dz)
                 for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def extrema_mask_plain(dog: torch.Tensor, thr: torch.Tensor,
                       cuboid: bool = False) -> torch.Tensor:
    """Plain version: shifted-slice comparisons over the interior (the
    stencil of sift3d_tpu/detect.py:207-234)."""
    Ld, nx, ny, nz = dog.shape
    nl = Ld - 2

    def sh(a, dx, dy, dz):
        return a[:, 1 + dx: nx - 1 + dx, 1 + dy: ny - 1 + dy,
                 1 + dz: nz - 1 + dz]

    cur, prev, nxt = dog[1:Ld - 1], dog[0:Ld - 2], dog[2:Ld]
    pcur = sh(cur, 0, 0, 0)
    if cuboid:
        nbrs = ([sh(cur, *o) for o in _CUBE_OFFSETS if o != (0, 0, 0)]
                + [sh(prev, *o) for o in _CUBE_OFFSETS]
                + [sh(nxt, *o) for o in _CUBE_OFFSETS])
    else:
        nbrs = ([sh(cur, *o) for o in _FACE_OFFSETS]
                + [sh(prev, 0, 0, 0), sh(nxt, 0, 0, 0)])
    is_max = torch.ones_like(pcur, dtype=torch.bool)
    is_min = torch.ones_like(pcur, dtype=torch.bool)
    for nb in nbrs:
        is_max &= pcur > nb
        is_min &= pcur < nb
    peak = thr.reshape(nl, 1, 1, 1)
    inner = ((pcur > peak) | (pcur < -peak)) & (is_max | is_min)
    mask = torch.zeros((nl, nx, ny, nz), dtype=torch.int8, device=dog.device)
    mask[:, 1:nx - 1, 1:ny - 1, 1:nz - 1] = inner.to(torch.int8)
    return mask


def extrema_mask(dog: torch.Tensor, thr: torch.Tensor,
                 cuboid: bool = False) -> torch.Tensor:
    """Candidate mask int8[nl, nx, ny, nz] of one octave's DoG stack."""
    global launches
    if dog.device.type == "cpu":
        return extrema_mask_plain(dog, thr, cuboid)
    Ld, nx, ny, nz = dog.shape
    nl = Ld - 2
    _build.check_cuda("extrema_mask dog", dog, torch.float32)
    _build.check_cuda("extrema_mask thr", thr, torch.float32, (nl,))
    if min(nx, ny, nz) < 3 or nl < 1:
        raise ValueError(f"extrema_mask: DoG stack too small {dog.shape}")
    mask = torch.empty((nl, nx, ny, nz), dtype=torch.int8,
                       device=dog.device)
    _build.call("s3d_extrema_mask", dog.data_ptr(), thr.data_ptr(),
                mask.data_ptr(), nl, nx, ny, nz, int(cuboid),
                _build.stream_ptr(dog))
    launches += 1
    return mask

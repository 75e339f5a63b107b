"""DoG extrema stencil with the candidates compacted inside the kernel.

Replaces the TPU kernel
``sift3d_tpu/ops/extrema_kernel.py:384 extrema_mask_pallas`` and the XLA
compaction after it. For one octave's DoG stack dog f32[nl + 2, nx, ny,
nz] and per-level thresholds thr f32[nl], voxel (x, y, z) of keypoint
level l (DoG level l + 1) is a candidate when it lies in the interior
[1, n-2]^3, |DoG| > thr[l] (as ``v > thr or v < -thr``), and the value is
strictly greater, or strictly less, than every compared neighbor
(detect_extrema, sift.c:735-871): the 6 face neighbors plus the centers of
DoG levels l and l + 2 (sift.c:797-810), or the full 3x3x3 cube in all
three levels under ``cuboid`` (80 neighbors, sift.c:761-796).

``extrema_candidates`` gives each candidate's key
``((l * nz + z) * ny + y) * nx + x`` (the reference's scan order: level,
then z, y, x) in no particular order, and the count per level. A batch of
B stacks dog f32[B, nl + 2, nx, ny, nz] with thresholds thr f32[B, nl]
adds the volume as the key's most significant part,
``(((b * nl + l) * nz + z) * ny + y) * nx + x`` (sorted keys are
volume-major, each volume in its own scan order), and counts i64[B, nl].

CUDA kernel (csrc/extrema.cu, ``s3d_extrema_candidates``): one launch per
octave, for the whole batch, over chunks of the (y, z) planes of every
keypoint level of every volume. A thread reads its voxels' own values,
coalesced, and the neighbors only where the threshold passes (a few
percent of the voxels); a warp ballot and one
atomicAdd per warp write the keys into a buffer of fixed capacity. No mask
reaches device memory. The wrapper reads the count (the octave's one host
sync, for the whole batch) and, if it exceeds the capacity, launches the
kernel once more with the exact capacity.

Bound on the H100: device-memory bandwidth, reading the keypoint levels'
DoG once (the outer DoG levels only at the voxels that pass the
threshold).

A z-slab of a deeper volume (a shard's rows with a one-voxel z halo, as
sift3d_tpu/parallel/spatial.py:160-248 runs the TPU kernel) takes
``z_origin`` (the global z of slab row 0), ``global_nz`` (the volume's
depth) and ``z_rows`` (the slab rows to test, the shard's own): the
interior bound on z is global, [1, global_nz - 2], and the keys carry the
global z and depth, so the shards' sorted keys are the whole volume's.
The defaults are the whole volume.

On a CPU tensor the wrapper runs the plain PyTorch version (the mask,
``nonzero`` and the keys); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _build

_FACE_OFFSETS = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                 (0, 0, -1), (0, 0, 1)]
_CUBE_OFFSETS = [(dx, dy, dz)
                 for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def z_test_rows(nz: int, z_origin: int = 0, global_nz: int | None = None,
                z_rows=None) -> tuple[int, int]:
    """(zmin, zmax): the slab rows a stencil tests, inside the slab's
    interior [1, nz - 2], the global interior [1, global_nz - 2] and
    z_rows = [lo, hi) (default all); empty when zmin > zmax."""
    gnz = nz if global_nz is None else int(global_nz)
    lo, hi = (0, nz) if z_rows is None else z_rows
    return (max(1, int(lo), 1 - z_origin),
            min(nz - 2, int(hi) - 1, gnz - 2 - z_origin))


def extrema_mask_plain(dog: torch.Tensor, thr: torch.Tensor,
                       cuboid: bool = False, zmin: int = 1,
                       zmax: int | None = None) -> torch.Tensor:
    """Candidate mask int8[nl, nx, ny, nz] by shifted-slice comparisons
    over the interior (the stencil of sift3d_tpu/detect.py:207-234); the
    border, and the slab rows outside [zmin, zmax], are zero."""
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
    mask[..., :zmin] = 0
    if zmax is not None:
        mask[..., zmax + 1:] = 0
    return mask


def extrema_candidates_plain(dog: torch.Tensor, thr: torch.Tensor,
                             cuboid: bool = False, z_origin: int = 0,
                             global_nz: int | None = None, z_rows=None):
    """Plain version: (keys i64[N], counts i64[nl]) from the mask by
    ``nonzero``; for a batch (dog [B, nl + 2, ...], thr [B, nl]) the
    per-volume plain version in a loop over b, keys offset by b, counts
    i64[B, nl]."""
    if dog.ndim == 5:
        parts = [extrema_candidates_plain(d, t, cuboid, z_origin, global_nz,
                                          z_rows)
                 for d, t in zip(dog, thr)]
        gnz = dog.shape[-1] if global_nz is None else int(global_nz)
        per = (dog.shape[1] - 2) * dog.shape[2] * dog.shape[3] * gnz
        return (torch.cat([k + b * per for b, (k, _) in enumerate(parts)]),
                torch.stack([c for _, c in parts]))
    _, nx, ny, nz = dog.shape
    gnz = nz if global_nz is None else int(global_nz)
    zmin, zmax = z_test_rows(nz, z_origin, global_nz, z_rows)
    mask = extrema_mask_plain(dog, thr, cuboid, zmin, zmax)
    counts = mask.reshape(mask.shape[0], -1).sum(dim=1)
    lvl, xx, yy, zz = torch.nonzero(mask, as_tuple=True)
    return ((lvl * gnz + zz + z_origin) * ny + yy) * nx + xx, counts


def default_capacity(shape) -> int:
    """Key slots of the first launch: 1 in 1024 voxels of the keypoint
    levels, at least 4096 (a 256^3 octave 0 of a dense volume has a few
    thousand candidates)."""
    *lead, Ld, nx, ny, nz = shape
    B = lead[0] if lead else 1
    return max(4096, B * (Ld - 2) * nx * ny * nz // 1024)


def extrema_candidates(dog: torch.Tensor, thr: torch.Tensor,
                       cuboid: bool = False, capacity: int | None = None,
                       z_origin: int = 0, global_nz: int | None = None,
                       z_rows=None):
    """(keys i64[N] of every candidate, in no particular order; counts
    i64[nl] per level) of one octave's DoG stack dog f32[nl + 2, nx, ny,
    nz] with thresholds thr f32[nl]; of a batch dog f32[B, nl + 2, nx, ny,
    nz], thr f32[B, nl], the keys of all volumes and counts i64[B, nl].
    A z-slab: slab row 0 at global z z_origin of a volume global_nz deep,
    slab rows z_rows = [lo, hi) tested (the module docstring)."""
    if dog.device.type == "cpu":
        return extrema_candidates_plain(dog, thr, cuboid, z_origin,
                                        global_nz, z_rows)
    *lead, Ld, nx, ny, nz = dog.shape
    B, nl = (lead[0] if lead else 1), Ld - 2
    _build.check_cuda("extrema_candidates dog", dog, torch.float32)
    _build.check_cuda("extrema_candidates thr", thr, torch.float32,
                      tuple(lead) + (nl,))
    if min(nx, ny, nz) < 3 or nl < 1 or len(lead) > 1:
        raise ValueError(f"extrema_candidates: DoG stack too small "
                         f"{tuple(dog.shape)}")
    if ny * nz >= 2 ** 31 or B * nl > 65535:
        raise ValueError("extrema_candidates: a (y, z) plane needs 64-bit "
                         "offsets, or the batch is too large for the grid")
    counts = torch.zeros(1 + B * nl, dtype=torch.int64, device=dog.device)
    gnz = nz if global_nz is None else int(global_nz)
    zmin, zmax = z_test_rows(nz, z_origin, global_nz, z_rows)
    if zmin > zmax:       # no row of the slab can hold a candidate
        return (torch.empty(0, dtype=torch.int64, device=dog.device),
                counts[1:].reshape(tuple(lead) + (nl,)))

    def launch(cap: int) -> torch.Tensor:
        keys = torch.empty(max(cap, 1), dtype=torch.int64, device=dog.device)
        _build.call("s3d_extrema_candidates", dog.data_ptr(), thr.data_ptr(),
                    keys.data_ptr(), counts.data_ptr(), cap, B, nl, nx, ny,
                    nz, zmin, zmax, int(z_origin), gnz, int(cuboid),
                    _build.stream_ptr(dog))
        return keys

    cap = default_capacity(dog.shape) if capacity is None else int(capacity)
    keys = launch(cap)
    n = profiling.read_int(counts[0])    # the octave's count read
    if n > cap:           # once more, with a slot for every key
        counts.zero_()
        keys = launch(n)
    return keys[:n], counts[1:].reshape(tuple(lead) + (nl,))

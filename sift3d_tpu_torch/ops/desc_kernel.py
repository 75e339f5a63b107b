"""Icosahedral descriptor histograms of one octave, window prep included.

Replaces the TPU kernel ``sift3d_tpu/ops/desc_kernel.py:304
desc_hist_pallas`` (``_desc_hist_packed``/``_desc_hist_single``) together
with the window prep that fed it (``sift3d_tpu/descriptor.py:216
_prep_window``). Per keypoint k, on its level, around its center with
scale sd[k] and rotation R[k]: every voxel of the loop-bound box
(IM_LOOP_SPHERE_START, sift.c:86-109) inside the sphere of radius
win_radius = desc_rad_fctr * desc_sig_fctr * sd whose spatial bin
coordinates vb = (R^T d + half_width) * bin_fctr lie in [0, 4)
(sift.c:1452-1492) adds |grot| times a 2-sparse trilinear weight per axis
(SIFT3D_desc_acc_interp, sift.c:1340-1363) times the 3-sparse barycentric
weight over the vertices of the first icosahedron face, in face order,
that grot = R^T (w g) pierces (icos_hist_bin, sift.c:1254-1291), by the
division-free hit test of sift3d_tpu/descriptor.py:151-172. Output hist
f32[K, 16, 48] = [(cz, cy), (cx, v)].

CUDA kernel (csrc/desc.cu, ``s3d_desc_fused``): a 2-D grid of (keypoint,
slice of its box); each block reads the level in place and computes the
gradient, the masks, the weight, grot and vb of each voxel in registers,
with the operations of ``prep_windows`` in its order, then runs the
20-face test and adds 24 contributions into a per-warp histogram in shared
memory; the block merges its histograms and adds them into the keypoint's
accumulator with global atomics, and a second kernel converts the
accumulators to f32. The sums are exact: each contribution is rounded once
to a fixed-point int64 (a per-keypoint power of two, from the size of its
box) and added as an integer, so the result does not depend on the order
of the adds, and a keypoint gives the same bits on every call, whatever
the launch's split, batch or shard. grot and vb never reach device memory. The
antipodal face pairing, the 8-keypoint packing, the affine-vbins layout
and the skip-flag words of the TPU kernel served its MXU and scalar core
and are not carried over.

Bound on the H100: operations — some 400 f32 operations a voxel of the
box, most of them the face test — and the shared-memory atomics. The sums run
in another order than the plain version's f32 sums (tolerance: rel-L2 1e-5
per descriptor).

The levels may be a z-slab of a deeper volume (a shard's rows and their
halo): ``z_origin`` is the global z of slab row 0 and ``global_nz`` the
volume's depth; centers stay global and the windows clip at the global
depth (the TPU kernel's ``z_view``, sift3d_tpu/windows.py:27-64). The
slab must hold every window's rows; the defaults are the whole volume.

The plain version is ``prep_windows`` (gathered windows, masks and
rotation as batched tensor math, as the TPU package kept it in XLA) and
``desc_hist_plain`` (the dense per-voxel contraction). On a CPU tensor the
wrapper runs it; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import geometry, profiling
from ..params import ICOS_NFACES, ICOS_NVERT, NHIST_PER_DIM
from ..windows import gather_windows, window_extent
from . import _build, true_div, warm_cpu_math

NB = NHIST_PER_DIM
# Blocks per keypoint are chosen so a launch has at least this many.
_MIN_BLOCKS = 4 * 132
_VOX_PER_BLOCK_MIN = 4096
_SQRT2 = math.sqrt(2.0)
# Keypoints per batch of the plain version: bounds its transient memory to
# about this many window voxels (~80 bytes each).
_PREP_VOXELS = 12_000_000


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device):
    """Face geometry on `device`: f32[200] = MT_MATRIX [3, 60] then
    K_CONST [20], and i32[60] = FACE_IDX [20, 3]."""
    geom = np.concatenate([geometry.MT_MATRIX.ravel(), geometry.K_CONST])
    return (profiling.to_device(geom.astype(np.float32), None, device),
            profiling.to_device(geometry.FACE_IDX.astype(np.int32).ravel(),
                                None, device))


def _sparse4(vb: torch.Tensor) -> torch.Tensor:
    """[n, 4] trilinear weights of one axis: 1-fr at floor(vb), fr at
    floor(vb)+1."""
    base = torch.floor(vb)
    fr = vb - base
    cells = torch.arange(NB, dtype=torch.float32, device=vb.device)[None, :]
    return (torch.where(cells == base[:, None], 1.0 - fr[:, None], 0.0)
            + torch.where(cells == base[:, None] + 1.0, fr[:, None], 0.0))


def _hist_chunk(g, vb, eps, consts):
    """[16, 48] contribution of n voxels, g/vb [n, 3] (the contraction of
    sift3d_tpu/descriptor.py:125-204)."""
    geom, fidx = consts
    mt, kconst = geom[:180].reshape(3, 60), geom[180:]
    face_idx = fidx.long().reshape(ICOS_NFACES, 3)
    F = g @ mt                                            # [n, 60]
    dets, ynum, znum = F[:, :20], F[:, 20:40], F[:, 40:]
    sgn = torch.sign(dets)
    adet = dets * sgn
    neg_eps_adet = -eps * adet
    ysn = ynum * sgn
    zsn = znum * sgn
    validf = ((adet >= eps) & (ysn >= neg_eps_adet) & (zsn >= neg_eps_adet)
              & (adet - ysn - zsn >= neg_eps_adet)
              & (kconst[None, :] * sgn >= 0.0))
    iota20 = torch.arange(ICOS_NFACES, device=g.device)
    first = torch.where(validf, iota20, ICOS_NFACES).min(dim=-1).values
    gsq = (g * g).sum(dim=-1)
    anyf = (first < ICOS_NFACES) & (gsq >= eps)
    onehot = iota20[None, :] == torch.clamp(first, max=19)[:, None]
    det_s = torch.where(onehot, dets, 0.0).sum(dim=-1)
    yn_s = torch.where(onehot, ynum, 0.0).sum(dim=-1)
    zn_s = torch.where(onehot, znum, 0.0).sum(dim=-1)
    inv = torch.where(det_s != 0.0, 1.0 / det_s, 0.0)
    ys = yn_s * inv
    zs = zn_s * inv
    xs = 1.0 - ys - zs
    mag = torch.where(anyf, torch.sqrt(gsq), 0.0)
    baryw = torch.stack([xs, ys, zs], dim=-1) * mag[:, None]   # [n, 3]
    vidx = face_idx[torch.clamp(first, max=19)]                # [n, 3]
    B = torch.zeros((g.shape[0], ICOS_NVERT), dtype=torch.float32,
                    device=g.device).scatter_add_(1, vidx, baryw)
    Sx, Sy, Sz = (_sparse4(vb[:, a]) for a in range(3))
    ZY = (Sz[:, :, None] * Sy[:, None, :]).reshape(-1, NB * NB)
    P = (Sx[:, :, None] * B[:, None, :]).reshape(-1, NB * ICOS_NVERT)
    return ZY.T @ P


def desc_hist_plain(grot: torch.Tensor, vbins: torch.Tensor, eps: float,
                    vox_chunk: int = 65536) -> torch.Tensor:
    """Plain version: the dense per-voxel contraction, keypoint by
    keypoint in voxel chunks, over the voxels whose |grot|^2 reaches eps
    (the others add nothing; the kernel skips them too)."""
    K = grot.shape[0]
    consts = _consts(grot.device)
    eps = np.float32(eps)
    out = torch.zeros((K, NB * NB, NB * ICOS_NVERT), dtype=torch.float32,
                      device=grot.device)
    for k in range(K):
        g, vb = grot[k].T, vbins[k].T
        work = (g * g).sum(dim=-1) >= eps
        g, vb = g[work], vb[work]
        for s in range(0, g.shape[0], vox_chunk):
            out[k] += _hist_chunk(g[s:s + vox_chunk], vb[s:s + vox_chunk],
                                  eps, consts)
    return out




def level_radius(sd: float, params) -> float:
    """Descriptor window radius at scale sd, in f32 as the C code."""
    sigma = np.float32(np.float32(sd) * np.float32(params.desc_sig_fctr))
    return float(np.float32(params.desc_rad_fctr) * sigma)


def window_extents(sd_max: float, units, dims, params, margin: int = 0):
    """Window size per axis that holds the loop-bound box of every
    keypoint of scale <= sd_max (windows.window_extent); margin 4 where
    centers are fractional (sift3d_tpu/descriptor.py:504-508)."""
    rad = level_radius(sd_max, params)
    return tuple(window_extent(rad / units[a], dims[a], margin)
                 for a in range(3))


def _dims(levels: torch.Tensor, global_nz):
    """The volume's (nx, ny, nz) of a level stack or z-slab."""
    nx, ny, nz = levels.shape[1:]
    return (nx, ny, nz if global_nz is None else int(global_nz))


def prep_windows(levels: torch.Tensor, lvl: torch.Tensor,
                 coords: torch.Tensor, centers: torch.Tensor,
                 R: torch.Tensor, sd: torch.Tensor, units, extents,
                 params, z_view=None):
    """(grot, vbins) f32[K, 3, N] for desc_hist_plain, N the window
    interior's voxel count; masked voxels get a zero gradient. z_view =
    (z_origin, global_nz) for a z-slab."""
    warm_cpu_math(levels.device)
    nb = NB
    K = coords.shape[0]
    dev = levels.device
    n = _dims(levels, None if z_view is None else z_view[1])
    sigma = sd * float(np.float32(params.desc_sig_fctr))
    win_radius = sigma * float(np.float32(params.desc_rad_fctr))
    half_width = true_div(win_radius, np.float32(_SQRT2))
    bin_fctr = 1.0 / (2.0 * half_width / float(nb))

    win, start = gather_windows(levels, lvl, coords, extents, z_view)
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
        ra = true_div(win_radius, u[a])
        lo = torch.clamp(torch.floor(c - ra), min=1.0)
        hi = torch.clamp(torch.ceil(c + ra),
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


def desc_fused_plain(levels: torch.Tensor, lvl: torch.Tensor,
                     centers: torch.Tensor, R: torch.Tensor,
                     sd: torch.Tensor, units, params, sd_max: float,
                     fractional: bool = False, z_origin: int = 0,
                     global_nz: int | None = None) -> torch.Tensor:
    """Plain version: prep_windows then desc_hist_plain, in batches of
    keypoints whose windows hold about _PREP_VOXELS voxels. Each window is
    anchored at rint(center) (sift3d_tpu/pipeline.py:1719)."""
    K = centers.shape[0]
    dims = _dims(levels, global_nz)
    extents = window_extents(sd_max, units, dims, params,
                             4 if fractional else 0)
    coords = centers.round().long()
    nvox = int(np.prod([e - 2 for e in extents]))
    step = max(1, _PREP_VOXELS // nvox)
    hists = [torch.zeros((0, NB * NB, NB * ICOS_NVERT), device=levels.device)]
    for s in range(0, K, step):
        sl = slice(s, s + step)
        grot, vbins = prep_windows(levels, lvl[sl], coords[sl], centers[sl],
                                   R[sl], sd[sl], units, extents, params,
                                   (z_origin, dims[2]))
        hists.append(desc_hist_plain(grot, vbins, params.bary_eps))
    return torch.cat(hists)


def desc_fused(levels: torch.Tensor, lvl: torch.Tensor,
               centers: torch.Tensor, R: torch.Tensor, sd: torch.Tensor,
               units, params, sd_max: float, fractional: bool = False,
               z_origin: int = 0,
               global_nz: int | None = None) -> torch.Tensor:
    """Histograms f32[K, 16, 48] of K keypoints of one octave.

    levels f32[L, nx, ny, nz]; lvl i64[K] level per keypoint; centers
    f32[K, 3], integer-valued or (fractional) subvoxel-refined; R f32[K,
    3, 3]; sd f32[K] absolute scale, all <= sd_max; params a
    DetectorParams. sd_max and fractional size the plain version's
    windows and the kernel's split of a keypoint's box. levels may be a
    z-slab whose row 0 is global z z_origin of a volume global_nz deep.
    On the card a keypoint whose window leaves the slab reads NaN (the
    kernel reads nothing outside the slab); the plain version raises
    ValueError."""
    if levels.device.type == "cpu":
        return desc_fused_plain(levels, lvl, centers, R, sd, units, params,
                                sd_max, fractional, z_origin, global_nz)
    K = centers.shape[0]
    _, nx, ny, nzs = levels.shape
    dims = _dims(levels, global_nz)
    _build.check_cuda("desc_fused levels", levels, torch.float32)
    _build.check_cuda("desc_fused lvl", lvl, torch.int64, (K,))
    _build.check_cuda("desc_fused centers", centers, torch.float32, (K, 3))
    _build.check_cuda("desc_fused R", R, torch.float32, (K, 3, 3))
    _build.check_cuda("desc_fused sd", sd, torch.float32, (K,))
    out = torch.empty((K, NB * NB, NB * ICOS_NVERT), dtype=torch.float32,
                      device=levels.device)
    if K == 0:
        return out
    acc = torch.zeros((K, NB * NB * NB * ICOS_NVERT), dtype=torch.int64,
                      device=levels.device)
    bad = torch.zeros(K, dtype=torch.int32, device=levels.device)
    # The largest loop-bound box, which sizes the split of each keypoint.
    box = int(np.prod([e - 2 for e in window_extents(
        sd_max, units, dims, params, 4 if fractional else 0)]))
    splits = max(1, min(-(-_MIN_BLOCKS // K), box // _VOX_PER_BLOCK_MIN))
    geom, face_idx = _consts(levels.device)
    u = [np.float32(x) for x in units]
    inv = [np.float32(1.0) / x for x in u]
    scal = [*u, *inv, params.desc_sig_fctr, params.desc_rad_fctr, _SQRT2,
            params.bary_eps]
    _build.call("s3d_desc_fused", levels.data_ptr(), lvl.data_ptr(),
                centers.data_ptr(), R.data_ptr(), sd.data_ptr(),
                geom.data_ptr(), face_idx.data_ptr(), acc.data_ptr(),
                bad.data_ptr(), out.data_ptr(), K, splits, nx, ny, nzs,
                int(z_origin), dims[2], *(float(np.float32(x)) for x in scal),
                _build.stream_ptr(levels))
    return out

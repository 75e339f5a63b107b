"""Icosahedral descriptor histogram accumulation.

Replaces the TPU kernel ``sift3d_tpu/ops/desc_kernel.py:304
desc_hist_pallas`` (``_desc_hist_packed``/``_desc_hist_single``). Input per
keypoint k and window voxel n: grot f32[K, 3, N], the gradient rotated into
the keypoint frame and Gaussian-weighted (zero where the voxel is masked
out), and vbins f32[K, 3, N], its spatial bin coordinates in [0, 4). Output
hist f32[K, 16, 48] = [(cz, cy), (cx, v)]: each voxel adds |grot| times a
2-sparse trilinear weight per axis (SIFT3D_desc_acc_interp,
sift.c:1340-1363) times the 3-sparse barycentric weight over the vertices
of the first icosahedron face, in face order, that the gradient pierces
(icos_hist_bin, sift.c:1254-1291), by the division-free hit test of
sift3d_tpu/descriptor.py:151-172.

CUDA kernel (csrc/desc.cu, ``s3d_desc_hist``): a 2-D grid of (keypoint,
voxel slice); each block keeps a private float[768] histogram in shared
memory, its threads stride over the slice, run the 20-face test with the
same round-to-nearest arithmetic and add 24 contributions with
shared-memory atomics; the block then adds its histogram into the
keypoint's output with global atomics. The antipodal face pairing, the
8-keypoint packing, the affine-vbins layout and the skip-flag words of
the TPU kernel served its MXU and scalar core and are not carried over.

Bound on the H100: shared-memory atomics on 768 bins (neighboring voxels
hit neighboring bins) and the 24 B/voxel read of grot + vbins. The sums
run in an order that changes from run to run (tolerance: rel-L2 1e-5 per
descriptor). Fusing the window prep into the kernel, so grot and vbins
never reach device memory, is later work.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import geometry
from ..params import ICOS_NFACES, ICOS_NVERT, NHIST_PER_DIM
from . import _build

launches = 0   # kernel launches on CUDA tensors (chip_smoke.py reads it)

NB = NHIST_PER_DIM
# Blocks per keypoint are chosen so a launch has at least this many.
_MIN_BLOCKS = 4 * 132
_VOX_PER_BLOCK_MIN = 4096


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device):
    """Face geometry on `device`: f32[200] = MT_MATRIX [3, 60] then
    K_CONST [20], and i32[60] = FACE_IDX [20, 3]."""
    geom = np.concatenate([geometry.MT_MATRIX.ravel(), geometry.K_CONST])
    return (torch.from_numpy(geom.astype(np.float32)).to(device),
            torch.from_numpy(geometry.FACE_IDX.astype(np.int32).ravel())
            .to(device))


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
    keypoint in voxel chunks."""
    K, _, N = grot.shape
    consts = _consts(grot.device)
    eps = np.float32(eps)
    out = torch.zeros((K, NB * NB, NB * ICOS_NVERT), dtype=torch.float32,
                      device=grot.device)
    for k in range(K):
        for s in range(0, N, vox_chunk):
            out[k] += _hist_chunk(grot[k, :, s:s + vox_chunk].T,
                                  vbins[k, :, s:s + vox_chunk].T, eps,
                                  consts)
    return out


def desc_hist(grot: torch.Tensor, vbins: torch.Tensor,
              eps: float) -> torch.Tensor:
    """Histograms f32[K, 16, 48] of K keypoints' prepped windows
    (grot, vbins f32[K, 3, N]); eps is bary_eps."""
    global launches
    if grot.device.type == "cpu":
        return desc_hist_plain(grot, vbins, eps)
    K, _, N = grot.shape
    _build.check_cuda("desc_hist grot", grot, torch.float32, (K, 3, N))
    _build.check_cuda("desc_hist vbins", vbins, torch.float32, (K, 3, N))
    out = torch.zeros((K, NB * NB, NB * ICOS_NVERT), dtype=torch.float32,
                      device=grot.device)
    if K == 0 or N == 0:
        return out
    geom, face_idx = _consts(grot.device)
    splits = max(1, min(-(-_MIN_BLOCKS // K), N // _VOX_PER_BLOCK_MIN))
    _build.call("s3d_desc_hist", grot.data_ptr(), vbins.data_ptr(),
                geom.data_ptr(), face_idx.data_ptr(), out.data_ptr(),
                K, N, splits, float(np.float32(eps)),
                _build.stream_ptr(grot))
    launches += 1
    return out

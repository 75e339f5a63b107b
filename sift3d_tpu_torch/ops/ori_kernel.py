"""Orientation of one octave's candidates: moments, eigh3x3, rejection, R.

Replaces the TPU kernel ``sift3d_tpu/ops/ori_kernel.py:167
ori_moments_pallas`` and the epilogue that ran after it in the same XLA
program (``sift3d_tpu/orientation.py:250-289``). Per keypoint k, on
pyramid level lvl[k] around the center centers[k] (integer-valued, or
fractional after subvoxel refinement) with scale sd[k]: central-difference
gradients times 1/units (IM_GET_GRAD_ISO, sift.c:140-145), the
reference's loop bounds [max(floor(c - rad/u), 1), min(ceil(c + rad/u),
n-2)] computed in f32 and the sphere |d| <= rad (IM_LOOP_SPHERE_START,
sift.c:86-109), with sigma = ori_sig_fctr * sd, rad = ori_rad_fctr *
sigma and the weight exp(-r^2 / (2 sigma^2)), give the structure tensor
A = sum w g g^T and vd = sum w g (assign_eig_ori, sift.c:963-989). Then
eigh3x3 (6 cyclic Jacobi sweeps, eigenvalues ascending), the
weak-gradient, eigenvalue-ratio and corner tests
(sift.c:996-1102) and R = [r0, r1, r0 x r1] from the two largest
eigenvectors, each signed so the directional derivative along it is
positive (sift.c:1017-1059).

CUDA kernel (csrc/ori.cu, ``s3d_orient``): one block per keypoint walks
the loop-bound box of its f32 center on its level in place and reduces the
9 moment sums; one thread then runs eigh3x3, the tests and R in registers.
One launch per octave writes A, vd, R and the four predicates.
``s3d_eigh3x3`` exports the kernel's eigensolver alone, batched: the card
holds it bit for bit against ``eigh3x3_plain``, and the Hessian edge test
of refinement.py runs on it.

Bound on the H100: latency — a few hundred keypoints of ~10^4 voxels each
is a few microseconds of reads. The moment sums run in another order than
the plain version (tolerance: rel 1e-5); the eigensolver and the tests use
the plain version's operations in its order.

The plain version gathers a window around each keypoint's integer anchor
(the candidate's voxel; the TPU kernel's ``coords``) that holds the box:
with fractional centers, which lie within a voxel of the anchor, the
window gets the JAX package's margin of 4 voxels
(sift3d_tpu/orientation.py:204-210). The kernel needs no anchor.

The levels may be a z-slab of a deeper volume (a shard's rows and their
halo), as the TPU kernel's ``z_origin``/``global_nz``
(sift3d_tpu/ops/ori_kernel.py:178-191): slab row 0 sits at global z
``z_origin``, centers stay global and the loop bounds clip at the global
depth. The slab must hold every window's rows; the defaults are the whole
volume.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..windows import gather_windows, window_extent
from . import _build, true_div, warm_cpu_math


class Orientation(NamedTuple):
    A: torch.Tensor              # f32[K, 3, 3] structure tensor
    vd: torch.Tensor             # f32[K, 3] weighted gradient sum
    R: torch.Tensor              # f32[K, 3, 3]
    # accepted and the raw stage predicates in the reference's
    # short-circuit order (grad -> ratio -> corner, sift.c:996-1102), one
    # block as the kernel writes it; each is a column below.
    flags: torch.Tensor          # bool[K, 4]

    accepted = property(lambda self: self.flags[:, 0])
    reject_grad = property(lambda self: self.flags[:, 1])
    reject_ratio = property(lambda self: self.flags[:, 2])
    reject_corner = property(lambda self: self.flags[:, 3])


def _moments_chunk(levels, lvl, anchors, fp, units, sig_fctr, rad_fctr,
                   extents, z_view):
    n = tuple(levels.shape[1:3]) + (z_view[1],)
    center, sd = fp[:, :3], fp[:, 3]
    win, start = gather_windows(levels, lvl, anchors, extents, z_view)
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
        ra = true_div(rad, u[a])
        lo = torch.clamp(torch.floor(c - ra), min=1.0)
        hi = torch.clamp(torch.ceil(c + ra), max=float(n[a] - 2))
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
    if K == 1:
        # torch takes a batch of one as a single matrix product, which sums
        # in another order than the batched one: pair the keypoint with
        # itself, so that its moments do not depend on how many keypoints
        # share the call (a shard's or a volume's alone).
        A = torch.einsum("kvi,kvj->kij", wg.expand(2, -1, -1),
                         g.expand(2, -1, -1))[:1]
    else:
        A = torch.einsum("kvi,kvj->kij", wg, g)
    return A, wg.sum(dim=1)


def ori_moments_plain(levels: torch.Tensor, lvl: torch.Tensor,
                      anchors: torch.Tensor, fp: torch.Tensor, units,
                      sig_fctr: float, rad_fctr: float, sd_max: float,
                      margin: int = 0, chunk: int = 256, z_origin: int = 0,
                      global_nz: int | None = None):
    """Window moments (A [K, 3, 3], vd [K, 3]) from gathered windows and
    masked sums, as sift3d_tpu/orientation.py:48 _window_moments.
    anchors i64[K, 3] window anchors; fp f32[K, 4] = (cx, cy, cz, sd), sd
    <= sd_max; margin the windows' slack for fractional centers; levels a
    z-slab whose row 0 is global z z_origin of a volume global_nz deep."""
    warm_cpu_math(levels.device)
    n = tuple(levels.shape[1:3]) + (
        levels.shape[3] if global_nz is None else int(global_nz),)
    z_view = (int(z_origin), n[2])
    rad_max = sig_fctr * sd_max * rad_fctr
    extents = tuple(window_extent(rad_max / units[a], n[a], margin)
                    for a in range(3))
    parts = [_moments_chunk(levels, lvl[s:s + chunk], anchors[s:s + chunk],
                            fp[s:s + chunk], units, sig_fctr, rad_fctr,
                            extents, z_view)
             for s in range(0, fp.shape[0], chunk)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def eigh3x3_plain(A: torch.Tensor):
    """Batched symmetric 3x3 eigendecomposition by 6 fixed sweeps of
    cyclic Jacobi rotations: eigenvalues ascending, eigenvectors in
    columns (the convention of LAPACK dsyevd used by eigen_Mat_rm,
    imutil.c:960-1067). Same arithmetic as sift3d_tpu/orientation.py:110
    eigh3x3."""
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    V = [[torch.full_like(A[..., 0, 0], float(i == j)) for j in range(3)]
         for i in range(3)]
    one = torch.ones_like(A[..., 0, 0])
    zero = torch.zeros_like(one)

    for _ in range(6):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            app, aqq, apq = a[p][p], a[q][q], a[p][q]
            # Rotation angle zeroing a_pq (Golub & Van Loan 8.4); the
            # already-zero case keeps c = 1, s = 0.
            safe = apq.abs() > 0.0
            tau = (aqq - app) / torch.where(safe, 2.0 * apq, one)
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tau == 0.0, one, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = torch.where(safe, t * c, zero)
            c = torch.where(safe, c, one)
            # a' = J^T a J: columns p, q, then rows p, q.
            new = [row[:] for row in a]
            for k in range(3):
                akp, akq = a[k][p], a[k][q]
                new[k][p] = c * akp - s * akq
                new[k][q] = s * akp + c * akq
            rows2 = [row[:] for row in new]
            for k in range(3):
                apk, aqk = new[p][k], new[q][k]
                rows2[p][k] = c * apk - s * aqk
                rows2[q][k] = s * apk + c * aqk
            a = rows2
            for k in range(3):
                vp, vq = V[k][p], V[k][q]
                V[k][p] = c * vp - s * vq
                V[k][q] = s * vp + c * vq

    w = torch.stack([a[0][0], a[1][1], a[2][2]], dim=-1)
    Vm = torch.stack([torch.stack(r, dim=-1) for r in V], dim=-2)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    Vm = torch.gather(Vm, -1, order[..., None, :].expand_as(Vm))
    return w, Vm


def eigh3x3(A: torch.Tensor):
    """(w f32[K, 3], V f32[K, 3, 3]) of symmetric A f32[K, 3, 3]: the
    eigensolver of the orientation kernel, alone."""
    if A.device.type == "cpu":
        return eigh3x3_plain(A)
    K = A.shape[0]
    _build.check_cuda("eigh3x3 A", A, torch.float32, (K, 3, 3))
    w = torch.empty((K, 3), dtype=torch.float32, device=A.device)
    V = torch.empty((K, 3, 3), dtype=torch.float32, device=A.device)
    if K:
        _build.call("s3d_eigh3x3", A.data_ptr(), w.data_ptr(), V.data_ptr(),
                    K, _build.stream_ptr(A))
    return w, V


def _epilogue(A, vd, params) -> Orientation:
    """eigh3x3, the rejection tests and R on moments A, vd (the plain
    version of the kernel's last thread)."""
    L, Q = eigh3x3_plain(A)

    grad_sq = (vd * vd).sum(dim=-1)
    reject_grad = grad_sq < np.float32(params.ori_grad_thresh)

    # Ratio test (sift.c:1011-1015): C computes fabs(l_i / l_{i+1}); inf
    # compares > thresh (reject), NaN compares false (keep).
    thr = np.float32(params.max_eig_ratio)

    def gt(r):
        return torch.where(torch.isnan(r), False, r > thr)
    reject_ratio = (gt((L[:, 0] / L[:, 1]).abs())
                    | gt((L[:, 1] / L[:, 2]).abs()))

    # Sign fixing + corner score (sift.c:1017-1059).
    v2, v1 = Q[:, :, 2], Q[:, :, 1]
    d2 = (vd * v2).sum(dim=-1)
    d1 = (vd * v1).sum(dim=-1)
    gnorm = torch.sqrt(grad_sq)
    cos2 = d2 / (torch.linalg.vector_norm(v2, dim=-1) * gnorm)
    cos1 = d1 / (torch.linalg.vector_norm(v1, dim=-1) * gnorm)
    corner = torch.minimum(cos2.abs(), cos1.abs())
    r0 = v2 * torch.where(d2 > 0.0, 1.0, -1.0)[:, None]
    r1 = v1 * torch.where(d1 > 0.0, 1.0, -1.0)[:, None]
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    R = torch.stack([r0, r1, r2], dim=-1)
    reject_corner = corner < np.float32(params.corner_thresh)

    accepted = ~reject_grad & ~reject_ratio & ~reject_corner
    return Orientation(A, vd, R, torch.stack(
        [accepted, reject_grad, reject_ratio, reject_corner], dim=1))


def orient_plain(levels: torch.Tensor, lvl: torch.Tensor,
                 anchors: torch.Tensor, sd: torch.Tensor, units, params, *,
                 centers: torch.Tensor | None = None,
                 sd_max: float | None = None, fractional: bool = False,
                 z_origin: int = 0,
                 global_nz: int | None = None) -> Orientation:
    """Plain version: ori_moments_plain, eigh3x3_plain, then the tests."""
    if centers is None:
        centers = anchors.to(torch.float32)
    if sd_max is None:
        sd_max = float(sd.max()) if sd.numel() else 0.0
    fp = torch.cat([centers, sd[:, None]], dim=1)
    A, vd = ori_moments_plain(levels, lvl, anchors, fp.contiguous(), units,
                              params.ori_sig_fctr, params.ori_rad_fctr,
                              sd_max, 4 if fractional else 0,
                              z_origin=z_origin, global_nz=global_nz)
    return _epilogue(A, vd, params)


def orient(levels: torch.Tensor, lvl: torch.Tensor, anchors: torch.Tensor,
           sd: torch.Tensor, units, params, *,
           centers: torch.Tensor | None = None, sd_max: float | None = None,
           fractional: bool = False, z_origin: int = 0,
           global_nz: int | None = None) -> Orientation:
    """Orientation of K keypoints of one octave.

    levels f32[L, nx, ny, nz]; lvl i64[K] level per keypoint; anchors
    i64[K, 3] integer voxels; sd f32[K] absolute scale; params a
    DetectorParams. centers f32[K, 3] (default: the anchors) are the true
    window centers, within a voxel of the anchors when fractional; sd_max
    (default: max sd) bounds sd. The anchors, sd_max and fractional size
    and place the plain version's windows only. levels may be a z-slab
    whose row 0 is global z z_origin of a volume global_nz deep. On the
    card a keypoint whose window leaves the slab gets NaN A, vd and R and
    no flag set (the kernel reads nothing outside the slab); the plain
    version raises ValueError."""
    if levels.device.type == "cpu":
        return orient_plain(levels, lvl, anchors, sd, units, params,
                            centers=centers, sd_max=sd_max,
                            fractional=fractional, z_origin=z_origin,
                            global_nz=global_nz)
    K = anchors.shape[0]
    if centers is None:
        centers = anchors.to(torch.float32)
    _, nx, ny, nzs = levels.shape
    gnz = nzs if global_nz is None else int(global_nz)
    _build.check_cuda("orient levels", levels, torch.float32)
    _build.check_cuda("orient lvl", lvl, torch.int64, (K,))
    _build.check_cuda("orient centers", centers, torch.float32, (K, 3))
    _build.check_cuda("orient sd", sd, torch.float32, (K,))
    dev = levels.device
    moments = torch.empty((K, 12), dtype=torch.float32, device=dev)
    R = torch.empty((K, 3, 3), dtype=torch.float32, device=dev)
    flags = torch.empty((K, 4), dtype=torch.bool, device=dev)
    if K:
        u = [np.float32(x) for x in units]
        inv = [np.float32(1.0) / x for x in u]
        scal = [*u, *inv, params.ori_sig_fctr, params.ori_rad_fctr,
                params.ori_grad_thresh, params.max_eig_ratio,
                params.corner_thresh]
        _build.call("s3d_orient", levels.data_ptr(), lvl.data_ptr(),
                    centers.data_ptr(), sd.data_ptr(), moments.data_ptr(),
                    R.data_ptr(), flags.data_ptr(), K, nx, ny, nzs,
                    int(z_origin), gnz,
                    *(float(np.float32(x)) for x in scal),
                    _build.stream_ptr(levels))
    return Orientation(moments[:, :9].reshape(K, 3, 3), moments[:, 9:], R,
                       flags)

"""Descriptor matching, RANSAC affine registration and warping.

Counterpart of sift3d_tpu/registration.py (the register_SIFT3D capability
of the upstream SIFT3D line, which the reference fork removed):

 - Matching: the [N1, N2] squared-distance matrix as |a|^2 + |b|^2 - 2 a.b
   from one full-f32 product (JAX: Precision.HIGHEST; on the card TF32 is
   switched off around it), nearest and second-nearest per row by a second
   pass with the best column masked, Lowe's ratio test d1/d2 < nn_thresh.
 - RANSAC: every minimal 4-point hypothesis at once, as one batch of 4x4
   systems (``torch.linalg.solve_ex``: a singular sample counts no
   inliers instead of raising), inliers counted by one batched product,
   the first best hypothesis refit three times by weighted normal
   equations.
 - Warping: inverse-mapped trilinear resampling with clipped gathers and
   zeros outside the volume (not ``F.grid_sample``, whose border rule
   differs).

All of it is plain PyTorch on the caller's device: products and small
solves that the JAX package left to XLA, outside any TPU kernel. The
JAX package's power-of-two padding of the match and RANSAC inputs served
XLA's static shapes and is not carried over. Hypothesis indices come from
a seeded ``torch.Generator`` on the CPU, so a seed draws the same
hypotheses on every device (JAX's PRNG draws others: the tests feed both
the same indices).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .keypoints import Descriptors
from .params import DetectorParams
from .volume import Volume, as_volume

_BIG = float(np.finfo(np.float32).max)


@contextlib.contextmanager
def _full_f32():
    """Full-f32 matrix products on the card (no TF32) inside the block,
    whatever the process-wide setting; the previous one is restored."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------


def _match_core(d1: torch.Tensor, d2: torch.Tensor, nn_thresh: float):
    """(best i64[N1], ok bool[N1]) for descriptors d1 f32[N1, D] against
    d2 f32[N2, D] (sift3d_tpu/registration.py:36 _match_core)."""
    sq1 = (d1 * d1).sum(dim=1, keepdim=True)
    sq2 = (d2 * d2).sum(dim=1, keepdim=True)
    with _full_f32():
        D = sq1 + sq2.T - 2.0 * (d1 @ d2.T)
    D = torch.clamp(D, min=0.0)
    best_idx = torch.argmin(D, dim=1)
    rows = torch.arange(D.shape[0], device=D.device)
    best = D[rows, best_idx]
    D[rows, best_idx] = _BIG
    second = D.amin(dim=1)
    ratio = torch.sqrt(best) / torch.clamp(torch.sqrt(second), min=1e-30)
    ok = (ratio < float(np.float32(nn_thresh))) & (second < _BIG)
    return best_idx, ok


def match_descriptors(desc1: Descriptors, desc2: Descriptors,
                      nn_thresh: float = 0.8,
                      device: torch.device | str = "cuda"):
    """Match desc1 against desc2 on `device`. Returns (idx1, idx2) i64
    numpy index arrays of the accepted pairs."""
    if len(desc1) == 0 or len(desc2) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    def put(d):
        return torch.as_tensor(np.asarray(d.data, np.float32), device=device)
    best_idx, ok = _match_core(put(desc1), put(desc2), nn_thresh)
    idx1 = np.nonzero(ok.cpu().numpy())[0]
    return idx1, best_idx.cpu().numpy()[idx1]


# ---------------------------------------------------------------------------
# RANSAC affine
# ---------------------------------------------------------------------------


def _sample_distinct4(gen: torch.Generator, num_iter: int,
                      n: int) -> torch.Tensor:
    """i64[num_iter, 4] minimal samples, each row 4 distinct indices
    uniform over [0, max(n, 4)): the k-th draw samples [0, n - k) and
    shifts past the earlier picks (sift3d_tpu/registration.py:102)."""
    n = max(int(n), 4)
    r = [torch.randint(0, n - j, (num_iter,), generator=gen)
         for j in range(4)]
    i0 = r[0]
    i1 = r[1] + (r[1] >= i0)
    a01, b01 = torch.minimum(i0, i1), torch.maximum(i0, i1)
    i2 = r[2] + (r[2] >= a01)
    i2 = i2 + (i2 >= b01)
    lo, hi = torch.minimum(a01, i2), torch.maximum(b01, i2)
    mid = a01 + b01 + i2 - lo - hi
    i3 = r[3] + (r[3] >= lo)
    i3 = i3 + (i3 >= mid)
    i3 = i3 + (i3 >= hi)
    return torch.stack([i0, i1, i2, i3], dim=1)


def _ransac_core(src: torch.Tensor, dst: torch.Tensor, idx: torch.Tensor,
                 err_thresh: float, w: torch.Tensor):
    """Affine A f32[3, 4] with dst ~ A [src; 1], its inlier count and mask
    bool[M] (sift3d_tpu/registration.py:128 _ransac_core).

    src, dst f32[M, 3]; idx i64[num_iter, 4] the hypotheses' samples; w
    f32[M] the refit's per-correspondence weights (sampling and counting
    stay unweighted)."""
    M = src.shape[0]
    dev = src.device
    X = torch.cat([src, torch.ones((M, 1), dtype=torch.float32, device=dev)],
                  dim=1)                                        # [M, 4]
    As, info = torch.linalg.solve_ex(X[idx], dst[idx])          # [N, 4, 3]
    with _full_f32():
        pred = torch.einsum("mi,nij->nmj", X, As)
    err2 = ((pred - dst[None]) ** 2).sum(dim=-1)                # [N, M]
    thr2 = float(np.float32(err_thresh * err_thresh))
    usable = (info == 0) & torch.isfinite(As).all(dim=2).all(dim=1)
    inl = (err2 < thr2) & usable[:, None]
    best = torch.argmax(inl.sum(dim=1))          # the first best hypothesis
    inl_cur = inl[best]
    eye = 1e-8 * torch.eye(4, dtype=torch.float32, device=dev)
    for _ in range(3):
        Xw = X * (inl_cur.to(torch.float32) * w)[:, None]
        with _full_f32():
            A_r, _ = torch.linalg.solve_ex(Xw.T @ X + eye, Xw.T @ dst)
            err2f = ((X @ A_r - dst) ** 2).sum(dim=-1)
        inl_cur = err2f < thr2
    return A_r.T, int(inl_cur.sum()), inl_cur


@dataclasses.dataclass
class RegistrationResult:
    # f32[3, 4], maps moving voxel coords -> fixed; None when fewer than
    # 4 correspondences survived matching (no path raises on it)
    affine: np.ndarray | None
    num_matches: int
    num_inliers: int
    matches_fixed: np.ndarray   # f32[M, 3] matched fixed-volume coords
    matches_moving: np.ndarray  # f32[M, 3]
    inlier_mask: np.ndarray     # bool[M]


def ransac_affine(src_pts, dst_pts, err_thresh: float = 5.0,
                  num_iter: int = 500, seed: int = 0, weights=None,
                  device: torch.device | str = "cuda"):
    """Robust affine fit dst ~ A [src; 1] on `device`. Returns (A f32[3,
    4], inlier mask bool[M]) as numpy arrays; (None, all-False mask) for
    fewer than 4 correspondences, which cannot constrain an affine.

    weights (optional f32[M]): per-correspondence precision weights for
    the consensus refit."""
    src = np.asarray(src_pts, np.float32)
    dst = np.asarray(dst_pts, np.float32)
    M = len(src)
    if M < 4:
        return None, np.zeros(M, bool)
    w = (np.ones(M, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    idx = _sample_distinct4(torch.Generator().manual_seed(int(seed)),
                            int(num_iter), M)

    def put(a):
        return torch.as_tensor(a, device=device)
    A, _, mask = _ransac_core(put(src), put(dst), put(idx),
                              float(err_thresh), put(w))
    return A.cpu().numpy(), mask.cpu().numpy()


def register(fixed, moving, params=None, nn_thresh: float = 0.8,
             err_thresh: float = 5.0, num_iter: int = 500,
             kp_limit: int = 0, seed: int = 0, detectors=None,
             device: torch.device | str = "cuda") -> RegistrationResult:
    """Full SIFT3D registration on `device`: detect + describe both
    volumes, match moving against fixed, RANSAC an affine (moving ->
    fixed).

    detectors: a SIFT3D to run both volumes through, or a (fixed, moving)
    pair of them; by default one SIFT3D(params, device). The refit weights
    each correspondence by 1 / (4^o_moving + 4^o_fixed): a keypoint's
    position carries the variance of its octave's voxel."""
    from .pipeline import SIFT3D

    if detectors is None:
        detectors = SIFT3D(params or DetectorParams(), device)
    det_f, det_m = (detectors if isinstance(detectors, (tuple, list))
                    else (detectors, detectors))
    kp_f = det_f.detect_keypoints(fixed)
    if kp_limit:
        kp_f = kp_f.sort_by_strength(kp_limit)
    ds_f = det_f.extract_descriptors(kp_f) if len(kp_f) else None
    kp_m = det_m.detect_keypoints(moving)
    if kp_limit:
        kp_m = kp_m.sort_by_strength(kp_limit)
    if ds_f is None or len(kp_m) == 0:
        # a featureless volume cannot be registered: the same degraded
        # result as fewer than 4 matches
        empty = np.zeros((0, 3), np.float32)
        return RegistrationResult(
            affine=None, num_matches=0, num_inliers=0, matches_fixed=empty,
            matches_moving=empty, inlier_mask=np.zeros(0, bool))
    ds_m = det_m.extract_descriptors(kp_m)

    idx_m, idx_f = match_descriptors(ds_m, ds_f, nn_thresh, device)
    pts_m = ds_m.xyz[idx_m]
    pts_f = ds_f.xyz[idx_f]
    q = 4.0 ** kp_m.octave[idx_m] + 4.0 ** kp_f.octave[idx_f]
    A, inl = ransac_affine(pts_m, pts_f, err_thresh, num_iter, seed,
                           weights=1.0 / q, device=device)
    return RegistrationResult(
        affine=A, num_matches=len(idx_m),
        num_inliers=int(inl.sum()) if A is not None else 0,
        matches_fixed=pts_f, matches_moving=pts_m, inlier_mask=inl)


# ---------------------------------------------------------------------------
# Warping
# ---------------------------------------------------------------------------


def _warp(vol: torch.Tensor, A_inv: torch.Tensor, out_shape) -> torch.Tensor:
    """out[x] = vol(A_inv [x; 1]) by trilinear interpolation, 0 where the
    source point lies outside [0, n-1] (sift3d_tpu/registration.py:428)."""
    dev = vol.device
    x, y, z = (g.reshape(-1) for g in torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device=dev)
          for n in out_shape), indexing="ij"))
    # A_inv [x; 1] term by term, in order, with no fused multiply-add: the
    # arithmetic of XLA:CPU's product without FMA (the JAX reference).
    src = torch.stack([((x * A_inv[j, 0] + y * A_inv[j, 1]) + z * A_inv[j, 2])
                       + A_inv[j, 3] for j in range(3)], dim=1)   # [V, 3]
    lo = torch.floor(src)
    fr = src - lo
    lo = lo.to(torch.int64)
    hi = [n - 1 for n in vol.shape]
    out = torch.zeros(src.shape[0], dtype=torch.float32, device=dev)
    for ox in (0, 1):
        wx = (1 - fr[:, 0]) if ox == 0 else fr[:, 0]
        ix = torch.clamp(lo[:, 0] + ox, 0, hi[0])
        for oy in (0, 1):
            wy = (1 - fr[:, 1]) if oy == 0 else fr[:, 1]
            iy = torch.clamp(lo[:, 1] + oy, 0, hi[1])
            for oz in (0, 1):
                wz = (1 - fr[:, 2]) if oz == 0 else fr[:, 2]
                iz = torch.clamp(lo[:, 2] + oz, 0, hi[2])
                out = out + wx * wy * wz * vol[ix, iy, iz]
    n = torch.tensor(hi, dtype=torch.float32, device=dev)
    inside = ((src >= 0) & (src <= n)).all(dim=1)
    return torch.where(inside, out, 0.0).reshape(tuple(out_shape))


def warp_volume(moving, affine: np.ndarray, out_shape,
                device: torch.device | str = "cuda") -> Volume:
    """Resample `moving` into the fixed grid of shape out_shape, given the
    affine (moving -> fixed), on `device`."""
    moving = as_volume(moving, device)
    A = np.eye(4, dtype=np.float64)
    A[:3, :] = np.asarray(affine, np.float64)
    A_inv = np.linalg.inv(A)[:3, :].astype(np.float32)
    out = _warp(moving.data, torch.from_numpy(A_inv).to(moving.data.device),
                tuple(int(n) for n in out_shape))
    return Volume(out, moving.units)

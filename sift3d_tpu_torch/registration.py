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
solves that the JAX package left to XLA, outside any TPU kernel. Matching
and RANSAC take a batch of pairs (register_batch, BASELINE config 5): the
pairs' descriptors padded to the batch's largest count with validity
masks, one batched product, one batch of 4x4 solves for every pair's
hypotheses, as sift3d_tpu/registration.py:196 _register_pairs_jit; one
pair is a batch of one. The JAX package's power-of-two padding served
XLA's static shapes and is not carried over. Hypothesis indices come from
a seeded ``torch.Generator`` on the CPU, so a seed draws the same
hypotheses on every device, and pair b of a batch the ones the pair draws
alone (JAX's PRNG draws others: the tests feed both the same indices).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .keypoints import Descriptors
from .params import DESC_NUMEL, DetectorParams
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


def _match_core(d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor,
                valid2: torch.Tensor, nn_thresh: float):
    """(best i64[B, N1], ok bool[B, N1]) for B pairs of descriptor sets
    d1 f32[B, N1, D] against d2 f32[B, N2, D], padded, with validity masks
    valid1 bool[B, N1], valid2 bool[B, N2]: a masked column is never the
    best or the second best, a masked row never ok
    (sift3d_tpu/registration.py:36 _match_core)."""
    sq1 = (d1 * d1).sum(dim=2, keepdim=True)
    sq2 = (d2 * d2).sum(dim=2, keepdim=True)
    with _full_f32():
        D = sq1 + sq2.transpose(1, 2) - 2.0 * torch.bmm(d1, d2.transpose(1, 2))
    D = torch.clamp(D, min=0.0)
    D = torch.where(valid2[:, None, :], D, _BIG)
    best_idx = torch.argmin(D, dim=2, keepdim=True)
    best = torch.gather(D, 2, best_idx)[..., 0]
    second = D.scatter(2, best_idx, _BIG).amin(dim=2)
    ratio = torch.sqrt(best) / torch.clamp(torch.sqrt(second), min=1e-30)
    ok = valid1 & (ratio < float(np.float32(nn_thresh))) & (second < _BIG)
    return best_idx[..., 0], ok


def match_descriptors(desc1: Descriptors, desc2: Descriptors,
                      nn_thresh: float = 0.8,
                      device: torch.device | str = "cuda"):
    """Match desc1 against desc2 on `device`. Returns (idx1, idx2) i64
    numpy index arrays of the accepted pairs."""
    if len(desc1) == 0 or len(desc2) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    def put(d):
        return torch.as_tensor(np.asarray(d.data, np.float32),
                               device=device)[None]
    d1, d2 = put(desc1), put(desc2)
    best_idx, ok = _match_core(
        d1, d2, torch.ones(d1.shape[:2], dtype=torch.bool, device=device),
        torch.ones(d2.shape[:2], dtype=torch.bool, device=device), nn_thresh)
    idx1 = np.nonzero(ok[0].cpu().numpy())[0]
    return idx1, best_idx[0].cpu().numpy()[idx1]


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


def _ransac_batch(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                  idx: torch.Tensor, err_thresh: float, w: torch.Tensor):
    """RANSAC of B pairs at once: affines A f32[B, 3, 4] with dst ~ A [src;
    1], inlier counts i64[B] and masks bool[B, M]
    (sift3d_tpu/registration.py:128 _ransac_core, vmapped as :196).

    src, dst f32[B, M, 3], padded; valid bool[B, M] the real rows; idx
    i64[B, N, 4] each pair's hypotheses' samples (of its valid rows); w
    f32[B, M] the refit's per-correspondence weights (sampling and counting
    stay unweighted). Each hypothesis is one 4x4 system of one batch of
    solves; a singular one counts no inliers."""
    B, M = src.shape[:2]
    dev = src.device
    X = torch.cat([src, torch.ones((B, M, 1), dtype=torch.float32,
                                   device=dev)], dim=2)        # [B, M, 4]
    rows = torch.arange(B, device=dev)[:, None, None]
    As, info = torch.linalg.solve_ex(X[rows, idx], dst[rows, idx])
    with _full_f32():                                           # [B, N, 4, 3]
        pred = torch.einsum("bmi,bnij->bnmj", X, As)
    err2 = ((pred - dst[:, None]) ** 2).sum(dim=-1)             # [B, N, M]
    thr2 = float(np.float32(err_thresh * err_thresh))
    usable = (info == 0) & torch.isfinite(As).all(dim=3).all(dim=2)
    inl = (err2 < thr2) & usable[..., None] & valid[:, None, :]
    best = torch.argmax(inl.sum(dim=2), dim=1)   # the first best hypothesis
    inl_cur = inl[torch.arange(B, device=dev), best]
    eye = 1e-8 * torch.eye(4, dtype=torch.float32, device=dev)
    for _ in range(3):
        Xw = X * (inl_cur.to(torch.float32) * w)[..., None]
        with _full_f32():
            XwT = Xw.transpose(1, 2)
            A_r, _ = torch.linalg.solve_ex(torch.bmm(XwT, X) + eye,
                                           torch.bmm(XwT, dst))
            err2f = ((torch.bmm(X, A_r) - dst) ** 2).sum(dim=-1)
        inl_cur = (err2f < thr2) & valid
    return A_r.transpose(1, 2), inl_cur.sum(dim=1), inl_cur


def _ransac_core(src: torch.Tensor, dst: torch.Tensor, idx: torch.Tensor,
                 err_thresh: float, w: torch.Tensor):
    """One pair: affine A f32[3, 4], its inlier count and mask bool[M], for
    src, dst f32[M, 3], idx i64[num_iter, 4], w f32[M] (a batch of one of
    _ransac_batch)."""
    valid = torch.ones((1, src.shape[0]), dtype=torch.bool,
                       device=src.device)
    A, n, inl = _ransac_batch(src[None], dst[None], valid, idx[None],
                              err_thresh, w[None])
    return A[0], int(n[0]), inl[0]


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


def _stack(ds_list, device):
    """Descriptors f32[B, M, 768] and validity bool[B, M] of B descriptor
    sets, padded to the largest count M (at least 1)."""
    M = max(1, max(len(ds) for ds in ds_list))
    d = np.zeros((len(ds_list), M, DESC_NUMEL), np.float32)
    v = np.zeros((len(ds_list), M), bool)
    for b, ds in enumerate(ds_list):
        d[b, :len(ds)], v[b, :len(ds)] = ds.data, True
    return torch.as_tensor(d, device=device), torch.as_tensor(v, device=device)


def _register_pairs(ds_m, kp_m, ds_f, kp_f, nn_thresh: float,
                    err_thresh: float, num_iter: int, seed: int,
                    device, sample=None) -> list[RegistrationResult]:
    """Match moving b against fixed b and RANSAC an affine for every pair b
    at once: one batched match on padded descriptors, one host copy of the
    matches, one batched RANSAC of the pairs with at least 4 matches, each
    on the hypotheses that `seed` draws for its match count n
    (sample(generator, num_iter, n) -> i64[num_iter, 4]; default
    _sample_distinct4). The refit weights each correspondence by
    1 / (4^o_moving + 4^o_fixed): a keypoint's position carries the
    variance of its octave's voxel."""
    sample = sample or _sample_distinct4
    B = len(ds_m)
    device = torch.device(device)
    d1, v1 = _stack(ds_m, device)
    d2, v2 = _stack(ds_f, device)
    best, ok = _match_core(d1, d2, v1, v2, nn_thresh)
    best, ok = best.cpu().numpy(), ok.cpu().numpy()
    pairs = []
    for b in range(B):
        im = np.nonzero(ok[b])[0]
        jf = best[b][im]
        q = 4.0 ** kp_m[b].octave[im] + 4.0 ** kp_f[b].octave[jf]
        pairs.append((ds_m[b].xyz[im], ds_f[b].xyz[jf],
                      (1.0 / q).astype(np.float32)))
    run = [b for b in range(B) if len(pairs[b][0]) >= 4]
    fits = {}
    if run:
        M = max(len(pairs[b][0]) for b in run)
        src = np.zeros((len(run), M, 3), np.float32)
        dst = np.zeros((len(run), M, 3), np.float32)
        w = np.ones((len(run), M), np.float32)
        valid = np.zeros((len(run), M), bool)
        idx = np.zeros((len(run), int(num_iter), 4), np.int64)
        for r, b in enumerate(run):
            pm, pf, wb = pairs[b]
            n = len(pm)
            src[r, :n], dst[r, :n], w[r, :n], valid[r, :n] = pm, pf, wb, True
            idx[r] = sample(torch.Generator().manual_seed(int(seed)),
                            int(num_iter), n).numpy()

        def put(a):
            return torch.as_tensor(a, device=device)
        A, cnt, inl = _ransac_batch(put(src), put(dst), put(valid), put(idx),
                                    float(err_thresh), put(w))
        A, cnt, inl = A.cpu().numpy(), cnt.cpu().numpy(), inl.cpu().numpy()
        fits = {b: (A[r], int(cnt[r]), inl[r, :len(pairs[b][0])])
                for r, b in enumerate(run)}
    out = []
    for b, (pm, pf, _) in enumerate(pairs):
        A, cnt, inl = fits.get(b, (None, 0, np.zeros(len(pm), bool)))
        out.append(RegistrationResult(
            affine=A, num_matches=len(pm), num_inliers=cnt,
            matches_fixed=pf, matches_moving=pm, inlier_mask=inl))
    return out


def register_batch(fixed_vols, moving_vols, params=None,
                   nn_thresh: float = 0.8, err_thresh: float = 5.0,
                   num_iter: int = 500, kp_limit: int = 0, seed: int = 0,
                   units=(1.0, 1.0, 1.0), det=None,
                   device: torch.device | str = "cuda", mesh=None,
                   axis: str = "b") -> list[RegistrationResult]:
    """Register B same-shape volume pairs (BASELINE config 5) on `device`
    (sift3d_tpu/registration.py:342 register_batch): all 2B volumes go
    through one SIFT3D.detect_keypoints_batch and
    extract_descriptors_batch, then matching and RANSAC run for all pairs
    at once. fixed_vols, moving_vols f32[B, nx, ny, nz] (or sequences of
    volumes) at voxel `units`; det a SIFT3D to run them (default
    SIFT3D(params, device)). Result b equals register() of pair b. A pair
    with fewer than 4 matches, a featureless volume's among them, gives
    affine=None and no inliers. With a mesh (parallel.make_mesh), the 2B
    volumes' detection and description are split over the devices of its
    axis `axis` (parallel.MeshBatchSIFT3D; the counterpart of
    sift3d_tpu/registration.py:342-351's batch sharded over a mesh axis);
    matching and RANSAC run on the detector's device, by default the
    axis's first."""
    from .pipeline import SIFT3D, _as_batch

    fixed, moving = _as_batch(fixed_vols), _as_batch(moving_vols)
    B = fixed.shape[0]
    if tuple(moving.shape) != tuple(fixed.shape):
        raise ValueError(f"fixed {tuple(fixed.shape)} and moving "
                         f"{tuple(moving.shape)} batches differ")
    if det is None and mesh is not None:
        from .parallel.batch import MeshBatchSIFT3D
        det = MeshBatchSIFT3D(params or DetectorParams(), mesh, axis)
    elif det is None:
        det = SIFT3D(params or DetectorParams(), device)
    kps = det.detect_keypoints_batch(
        torch.cat([fixed, moving.to(fixed.device)]), units)
    if kp_limit:
        kps = [k.sort_by_strength(kp_limit) for k in kps]
    dss = det.extract_descriptors_batch(kps)
    return _register_pairs(dss[B:], kps[B:], dss[:B], kps[:B], nn_thresh,
                           err_thresh, num_iter, seed, det.device)


def register(fixed, moving, params=None, nn_thresh: float = 0.8,
             err_thresh: float = 5.0, num_iter: int = 500,
             kp_limit: int = 0, seed: int = 0, detectors=None,
             device: torch.device | str = "cuda") -> RegistrationResult:
    """Full SIFT3D registration on `device`: detect + describe both
    volumes, match moving against fixed, RANSAC an affine (moving ->
    fixed).

    detectors: a SIFT3D to run both volumes through, or a (fixed, moving)
    pair of them; by default one SIFT3D(params, device). The volumes may
    differ in shape and voxel size; register_batch runs a batch of
    same-shape pairs."""
    from .pipeline import SIFT3D

    if detectors is None:
        detectors = SIFT3D(params or DetectorParams(), device)
    det_f, det_m = (detectors if isinstance(detectors, (tuple, list))
                    else (detectors, detectors))
    kds = []
    for det, vol in ((det_f, fixed), (det_m, moving)):
        kp = det.detect_keypoints(vol)
        if kp_limit:
            kp = kp.sort_by_strength(kp_limit)
        kds.append((kp, det.extract_descriptors(kp) if len(kp) else
                    Descriptors.empty()))
    (kp_f, ds_f), (kp_m, ds_m) = kds
    return _register_pairs([ds_m], [kp_m], [ds_f], [kp_f], nn_thresh,
                           err_thresh, num_iter, seed, device)[0]


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

"""Subvoxel keypoint refinement and Hessian edge rejection.

Counterpart of sift3d_tpu/refinement.py. The reference fork removed both
(refinement in 1.4.1; the Hessian macro survives as dead code,
immacros.h:113-150), so they are off by default; the BASELINE accuracy
configurations turn them on:

 - ``DetectorParams(refine_subvoxel=True)``: a quadratic (Taylor) fit of
   the DoG around each candidate. The spatial offset -H^-1 g is solved for
   all candidates as one batch of 3x3 systems and clamped to [-1, 1]
   voxels; the scale offset is an independent 1-D quadratic through the
   level triple, clamped to [-1, 1] levels.
 - ``DetectorParams(edge_thresh=r)``: reject a candidate whose spatial
   Hessian has eigenvalues of mixed sign (a saddle) or a magnitude ratio
   max|l| / min|l| above r, the 3-D form of Lowe's edge test.

One batched pass per octave: 3x3x3x3 neighbourhoods gathered from the
octave's DoG stack, central differences, ``ops.ori_kernel.eigh3x3`` for
the edge test (on the card the ``s3d_eigh3x3`` kernel, bit-identical to
the plain version) and ``torch.linalg.solve_ex`` for the offsets.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops.ori_kernel import eigh3x3
from .params import DetectorParams


class RefinementResult(NamedTuple):
    offset: torch.Tensor   # f32[K, 3] subvoxel offset (zeros when disabled)
    ds: torch.Tensor       # f32[K] scale-axis offset in level units
    edge_ok: torch.Tensor  # bool[K] False = rejected by the edge test


def refine_candidates_octave(dog_oct: torch.Tensor, coords: torch.Tensor,
                             lvl: torch.Tensor, params: DetectorParams,
                             valid: torch.Tensor | None = None,
                             batch: torch.Tensor | None = None
                             ) -> RefinementResult:
    """Refinement of one octave's candidates.

    dog_oct f32[num_dog_levels, nx, ny, nz]; coords i64[K, 3] interior
    voxels ([1, n-2]); lvl i64[K] keypoint level, whose DoG level is
    lvl + 1. valid bool[K] (default all) marks the real candidates. For a
    batch, dog_oct f32[B, num_dog_levels, nx, ny, nz] and batch i64[K] the
    volume of each candidate, whose neighbourhood comes from dog_oct[b]."""
    if batch is not None:
        Ld = dog_oct.shape[1]
        dog_oct = dog_oct.reshape((-1,) + tuple(dog_oct.shape[2:]))
        lvl = batch * Ld + lvl
    nb4 = gather_neighbourhoods(dog_oct, coords, lvl)   # [K, 3, 3, 3, 3]
    if valid is None:
        valid = torch.ones(coords.shape[0], dtype=torch.bool,
                           device=dog_oct.device)
    return _refine_core(nb4[:, 1], nb4[:, 0, 1, 1, 1], nb4[:, 2, 1, 1, 1],
                        valid, params)


def gather_neighbourhoods(dog_oct: torch.Tensor, coords: torch.Tensor,
                          lvl: torch.Tensor) -> torch.Tensor:
    """f32[K, 3, 3, 3, 3]: DoG levels lvl..lvl+2 (of the stack dog_oct,
    levels first) by 3x3x3 voxels around each candidate."""
    r = torch.arange(3, device=dog_oct.device)
    L = (lvl[:, None] + r)[:, :, None, None, None]
    ix, iy, iz = (coords[:, a, None] - 1 + r for a in range(3))
    return dog_oct[L, ix[:, None, :, None, None], iy[:, None, None, :, None],
                   iz[:, None, None, None, :]]


def derivatives(nb: torch.Tensor):
    """Gradient g f32[K, 3] and spatial Hessian H f32[K, 3, 3] at the
    centre of each neighbourhood nb f32[K, 3, 3, 3]: central differences,
    the cross terms from the diagonal neighbours (the stencil of the
    reference's SIFT3D_IM_GET_HESSIAN, immacros.h:113-150)."""
    c0 = nb[:, 1, 1, 1]
    gx = 0.5 * (nb[:, 2, 1, 1] - nb[:, 0, 1, 1])
    gy = 0.5 * (nb[:, 1, 2, 1] - nb[:, 1, 0, 1])
    gz = 0.5 * (nb[:, 1, 1, 2] - nb[:, 1, 1, 0])
    hxx = nb[:, 2, 1, 1] - 2 * c0 + nb[:, 0, 1, 1]
    hyy = nb[:, 1, 2, 1] - 2 * c0 + nb[:, 1, 0, 1]
    hzz = nb[:, 1, 1, 2] - 2 * c0 + nb[:, 1, 1, 0]
    hxy = 0.25 * (nb[:, 2, 2, 1] - nb[:, 2, 0, 1]
                  - nb[:, 0, 2, 1] + nb[:, 0, 0, 1])
    hxz = 0.25 * (nb[:, 2, 1, 2] - nb[:, 2, 1, 0]
                  - nb[:, 0, 1, 2] + nb[:, 0, 1, 0])
    hyz = 0.25 * (nb[:, 1, 2, 2] - nb[:, 1, 2, 0]
                  - nb[:, 1, 0, 2] + nb[:, 1, 0, 0])
    H = torch.stack([torch.stack([hxx, hxy, hxz], -1),
                     torch.stack([hxy, hyy, hyz], -1),
                     torch.stack([hxz, hyz, hzz], -1)], dim=-2)
    return torch.stack([gx, gy, gz], dim=-1), H


def _refine_core(nb: torch.Tensor, dp: torch.Tensor, dn: torch.Tensor,
                 valid: torch.Tensor, params: DetectorParams
                 ) -> RefinementResult:
    """nb f32[K, 3, 3, 3] the candidate level's neighbourhoods; dp, dn
    f32[K] the centre values of the levels below and above."""
    K = nb.shape[0]
    dev = nb.device
    c0 = nb[:, 1, 1, 1]
    g, H = derivatives(nb)

    if params.edge_thresh is not None:
        lam, _ = eigh3x3(H.contiguous())           # ascending
        alam = lam.abs()
        ratio = alam.amax(dim=-1) / torch.clamp(alam.amin(dim=-1), min=1e-20)
        same_sign = (lam > 0).all(dim=-1) | (lam < 0).all(dim=-1)
        edge_ok = (same_sign & (ratio <= float(np.float32(params.edge_thresh)))
                   | ~valid)
    else:
        edge_ok = torch.ones((K,), dtype=torch.bool, device=dev)

    if params.refine_subvoxel:
        # The JAX package adds 1e-12 I in f32 (a no-op at these
        # magnitudes). An exactly singular system does not raise here:
        # solve_ex leaves the inf/NaN of the zero pivot, as jnp.linalg.solve
        # does, and nan_to_num + clamp make it 0 or +-1.
        Hr = H + 1e-12 * torch.eye(3, dtype=H.dtype, device=dev)
        x, _ = torch.linalg.solve_ex(Hr, g[..., None])
        off = torch.clamp(torch.nan_to_num(-x[..., 0]), -1.0, 1.0)
        gs = 0.5 * (dn - dp)
        hss = dn - 2 * c0 + dp
        ds = torch.where(hss.abs() > 1e-20, -gs / hss, 0.0)
        ds = torch.clamp(torch.nan_to_num(ds), -1.0, 1.0)
    else:
        off = torch.zeros((K, 3), dtype=torch.float32, device=dev)
        ds = torch.zeros((K,), dtype=torch.float32, device=dev)
    return RefinementResult(off, ds, edge_ok)

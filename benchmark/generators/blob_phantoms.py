"""Blob phantoms: batches of volumes, or of registration pairs, from a seed.

A volume is a sum of Gaussian blobs, each the product of three 1-D
exponentials exp(-((i - c) / s)^2) with an amplitude of either sign: the
phantoms of the SIFT3D bench (sparse: 150 blobs, centres 0.08-0.92 n,
widths 0.01-0.06 n; dense: 2500 blobs, 0.04-0.96 n, 0.006-0.02 n). All
blobs of a volume are summed by one float32 product (TF32 off) of the
x exponentials, scaled by the amplitudes, with the outer products of the
y and z exponentials, on the device the volumes are served from.

With ``pairs`` set, each volume is the fixed volume of a pair, and its
moving volume is the fixed one resampled under a rotation about z of
``rot_deg`` degrees and a shift of up to ``shift_vox`` voxels an axis
(the registration bench's pair): moving(x) = fixed(A [x; 1]) by
trilinear interpolation, zero outside, so that A maps moving voxel
coordinates to fixed ones.

Every number is drawn from ``seed`` by one torch.Generator in a few large
calls, so a seed gives the same pool on a device and another seed a pool
of the same kind: the same counts, sizes and ranges, other draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _volumes(c, s, amp, n: int, chunk: int) -> torch.Tensor:
    """f32[V, n, n, n] from centres and widths f32[V, blobs, 3] and
    amplitudes f32[V, blobs] (voxel units)."""
    V, nb = amp.shape
    ax = torch.arange(n, dtype=torch.float32, device=amp.device)
    e = torch.exp(-(((ax - c[..., None]) / s[..., None]) ** 2))  # [V,b,3,n]
    out = torch.empty((V, n, n, n), dtype=torch.float32, device=amp.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for v in range(V):
            ex = (e[v, :, 0] * amp[v, :, None]).T.contiguous()    # [n, b]
            for y0 in range(0, n, chunk):
                yz = (e[v, :, 1, y0:y0 + chunk, None]
                      * e[v, :, 2, None, :]).reshape(nb, -1)
                out[v, :, y0:y0 + chunk] = (ex @ yz).reshape(n, -1, n)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def warp(vol: torch.Tensor, A: np.ndarray) -> torch.Tensor:
    """out[x] = vol(A [x; 1]) by trilinear interpolation, 0 where the
    source point lies outside [0, n - 1]."""
    dev = vol.device
    shape = tuple(vol.shape)
    Am = torch.as_tensor(np.asarray(A, np.float32), device=dev)
    x, y, z = (g.reshape(-1) for g in torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device=dev) for n in shape),
        indexing="ij"))
    src = torch.stack([x * Am[j, 0] + y * Am[j, 1] + z * Am[j, 2] + Am[j, 3]
                       for j in range(3)], dim=1)
    lo = torch.floor(src)
    fr = src - lo
    lo = lo.to(torch.int64)
    hi = [n - 1 for n in shape]
    out = torch.zeros(src.shape[0], dtype=torch.float32, device=dev)
    for ox in (0, 1):
        wx = fr[:, 0] if ox else 1 - fr[:, 0]
        ix = torch.clamp(lo[:, 0] + ox, 0, hi[0])
        for oy in (0, 1):
            wy = fr[:, 1] if oy else 1 - fr[:, 1]
            iy = torch.clamp(lo[:, 1] + oy, 0, hi[1])
            for oz in (0, 1):
                wz = fr[:, 2] if oz else 1 - fr[:, 2]
                iz = torch.clamp(lo[:, 2] + oz, 0, hi[2])
                out += wx * wy * wz * vol[ix, iy, iz]
    inside = ((src >= 0) & (src <= torch.tensor(
        hi, dtype=torch.float32, device=dev))).all(dim=1)
    return torch.where(inside, out, 0.0).reshape(shape)


def pair_affine(theta_deg: float, shift, n: int) -> np.ndarray:
    """f64[3, 4]: rotation by theta about z around the volume's centre, then
    the shift (moving -> fixed voxel coordinates)."""
    th = math.radians(theta_deg)
    Rz = np.array([[math.cos(th), -math.sin(th), 0.0],
                   [math.sin(th), math.cos(th), 0.0], [0.0, 0.0, 1.0]])
    c = np.full(3, (n - 1) / 2.0)
    A = np.zeros((3, 4))
    A[:, :3] = Rz
    A[:, 3] = c - Rz @ c + np.asarray(shift, np.float64)
    return A


def make(p: dict, seed: int, device) -> list[dict]:
    """The pool: p["pool"] batches of p["batch"] volumes (or pairs) of
    p["n"]^3, each a dict with "vols" f32[B, n, n, n], and for pairs
    "fixed", "moving" f32[P, n, n, n] and "affine" f64[P, 3, 4] (the true
    moving -> fixed map)."""
    n, B, P, nb = int(p["n"]), int(p["batch"]), int(p["pool"]), int(p["blobs"])
    V = B * P
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    c = uni(p["centre"][0] * n, p["centre"][1] * n, V, nb, 3)
    s = uni(p["width"][0] * n, p["width"][1] * n, V, nb, 3)
    amp = uni(p["amp"][0], p["amp"][1], V, nb)
    amp = amp * torch.where(torch.rand((V, nb), generator=gen, device=dev)
                            < 0.5, -1.0, 1.0)
    vols = _volumes(c, s, amp, n, int(p.get("chunk_y", 32)))
    pool = []
    if not p.get("pairs"):
        for b in range(P):
            pool.append({"vols": vols[b * B:(b + 1) * B]})
        return pool
    rot = uni(p["rot_deg"][0], p["rot_deg"][1], V).cpu().numpy()
    shift = uni(-p["shift_vox"], p["shift_vox"], V, 3).cpu().numpy()
    moving = torch.empty_like(vols)
    affine = np.zeros((V, 3, 4))
    for v in range(V):
        affine[v] = pair_affine(float(rot[v]), shift[v], n)
        moving[v] = warp(vols[v], affine[v])
    for b in range(P):
        sl = slice(b * B, (b + 1) * B)
        pool.append({"fixed": vols[sl], "moving": moving[sl],
                     "affine": affine[sl]})
    return pool

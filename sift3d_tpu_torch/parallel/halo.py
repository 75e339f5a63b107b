"""Halo exchange for z-sharded volumes.

Counterpart of sift3d_tpu/parallel/halo.py and of
sift3d_tpu/parallel/spatial.py:372 _z_extend. A z-sharded tensor is a list
of slabs, slab s on its own device holding rows [z0_s, z0_s + n_s) of the
last axis, in order. A banded z pass (``out[i] = sum_k Wd[i, k] *
in[i + lo + k]``) needs, beside a shard's own rows, the rows its band
reaches into the neighbouring shards: ``z_extend`` copies them over
(explicit device-to-device copies, peer to peer between cards; one
process drives every shard, see parallel/mesh.py), as many hops as the
halo needs, with zeros beyond the volume's ends, where every window and
band clips.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.blur_kernel import _diags, blur_yz_dog


def band_halo(W: np.ndarray) -> int:
    """Max reach of any row of W beyond its diagonal."""
    rows, cols = np.nonzero(np.asarray(W) != 0.0)
    if len(rows) == 0:
        return 0
    return int(np.max(np.abs(cols - rows)))


def diag_halo(wd: np.ndarray, lo: int) -> int:
    """band_halo of the banded operator (Wd [n, B], lo) of
    filters.conv_diagonals: the largest |lo + k| of a non-zero weight."""
    k = np.nonzero(np.any(np.asarray(wd) != 0.0, axis=0))[0]
    return int(np.max(np.abs(k + lo))) if len(k) else 0


def z_origins(shards) -> list[int]:
    """Global z of each slab's first row."""
    return [int(v) for v in np.cumsum([0] + [s.shape[-1] for s in shards])]


def z_rows(shards, lo: int, hi: int, device) -> torch.Tensor:
    """Global rows [lo, hi) of a z-sharded tensor on `device`, zeros
    outside [0, nz)."""
    org = z_origins(shards)
    nz = org[-1]
    lead = tuple(shards[0].shape[:-1])
    parts = []
    if lo < 0:
        parts.append(torch.zeros(lead + (min(hi, 0) - lo,),
                                 dtype=shards[0].dtype, device=device))
    for s, x in enumerate(shards):
        a, b = max(lo, org[s]), min(hi, org[s + 1])
        if a < b:
            parts.append(x[..., a - org[s]:b - org[s]]
                         .to(device, non_blocking=True))
    if hi > nz:
        parts.append(torch.zeros(lead + (hi - max(lo, nz),),
                                 dtype=shards[0].dtype, device=device))
    return parts[0].contiguous() if len(parts) == 1 else \
        torch.cat(parts, dim=-1)


def z_extend_one(shards, s: int, halo: int) -> torch.Tensor:
    """Slab s extended by `halo` rows of its neighbours on each side:
    [..., n_s + 2 * halo], on slab s's device."""
    org = z_origins(shards)
    return z_rows(shards, org[s] - halo, org[s + 1] + halo,
                  shards[s].device)


def z_extend(shards, halo: int) -> list[torch.Tensor]:
    """Every slab extended by `halo` rows on each side (the port of
    sift3d_tpu/parallel/spatial.py:372 _z_extend: multi-hop where the halo
    passes a shard, zeros beyond the volume)."""
    return [z_extend_one(shards, s, halo) for s in range(len(shards))]


def sharded_blur_z(tmps, plan, octave: int, level: int, curs, prevs=None,
                   dogs=None, dmaxs=None) -> None:
    """The y and z passes of the blur that makes `level` of `octave`
    (level 0: the first blur of octave 0) on a z-sharded volume whose
    slabs tmps (f32[nx, ny, n_s], the x pass of each shard's rows) lie on
    their devices: each slab takes a halo of the z band's reach and runs
    the y/z blur kernel, writing its own rows curs[s]; with prevs, also
    dogs[s] = prevs[s] - curs[s] and dmaxs[s] (f32[1], zero on entry) =
    their max |DoG|. The counterpart of sift3d_tpu/parallel/halo.py:38
    sharded_blur_z, with the port's y pass and DoG fused into the z
    pass's kernel. Equals the whole volume's passes bit for bit."""
    h = diag_halo(*plan.conv_diags(octave, plan.first_taps if level == 0
                                   else plan.level_taps[level])[2])
    org = z_origins(tmps)
    for s, ext in enumerate(z_extend(tmps, h)):
        # The band weights stay on each device (_diags caches them): a
        # copy from host memory would wait for the device.
        _, (wy, loy), (wz, loz) = _diags(plan, octave, level, tmps[s].device)
        blur_yz_dog(ext, wy, loy, wz[org[s]:org[s + 1]], loz, curs[s],
                    None if prevs is None else prevs[s],
                    None if dogs is None else dogs[s],
                    None if dmaxs is None else dmaxs[s], z_off=h)

"""Gaussian-pyramid octave builder: banded axis passes + DoG.

Replaces the TPU kernel ``sift3d_tpu/ops/blur_kernel.py:337 chain_octave``
(its ``_chain_kernel``/``_copy_kernel`` pallas_calls). One octave holds
``L = num_gpyr_levels`` levels. Level 0 is the first blur of the scaled
input (octave 0) or the downsampled source, unblurred (deeper octaves);
level i is level i-1 blurred by the incremental kernel, as three banded
axis passes in x, y, z order (apply_Sep_FIR_filter, imutil.c:1165-1188):
``out[i] = sum_k Wd[i, k] * in[i + lo + k]`` with the weights of
filters.conv_diagonals. Then ``dog[l] = gpyr[l] - gpyr[l + 1]`` (build_dog,
sift.c:713-732) and the per-level max |DoG|, the extrema threshold input
(sift.c:821-829).

CUDA kernels (csrc/blur.cu):
 - ``s3d_blur_axis_pass``: one thread per output voxel, the band summed in
   ascending k with separate round-to-nearest multiplies and adds, the
   order of the JAX reference (pyramid._diag_pass); out-of-range reads are
   skipped (their weight is zero). Launched 3 times per level.
 - ``s3d_dog_max``: ``prev - cur`` and a block max of |DoG| folded into
   the level's slot with an integer atomicMax on the float's bits (exact
   and order-free for non-negative floats).

Bound on the H100: device-memory bandwidth. A level costs three reads and
three writes of the volume for the passes plus two reads and a write for
the DoG (each pass reads its neighbors through L1/L2, coalesced along z).
Fusing the three passes and the DoG through shared-memory tiles, one read
and two writes per level, is later work.

On a CPU tensor every wrapper runs its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build

# Kernel launches on CUDA tensors, per kernel (chip_smoke.py reads them).
axis_pass_launches = 0
dog_launches = 0


def axis_pass_plain(vol: torch.Tensor, wd: torch.Tensor, lo: int,
                    axis: int) -> torch.Tensor:
    """Plain version of one axis pass: shifted multiply-adds, one band
    term at a time in ascending k, multiply then add (as
    sift3d_tpu/pyramid.py:182 _diag_pass)."""
    n = vol.shape[axis]
    band = wd.shape[1]
    pad_lo, pad_hi = max(0, -lo), max(0, lo + band - 1)
    v = F.pad(vol.movedim(axis, -1), (pad_lo, pad_hi))
    out = None
    for k in range(band):
        s = pad_lo + lo + k
        term = wd[:, k] * v[..., s:s + n]
        out = term if out is None else out + term
    return out.movedim(-1, axis).contiguous()


def axis_pass(src: torch.Tensor, wd: torch.Tensor, lo: int, axis: int,
              out: torch.Tensor) -> torch.Tensor:
    """out = one banded pass of src f32[nx, ny, nz] along `axis`, with
    band weights wd f32[n_axis, B]."""
    global axis_pass_launches
    if src.device.type == "cpu":
        return out.copy_(axis_pass_plain(src, wd, lo, axis))
    nx, ny, nz = src.shape
    _build.check_cuda("axis_pass src", src, torch.float32)
    _build.check_cuda("axis_pass out", out, torch.float32, src.shape)
    _build.check_cuda("axis_pass wd", wd, torch.float32,
                      (src.shape[axis], wd.shape[1]))
    _build.call("s3d_blur_axis_pass", src.data_ptr(), out.data_ptr(),
                wd.data_ptr(), wd.shape[1], lo, nx, ny, nz, axis,
                _build.stream_ptr(src))
    axis_pass_launches += 1
    return out


def dog_max_plain(prev: torch.Tensor, cur: torch.Tensor):
    dog = prev - cur
    return dog, dog.abs().max()


def dog_max(prev: torch.Tensor, cur: torch.Tensor, dog_out: torch.Tensor,
            dmax_out: torch.Tensor) -> None:
    """dog_out = prev - cur; dmax_out (f32[1], zero on entry) = max |DoG|."""
    global dog_launches
    if prev.device.type == "cpu":
        dog, m = dog_max_plain(prev, cur)
        dog_out.copy_(dog)
        dmax_out.copy_(m.reshape(1))
        return
    for name, t in (("prev", prev), ("cur", cur), ("dog", dog_out)):
        _build.check_cuda(f"dog_max {name}", t, torch.float32, prev.shape)
    _build.check_cuda("dog_max dmax", dmax_out, torch.float32, (1,))
    _build.call("s3d_dog_max", prev.data_ptr(), cur.data_ptr(),
                dog_out.data_ptr(), dmax_out.data_ptr(), prev.numel(),
                _build.stream_ptr(prev))
    dog_launches += 1


@functools.lru_cache(maxsize=256)
def _diags(plan, octave: int, level: int, device: torch.device):
    """Band weights of the blur that makes `level` of `octave` (level 0:
    the first blur of octave 0), as tensors on `device`."""
    taps = plan.first_taps if level == 0 else plan.level_taps[level]
    return tuple((torch.from_numpy(wd).to(device), lo)
                 for wd, lo in plan.conv_diags(octave, taps))


def blur(vol: torch.Tensor, diags, out: torch.Tensor,
         tmp: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """out = the separable banded blur of vol, x then y then z."""
    (wx, lox), (wy, loy), (wz, loz) = diags
    axis_pass(vol, wx, lox, 0, tmp[0])
    axis_pass(tmp[0], wy, loy, 1, tmp[1])
    return axis_pass(tmp[1], wz, loz, 2, out)


def chain_octave(src: torch.Tensor, plan, octave: int):
    """(gpyr f32[L, nx, ny, nz], dog f32[L-1, nx, ny, nz], dogmax f32[L-1])
    of one octave. src is the [-1, 1]-scaled input (octave 0, blurred
    sigma_n -> first level) or the downsampled previous-octave level
    (copied in unblurred)."""
    L = plan.num_gpyr_levels
    dims = plan.octave_dims[octave]
    if tuple(src.shape) != tuple(dims):
        raise ValueError(f"chain_octave: source shape {tuple(src.shape)} "
                         f"!= octave dims {dims}")
    dev = src.device
    gpyr = torch.empty((L,) + tuple(dims), dtype=torch.float32, device=dev)
    dog = torch.empty((L - 1,) + tuple(dims), dtype=torch.float32,
                      device=dev)
    dogmax = torch.zeros(L - 1, dtype=torch.float32, device=dev)
    tmp = (torch.empty_like(gpyr[0]), torch.empty_like(gpyr[0]))
    if octave == 0:
        blur(src.contiguous(), _diags(plan, 0, 0, dev), gpyr[0], tmp)
    else:
        gpyr[0].copy_(src)
    for i in range(1, L):
        blur(gpyr[i - 1], _diags(plan, octave, i, dev), gpyr[i], tmp)
        dog_max(gpyr[i - 1], gpyr[i], dog[i - 1], dogmax[i - 1:i])
    return gpyr, dog, dogmax

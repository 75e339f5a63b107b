"""Gaussian-pyramid octave builder: banded x, y, z passes + DoG.

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

A batch of B same-shape volumes goes through every level together:
``chain_octave`` of f32[B, nx, ny, nz] gives gpyr f32[B, L, nx, ny, nz],
dog f32[B, L-1, nx, ny, nz] and dogmax f32[B, L-1] (one max per volume),
with the same two launches per level as one volume; a volume alone,
f32[nx, ny, nz], gives the unbatched shapes.

CUDA kernels (csrc/blur.cu), two launches per level:
 - ``s3d_blur_x``: the x pass. A block owns a tile of 256 (y, z) columns
   and ``tx`` rows of x; the ``tx + Bx - 1`` input rows it needs reach
   shared memory by cp.async.
 - ``s3d_blur_yz_dog``: a ``ty x tz`` tile of ``xs`` consecutive x-planes
   of the x output, with its y and z halo, in shared memory; the y pass
   into shared memory (transposed), the z pass, then the level, ``prev -
   cur`` and the block's max |DoG| folded into the level's slot with an
   integer atomicMax on the float's bits (exact and order-free for
   non-negative floats). The first level of octave 0 runs it without the
   DoG.
Both take the batch as a grid axis (the x pass's band would mix volumes
stacked along x), each tensor's volume b at its base plus b times its
batch stride, so a level of the batched pyramid is passed in place.
Each thread of a pass holds four outputs along the band, so a value read
from shared memory serves four taps, against one float4 of skewed weights;
each band term is still a separate round-to-nearest multiply and add, k
ascending, the order of the JAX reference (pyramid._diag_pass), so the
kernels equal the plain versions bit for bit (for finite inputs: a skewed
weight of zero adds a zero product). ``x_tile`` and ``yz_tile`` pick the
tiles from the bands and the dims.

Bound on the H100: device-memory bandwidth. The x pass reads and writes
the volume once, the y/z pass reads two volumes and writes two: 6 volumes
per level, where one kernel per level could move 3 (read the previous
level, write the level and the DoG), but its x halo does not fit in shared
memory at the widest bands (34 taps at 0.5 mm voxels).

A z-sharded pyramid (parallel/spatial.py) runs the x pass on each
shard's own rows and the y/z pass on the x output extended by halo rows
of the neighbouring shards: ``blur_yz_dog(..., z_off=h)`` reads the slab,
applies the z weights of the output rows' global indices (so the
boundary rule acts only at the volume's ends) and writes, and counts in
max |DoG|, only the shard's own rows; with a halo at least the band's
reach that is the whole-volume launch's result, bit for bit.

On a CPU tensor every wrapper runs its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import profiling
from . import _build

X_WIDTH = 256            # csrc/blur.cu kXWidth: (y, z) columns of an x tile
BLOCK = 4                # csrc/blur.cu kBlock: tiles are multiples of it
SMEM_TARGET = 64 * 1024  # tiles shrink until they fit (occupancy)
SMEM_MAX = 227 * 1024    # the most a block may use on the H100
SMS = 132                # the H100's streaming multiprocessors


def axis_pass_plain(vol: torch.Tensor, wd: torch.Tensor, lo: int,
                    axis: int, off: int = 0) -> torch.Tensor:
    """Plain version of one axis pass: shifted multiply-adds, one band
    term at a time in ascending k, multiply then add (as
    sift3d_tpu/pyramid.py:182 _diag_pass). Output i = sum_k wd[i, k] *
    vol[i + off + lo + k] for the wd.shape[0] rows of wd, zero outside vol
    (off > 0: a slab whose output rows start at row off)."""
    N, n = vol.shape[axis], wd.shape[0]
    band = wd.shape[1]
    pad_lo = max(0, -(off + lo))
    pad_hi = max(0, n + off + lo + band - 1 - N)
    v = F.pad(vol.movedim(axis, -1), (pad_lo, pad_hi))
    out = None
    for k in range(band):
        s = pad_lo + off + lo + k
        term = wd[:, k] * v[..., s:s + n]
        out = term if out is None else out + term
    return out.movedim(-1, axis).contiguous()


def dog_max_plain(prev: torch.Tensor, cur: torch.Tensor):
    """(prev - cur, its max |.| per volume: a scalar for one volume
    [nx, ny, nz], f32[B] for a batch)."""
    dog = prev - cur
    return dog, dog.abs().flatten(-3).amax(dim=-1)


def x_smem_bytes(tx: int, bx: int) -> int:
    """Shared memory of an x tile: its skewed weight rows and its input
    rows."""
    return 4 * ((bx + BLOCK - 1) * tx + (tx + bx - 1) * X_WIDTH)


def yz_smem_bytes(ty: int, tz: int, by: int, bz: int) -> int:
    """Shared memory of a y/z tile: the skewed y and z weight rows, the
    z pass, the y pass, the haloed x output."""
    ca = tz + bz - 1
    return 4 * ((by + BLOCK - 1) * ty + (bz + BLOCK - 1) * tz
                + ty * (tz + 4) + _round_up(ca * (ty + 1), 4)
                + (ty + by - 1) * _round_up(ca + 3, 4))


def _halve_to_fit(size: int, smem) -> int:
    """The largest of size, size / 2, ... (multiples of BLOCK) whose
    tile fits in SMEM_TARGET bytes; refused if BLOCK rows exceed
    SMEM_MAX."""
    while size > BLOCK and smem(size) > SMEM_TARGET:
        size = max(BLOCK, size // 2 // BLOCK * BLOCK)
    if smem(size) > SMEM_MAX:
        raise ValueError(f"blur band too wide for shared memory: "
                         f"{smem(size)} bytes at a tile of {size}")
    return size


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=None)
def x_tile(nx: int, bx: int) -> tuple[int, int]:
    """(tx, shared-memory bytes) of the x pass over nx rows with band Bx:
    16 rows (fewer for a short axis, a multiple of 4), halved until the
    tile fits in 64 KB, so several blocks share an SM. A band so wide
    that 4 rows exceed the 227 KB a block may use is refused."""
    tx = _halve_to_fit(min(16, _round_up(nx, BLOCK)),
                       lambda t: x_smem_bytes(t, bx))
    return tx, x_smem_bytes(tx, bx)


@functools.lru_cache(maxsize=None)
def yz_tile(nx: int, ny: int, nz: int, by: int, bz: int,
            nb: int = 1) -> tuple[int, int, int, int]:
    """(ty, tz, xs, shared-memory bytes) of the y/z pass with bands
    (By, Bz) over nb volumes: tz is 64 (32 where nz <= 32, a warp's
    width), ty 32 rows (fewer for a short axis, a multiple of 4), halved
    until the tile fits in 64 KB; refused as x_tile. A block takes xs = 4
    x-planes (fewer where the grid would leave SMs idle), staging the
    weights once."""
    tz = 64 if nz > 32 else 32
    ty = _halve_to_fit(min(32, _round_up(ny, BLOCK)),
                       lambda t: yz_smem_bytes(t, tz, by, bz))
    tiles = -(-ny // ty) * -(-nz // tz) * nb
    xs = 4
    while xs > 1 and tiles * -(-nx // xs) < 2 * SMS:
        xs //= 2
    return ty, tz, xs, yz_smem_bytes(ty, tz, by, bz)


def _check_dims(name: str, shape) -> None:
    """Grid limits (x-planes and y tiles) and 32-bit offsets in a plane."""
    nx, ny, nz = shape
    if max(nx, ny) > 65535 or ny * nz >= 2 ** 31:
        raise ValueError(f"{name}: volume too large {tuple(shape)}")


def _batch(name: str, t: torch.Tensor, dims, nb: int | None = None):
    """(B, batch stride in elements) of a CUDA f32 tensor holding one
    volume [nx, ny, nz] (B = 1) or a batch [B, nx, ny, nz] whose volumes
    are each contiguous; the batch stride is free (a level of a [B, L, ...]
    pyramid). Raises for anything else, or for B other than nb."""
    shape, stride = t.shape, t.stride()
    _, ny, nz = dims
    if (not t.is_cuda or t.dtype != torch.float32
            or len(shape) not in (3, 4) or shape[-3:] != dims
            or stride[-3:] != (ny * nz, nz, 1)):
        raise ValueError(f"{name}: expected a CUDA float32 tensor of "
                         f"contiguous volumes of {dims}, got {t.dtype} "
                         f"{tuple(shape)} strides {stride} on {t.device}")
    b, bs = (1, 0) if len(shape) == 3 else (shape[0], stride[0])
    if nb is not None and b != nb:
        raise ValueError(f"{name}: batch of {b}, expected {nb}")
    return b, bs


def blur_x_plain(src: torch.Tensor, wx: torch.Tensor, lo: int):
    return axis_pass_plain(src, wx, lo, src.ndim - 3)


def blur_x(src: torch.Tensor, wx: torch.Tensor, lo: int,
           out: torch.Tensor) -> torch.Tensor:
    """out = the banded x pass of src, f32[nx, ny, nz] or a batch
    f32[B, nx, ny, nz] (each volume contiguous), band weights
    wx f32[nx, Bx]."""
    if src.device.type == "cpu":
        return out.copy_(blur_x_plain(src, wx, lo))
    nx, ny, nz = dims = tuple(src.shape[-3:])
    nb, src_bs = _batch("blur_x src", src, dims)
    _, out_bs = _batch("blur_x out", out, dims, nb)
    _build.check_cuda("blur_x wx", wx, torch.float32, (nx, wx.shape[1]))
    _check_dims("blur_x", dims)
    tx, smem = x_tile(nx, wx.shape[1])
    _build.call("s3d_blur_x", src.data_ptr(), out.data_ptr(), wx.data_ptr(),
                wx.shape[1], lo, nb, src_bs, out_bs, nx, ny, nz, tx, smem,
                _build.stream_ptr(src))
    return out


def blur_yz_dog_plain(src: torch.Tensor, wy: torch.Tensor, loy: int,
                      wz: torch.Tensor, loz: int, prev=None, z_off: int = 0):
    """(cur, dog, max |dog| per volume): the y and z passes of src, then
    the DoG against prev; dog and max are None without prev. src may be a
    slab whose wz.shape[0] output rows start at row z_off."""
    a = src.ndim - 3
    cur = axis_pass_plain(axis_pass_plain(src, wy, loy, a + 1), wz, loz,
                          a + 2, z_off)
    if prev is None:
        return cur, None, None
    return (cur,) + dog_max_plain(prev, cur)


def blur_yz_dog(src: torch.Tensor, wy: torch.Tensor, loy: int,
                wz: torch.Tensor, loz: int, cur: torch.Tensor,
                prev: torch.Tensor | None = None,
                dog: torch.Tensor | None = None,
                dmax: torch.Tensor | None = None,
                z_off: int = 0) -> torch.Tensor:
    """cur = the y then z passes of src (the x output), f32[nx, ny, nz] or
    a batch f32[B, nx, ny, nz] (each volume contiguous), band weights
    wy f32[ny, By], wz f32[nz, Bz]. With prev: dog = prev - cur and dmax
    (f32[1] for one volume, f32[B] of any stride for a batch, zero on
    entry) = max |dog| per volume. A z-slab src f32[..., nx, ny, nzs]
    holds cur's nz rows from row z_off and their halo; wz then holds the
    weights of cur's rows (their global indices)."""
    if src.device.type == "cpu":
        c, d, m = blur_yz_dog_plain(src, wy, loy, wz, loz, prev, z_off)
        cur.copy_(c)
        if prev is not None:
            dog.copy_(d)
            dmax.copy_(m.reshape(dmax.shape))
        return cur
    dims = tuple(cur.shape[-3:])
    nx, ny, nz = dims
    nzs = src.shape[-1]
    if z_off < 0 or z_off + nz > nzs:
        raise ValueError(f"blur_yz_dog: rows [{z_off}, {z_off + nz}) "
                         f"outside a slab of {nzs}")
    nb, src_bs = _batch("blur_yz_dog src", src, (nx, ny, nzs))
    _, cur_bs = _batch("blur_yz_dog cur", cur, dims, nb)
    _build.check_cuda("blur_yz_dog wy", wy, torch.float32, (ny, wy.shape[1]))
    _build.check_cuda("blur_yz_dog wz", wz, torch.float32, (nz, wz.shape[1]))
    if len({prev is None, dog is None, dmax is None}) != 1:
        raise ValueError("blur_yz_dog: prev, dog and dmax go together")
    prev_bs = dog_bs = dmax_bs = 0
    if prev is not None:
        _, prev_bs = _batch("blur_yz_dog prev", prev, dims, nb)
        _, dog_bs = _batch("blur_yz_dog dog", dog, dims, nb)
        if not dmax.is_cuda or dmax.dtype != torch.float32 \
                or tuple(dmax.shape) != (nb,):
            raise ValueError(f"blur_yz_dog dmax: expected CUDA f32[{nb}]")
        dmax_bs = dmax.stride(0)
    _check_dims("blur_yz_dog", dims)
    _check_dims("blur_yz_dog src", (nx, ny, nzs))
    ty, tz, xs, smem = yz_tile(nx, ny, nz, wy.shape[1], wz.shape[1], nb)
    if nb * -(-nx // xs) > 65535:
        raise ValueError(f"blur_yz_dog: batch of {nb} too large for the grid")
    ptr = (lambda t: None if t is None else t.data_ptr())
    _build.call("s3d_blur_yz_dog", src.data_ptr(), ptr(prev), cur.data_ptr(),
                ptr(dog), ptr(dmax), wy.data_ptr(), wy.shape[1], loy,
                wz.data_ptr(), wz.shape[1], loz, nb, src_bs, prev_bs, cur_bs,
                dog_bs, dmax_bs, nx, ny, nz, nzs, int(z_off), ty, tz, xs, smem,
                _build.stream_ptr(src))
    return cur


@functools.lru_cache(maxsize=256)
def _diags(plan, octave: int, level: int, device: torch.device):
    """Band weights of the blur that makes `level` of `octave` (level 0:
    the first blur of octave 0), as tensors on `device`:
    ((wx, lox), (wy, loy), (wz, loz))."""
    taps = plan.first_taps if level == 0 else plan.level_taps[level]
    return tuple((profiling.to_device(wd, None, device), lo)
                 for wd, lo in plan.conv_diags(octave, taps))


def blur_level(src: torch.Tensor, diags, tmp: torch.Tensor,
               cur: torch.Tensor, dog=None, dmax=None) -> torch.Tensor:
    """cur = the separable banded blur of src, x then y then z, through
    tmp (the x output); with dog and dmax, also the DoG src - cur and its
    max."""
    (wx, lox), (wy, loy), (wz, loz) = diags
    blur_x(src, wx, lox, tmp)
    return blur_yz_dog(tmp, wy, loy, wz, loz, cur,
                       None if dog is None else src, dog, dmax)


def chain_octave(src: torch.Tensor, plan, octave: int,
                 gpyr: torch.Tensor | None = None):
    """(gpyr f32[B, L, nx, ny, nz], dog f32[B, L-1, nx, ny, nz],
    dogmax f32[B, L-1]) of one octave of a batch src f32[B, nx, ny, nz];
    for one volume src f32[nx, ny, nz], the same without the batch axis.
    src is the [-1, 1]-scaled input (octave 0, blurred sigma_n -> first
    level) or the downsampled previous-octave level (copied in unblurred).
    gpyr, where given, is the contiguous f32[B, L, nx, ny, nz] buffer the
    levels are written into."""
    L = plan.num_gpyr_levels
    dims = tuple(plan.octave_dims[octave])
    if tuple(src.shape[-3:]) != dims or src.ndim not in (3, 4):
        raise ValueError(f"chain_octave: source shape {tuple(src.shape)} "
                         f"!= octave dims {dims}")
    one = src.ndim == 3
    src = src[None] if one else src
    B = src.shape[0]
    dev = src.device
    if gpyr is None:
        gpyr = torch.empty((B, L) + dims, dtype=torch.float32, device=dev)
    elif tuple(gpyr.shape) != (B, L) + dims or not gpyr.is_contiguous():
        raise ValueError(f"chain_octave: pyramid buffer "
                         f"{tuple(gpyr.shape)} != {(B, L) + dims}")
    dog = torch.empty((B, L - 1) + dims, dtype=torch.float32, device=dev)
    dogmax = torch.zeros((B, L - 1), dtype=torch.float32, device=dev)
    tmp = torch.empty((B,) + dims, dtype=torch.float32, device=dev)
    # Each level's [B, ...] views, made at once.
    levels, dogs, dmaxs = gpyr.unbind(1), dog.unbind(1), dogmax.unbind(1)
    if octave == 0:
        blur_level(src.contiguous(), _diags(plan, 0, 0, dev), tmp,
                   levels[0])
    else:
        levels[0].copy_(src)
    for i in range(1, L):
        blur_level(levels[i - 1], _diags(plan, octave, i, dev), tmp,
                   levels[i], dogs[i - 1], dmaxs[i - 1])
    if one:
        return gpyr[0], dog[0], dogmax[0]
    return gpyr, dog, dogmax

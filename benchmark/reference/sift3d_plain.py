"""Plain reference of SIFT3D detection, description and registration.

A frozen, self-contained copy of the plain PyTorch versions that the
SIFT3D port keeps beside its CUDA kernels, written out again so that the
benchmark's yardstick cannot move with the program: the reference's
scale space (the separable FIR filter with its unit-scaled, mirrored and
interpolated taps, imutil.c:742-861 and 1267-1343; build_gpyr and
build_dog, sift.c:662-732), the DoG extrema stencil (sift.c:735-871), the
orientation by window moments and a 3x3 Jacobi eigensolver
(sift.c:926-1167), the icosahedral descriptor (sift.c:1254-1536), and
SIFT3D registration (Lowe's ratio match, 4-point RANSAC with a weighted
refit). It imports nothing of the program and takes nothing the program
made: every plan, band, window and table is worked out here from the
configuration and the input volume.

Precision. Everything runs in float32 with TF32 off (``prec="f32"``).
``prec="tf32"`` is the control: the operands of every product that a
tensor core would take (the blur's band terms, the orientation moments,
the descriptor's face test and histogram contraction, the match and the
RANSAC products) are rounded to TF32's 10-bit mantissa first, the step
below float32 that a later change would be tempted to take. The rounding
is done explicitly, so the control computes the same on any device.

The pyramid and the extrema stencil repeat the plain versions' arithmetic
operation for operation (multiply then add, one band term at a time), so
their candidates and strengths are exact; the moment and histogram sums
run in an order of their own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

DESC_NUMEL = 768
NB = 4            # spatial bins per axis of the descriptor
NVERT = 12        # icosahedron vertices (histogram bins)
NFACES = 20
# A candidate whose orientation tests (eigenvalue ratio, corner score)
# land within this of their thresholds may fall either way: the moment
# sums of any two implementations differ in the last bits.
VERDICT_MARGIN = 1e-3
_DBL_EPSILON = 2.220446049250313e-16
_CONV_EPS = np.float32(0.1)
_SQRT2 = math.sqrt(2.0)
_BIG = float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def rounder(prec: str):
    if prec == "f32":
        return lambda x: x
    if prec == "tf32":
        return tf32
    raise ValueError(f"unknown precision {prec!r}")


@contextlib.contextmanager
def full_f32():
    """Full-f32 matrix products (no TF32 inside cuBLAS) in the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def true_div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s rounded once (a tensor divisor: CUDA divides by a Python
    scalar as a multiply by its reciprocal)."""
    return a / torch.full_like(a, float(s))


# ---------------------------------------------------------------------------
# Parameters and the scale-space plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Params:
    """kpSift3D's defaults (sift.c:31-45, 499-565; imutil.c:1264)."""
    peak_thresh: float = 0.1
    corner_thresh: float = 0.4
    num_kp_levels: int = 3
    sigma_n: float = 1.15
    sigma0: float = 1.6
    cuboid_extrema: bool = False
    gauss_width_fctr: float = 3.0
    max_eig_ratio: float = 0.90
    ori_grad_thresh: float = 1e-10
    bary_eps: float = 1.1920928955078125e-07 * 1e1
    ori_sig_fctr: float = 1.5
    ori_rad_fctr: float = 3.0
    desc_sig_fctr: float = 7.071067812
    desc_rad_fctr: float = 2.0
    trunc_thresh: float = 0.2 * 128.0 / DESC_NUMEL

    @classmethod
    def from_config(cls, d: dict) -> "Params":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def gauss_kernel(sigma: float, width_fctr: float) -> np.ndarray:
    """init_Gauss_filter (imutil.c:1267-1319)."""
    hw = max(int(math.ceil(sigma * width_fctr)), 1) if sigma > 0 else 1
    k = np.empty(2 * hw + 1, np.float32)
    for i in range(2 * hw + 1):
        x = (float(i) - hw) / (sigma + _DBL_EPSILON)
        k[i] = np.float32(math.exp(-0.5 * x * x))
    acc = np.float32(0.0)
    for v in k:
        acc = np.float32(acc + v)
    return k / acc


def conv_band(n: int, taps: np.ndarray, uf: float):
    """(Wd f32[n, B], lo): one convolve_sep_gen pass along an axis of n
    samples (imutil.c:742-861) as out[i] = sum_k Wd[i, k] in[i + lo + k]:
    taps at d * unit_factor, mirrored with C truncation and the 0.1
    upper-edge fudge, sampled by linear interpolation."""
    hw = len(taps) // 2
    uf = np.float32(uf)
    end = n - 1
    W = np.zeros((n, n), np.float64)
    xs = np.arange(n, dtype=np.float32)
    for d in range(-hw, hw + 1):
        pos = xs - np.float32(np.float32(d) * uf)
        ip = np.trunc(pos).astype(np.int64)
        low = ip < 0
        high = ~low & (ip >= end)
        pos = np.where(low, -pos, pos)
        pos = np.where(high, np.float32(2.0 * end) - pos - _CONV_EPS, pos)
        i0 = np.trunc(pos).astype(np.int64)
        fr = (pos - i0.astype(np.float32)).astype(np.float64)
        tap = float(taps[d + hw])
        np.add.at(W, (np.arange(n), np.clip(i0, 0, end)), tap * (1.0 - fr))
        np.add.at(W, (np.arange(n), np.clip(i0 + 1, 0, end)), tap * fr)
    W = W.astype(np.float32)
    rows, cols = np.nonzero(W)
    if rows.size == 0:
        return np.zeros((n, 1), np.float32), 0
    off = cols - rows
    lo = int(off.min())
    Wd = np.zeros((n, int(off.max()) - lo + 1), np.float32)
    Wd[rows, off - lo] = W[rows, cols]
    return Wd, lo


@dataclasses.dataclass
class Plan:
    """The scale space of one volume shape (sift.c:434-454, 662-711)."""
    dims: tuple
    units: tuple
    params: Params
    octave_dims: list
    scales: list          # scales[o][i], stacked level i = raw level i - 1
    bands: dict           # (octave, level) -> per axis (Wd, lo)

    @property
    def levels(self) -> int:          # Gaussian levels an octave
        return self.params.num_kp_levels + 3

    def level_units(self, o: int):
        return tuple(u * 2.0 ** o for u in self.units)


def make_plan(dims, units, params: Params) -> Plan:
    dims = tuple(int(d) for d in dims)
    units = tuple(float(u) for u in units)
    nl = params.num_kp_levels
    n_oct = int(math.log2(float(min(dims)))) - 3 + 1
    if n_oct < 1:
        raise ValueError(f"volume too small: {dims}")
    odims = [dims]
    for _ in range(1, n_oct):
        odims.append(tuple(d // 2 for d in odims[-1]))
    L = nl + 3
    scales = [[params.sigma0 * 2.0 ** (o + (i - 1) / nl) for i in range(L)]
              for o in range(n_oct)]
    wf = params.gauss_width_fctr

    def inc(s0, s1):          # init_Gauss_incremental_filter
        return math.sqrt(s1 * s1 - s0 * s0)
    taps = [gauss_kernel(inc(params.sigma_n, scales[0][0]), wf)]
    for i in range(1, L):
        taps.append(gauss_kernel(inc(scales[0][i - 1], scales[0][i]), wf))
    bands = {}
    for o in range(n_oct):
        lu = tuple(u * 2.0 ** o for u in units)
        for i in range(L):
            if o > 0 and i == 0:
                continue      # level 0 of a deeper octave is not blurred
            bands[o, i] = [conv_band(odims[o][a], taps[i], 1.0 / lu[a])
                           for a in range(3)]
    return Plan(dims, units, params, odims, scales, bands)


# ---------------------------------------------------------------------------
# Pyramid and extrema
# ---------------------------------------------------------------------------


def axis_pass(vol, wd, lo: int, axis: int, rnd):
    """out[i] = sum_k wd[i, k] * vol[i + lo + k] along `axis`, one band term
    at a time in ascending k, multiply then add; zero outside vol."""
    n, band = wd.shape
    pad_lo = max(0, -lo)
    pad_hi = max(0, n + lo + band - 1 - vol.shape[axis])
    v = rnd(F.pad(vol.movedim(axis, -1), (pad_lo, pad_hi)))
    wd = rnd(wd)
    out = None
    for k in range(band):
        s = pad_lo + lo + k
        term = wd[:, k] * v[..., s:s + n]
        out = term if out is None else out + term
    return out.movedim(-1, axis).contiguous()


def blur(vol, band, rnd):
    dev = vol.device
    for a, (wd, lo) in enumerate(band):
        vol = axis_pass(vol, torch.from_numpy(wd).to(dev), lo, a, rnd)
    return vol


def pyramid(vol: torch.Tensor, plan: Plan, rnd):
    """(gpyr, dog, dogmax) per octave of one f32[nx, ny, nz] volume: the
    volume scaled to [-1, 1] by its max |.|, then per octave L Gaussian
    levels f32[L, ...], L-1 DoG levels and each DoG level's max |.|."""
    m = vol.abs().amax()
    x = torch.where(m == 0.0, vol, vol / m)
    L = plan.levels
    gp, dg, dm = [], [], []
    for o in range(len(plan.octave_dims)):
        if o == 0:
            lev = [blur(x, plan.bands[0, 0], rnd)]
        else:
            src = gp[o - 1][L - 3]
            nx, ny, nz = plan.octave_dims[o]
            lev = [src[:2 * nx:2, :2 * ny:2, :2 * nz:2].contiguous()]
        for i in range(1, L):
            lev.append(blur(lev[-1], plan.bands[o, i], rnd))
        g = torch.stack(lev)
        d = g[:-1] - g[1:]
        gp.append(g)
        dg.append(d)
        dm.append(d.abs().flatten(1).amax(dim=1))
    return gp, dg, dm


_FACE = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, -1),
         (0, 0, 1)]
_CUBE = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
         for dx in (-1, 0, 1)]


def extrema(dog: torch.Tensor, dogmax: torch.Tensor, params: Params):
    """(coords i64[N, 3], level i64[N], strength f32[N]) of one octave's
    candidates in scan order (level, z, y, x): interior voxels past the
    level's relative threshold, strictly above or below every compared
    neighbor (detect_extrema, sift.c:735-871)."""
    Ld, nx, ny, nz = dog.shape
    nl = Ld - 2
    thr = torch.tensor(params.peak_thresh, dtype=torch.float32,
                       device=dog.device) * dogmax[1:Ld - 1]

    def sh(a, dx, dy, dz):
        return a[:, 1 + dx:nx - 1 + dx, 1 + dy:ny - 1 + dy,
                 1 + dz:nz - 1 + dz]
    cur, prev, nxt = dog[1:Ld - 1], dog[:Ld - 2], dog[2:]
    c = sh(cur, 0, 0, 0)
    if params.cuboid_extrema:
        nbrs = ([sh(cur, *o) for o in _CUBE if o != (0, 0, 0)]
                + [sh(prev, *o) for o in _CUBE] + [sh(nxt, *o) for o in _CUBE])
    else:
        nbrs = [sh(cur, *o) for o in _FACE] + [sh(prev, 0, 0, 0),
                                                sh(nxt, 0, 0, 0)]
    is_max = torch.ones_like(c, dtype=torch.bool)
    is_min = torch.ones_like(c, dtype=torch.bool)
    for nb in nbrs:
        is_max &= c > nb
        is_min &= c < nb
    t = thr.reshape(nl, 1, 1, 1)
    hit = ((c > t) | (c < -t)) & (is_max | is_min)
    lvl, x, y, z = torch.nonzero(hit, as_tuple=True)
    x, y, z = x + 1, y + 1, z + 1
    key = torch.sort(((lvl * nz + z) * ny + y) * nx + x).values
    x, r = key % nx, key // nx
    y, r = r % ny, r // ny
    z, lvl = r % nz, r // nz
    strength = dog[1 + lvl, x, y, z].abs()
    return torch.stack([x, y, z], dim=1), lvl, strength


def candidates(vol: torch.Tensor, plan: Plan) -> list:
    """Each octave's candidates (coords i64[N, 3], level i64[N]) as numpy
    arrays: the pyramid and the stencil alone."""
    with full_f32():
        _, dg, dm = pyramid(vol.to(torch.float32), plan, rounder("f32"))
        out = []
        for o in range(len(dg)):
            c, lvl, _ = extrema(dg[o], dm[o], plan.params)
            out.append((c.cpu().numpy(), lvl.cpu().numpy()))
    return out


# ---------------------------------------------------------------------------
# Windows, orientation
# ---------------------------------------------------------------------------


def window_extent(radius_vox: float, n: int, margin: int = 0) -> int:
    return min(2 * math.ceil(radius_vox) + 3 + margin, n)


def gather(levels, lvl, coords, extents):
    """Windows f32[K, Gx, Gy, Gz] of levels[lvl[k]] around coords[k],
    shifted inside the level near its edges, and their origins."""
    dims = levels.shape[1:]
    start = torch.stack([torch.clamp(coords[:, a] - (extents[a] - 1) // 2, 0,
                                     dims[a] - extents[a])
                         for a in range(3)], dim=1)
    dev = levels.device
    ix, iy, iz = (start[:, a, None] + torch.arange(extents[a], device=dev)
                  for a in range(3))
    win = levels[lvl[:, None, None, None], ix[:, :, None, None],
                 iy[:, None, :, None], iz[:, None, None, :]]
    return win, start


def _grad(win, inv):
    return (0.5 * (win[:, 2:, 1:-1, 1:-1] - win[:, :-2, 1:-1, 1:-1]) * inv[0],
            0.5 * (win[:, 1:-1, 2:, 1:-1] - win[:, 1:-1, :-2, 1:-1]) * inv[1],
            0.5 * (win[:, 1:-1, 1:-1, 2:] - win[:, 1:-1, 1:-1, :-2]) * inv[2])


def _sphere(start, center, rad, units, extents, dims):
    """Mask of the loop-bound box's voxels inside the sphere |d| <= rad
    (IM_LOOP_SPHERE_START, sift.c:86-109), the offsets d per axis (real
    units) and |d|^2, for windows of the given origins."""
    K = center.shape[0]
    dev = center.device
    mask = torch.ones((K,) + tuple(e - 2 for e in extents), dtype=torch.bool,
                      device=dev)
    sq = torch.zeros(mask.shape, dtype=torch.float32, device=dev)
    d3 = []
    for a in range(3):
        shape = [K, 1, 1, 1]
        shape[1 + a] = extents[a] - 2
        idx = (start[:, a, None] + 1 + torch.arange(extents[a] - 2,
                                                    device=dev)).reshape(shape)
        c = center[:, a]
        ra = true_div(rad, units[a])
        lo = torch.clamp(torch.floor(c - ra), min=1.0)
        hi = torch.clamp(torch.ceil(c + ra), max=float(dims[a] - 2))
        mask &= ((idx >= lo.long().reshape(K, 1, 1, 1))
                 & (idx <= hi.long().reshape(K, 1, 1, 1)))
        d = (idx.float() - c.reshape(K, 1, 1, 1)) * units[a]
        d3.append(d)
        sq = sq + d * d
    mask &= sq <= (rad * rad).reshape(K, 1, 1, 1)
    return mask, d3, sq


def eigh3x3(A: torch.Tensor):
    """Symmetric 3x3 eigendecomposition by 6 cyclic Jacobi sweeps:
    eigenvalues ascending, eigenvectors in columns."""
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    V = [[torch.full_like(A[..., 0, 0], float(i == j)) for j in range(3)]
         for i in range(3)]
    one = torch.ones_like(A[..., 0, 0])
    zero = torch.zeros_like(one)
    for _ in range(6):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            app, aqq, apq = a[p][p], a[q][q], a[p][q]
            safe = apq.abs() > 0.0
            tau = (aqq - app) / torch.where(safe, 2.0 * apq, one)
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tau == 0.0, one, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = torch.where(safe, t * c, zero)
            c = torch.where(safe, c, one)
            new = [row[:] for row in a]
            for k in range(3):
                akp, akq = a[k][p], a[k][q]
                new[k][p] = c * akp - s * akq
                new[k][q] = s * akp + c * akq
            rows = [row[:] for row in new]
            for k in range(3):
                apk, aqk = new[p][k], new[q][k]
                rows[p][k] = c * apk - s * aqk
                rows[q][k] = s * apk + c * aqk
            a = rows
            for k in range(3):
                vp, vq = V[k][p], V[k][q]
                V[k][p] = c * vp - s * vq
                V[k][q] = s * vp + c * vq
    w = torch.stack([a[0][0], a[1][1], a[2][2]], dim=-1)
    Vm = torch.stack([torch.stack(r, dim=-1) for r in V], dim=-2)
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.gather(w, -1, order),
            torch.gather(Vm, -1, order[..., None, :].expand_as(Vm)))


def _moments(levels, lvl, coords, sd, units, params, extents, rnd):
    center = coords.to(torch.float32)
    win, start = gather(levels, lvl, coords, extents)
    K = coords.shape[0]
    sigma = sd * np.float32(params.ori_sig_fctr)
    rad = sigma * np.float32(params.ori_rad_fctr)
    u = [np.float32(x) for x in units]
    inv = [np.float32(1.0) / x for x in u]
    g3 = _grad(win, inv)
    mask, _, sq = _sphere(start, center, rad, u, extents, levels.shape[1:])
    s = sigma.reshape(K, 1, 1, 1)
    w = torch.where(mask, torch.exp(-0.5 * sq / (s * s)), 0.0)
    g = torch.stack(g3, dim=-1).reshape(K, -1, 3)
    wg = w.reshape(K, -1, 1) * g
    A = torch.einsum("kvi,kvj->kij", rnd(wg), rnd(g))
    return A, wg.sum(dim=1)


def orient(levels, lvl, coords, sd, units, params: Params, sd_max: float,
           rnd, chunk: int = 256):
    """(R f32[K, 3, 3], accepted bool[K], near bool[K]) of K candidates on
    keypoint levels f32[nl, ...] (assign_eig_ori, sift.c:926-1167): the
    weighted structure tensor and mean gradient over the sphere, eigh, the
    weak-gradient, eigenvalue-ratio and corner tests, R from the two
    largest eigenvectors signed by the gradient. near marks candidates
    whose ratio or corner test lies within VERDICT_MARGIN of its bar."""
    dims = levels.shape[1:]
    rad_max = params.ori_sig_fctr * sd_max * params.ori_rad_fctr
    ext = tuple(window_extent(rad_max / units[a], dims[a]) for a in range(3))
    parts = [_moments(levels, lvl[s:s + chunk], coords[s:s + chunk],
                      sd[s:s + chunk], units, params, ext, rnd)
             for s in range(0, coords.shape[0], chunk)]
    A = torch.cat([p[0] for p in parts])
    vd = torch.cat([p[1] for p in parts])
    L, Q = eigh3x3(A)
    grad_sq = (vd * vd).sum(dim=-1)
    rej_grad = grad_sq < np.float32(params.ori_grad_thresh)
    thr = np.float32(params.max_eig_ratio)
    r01, r12 = (L[:, 0] / L[:, 1]).abs(), (L[:, 1] / L[:, 2]).abs()

    def gt(r):
        return torch.where(torch.isnan(r), False, r > thr)
    rej_ratio = gt(r01) | gt(r12)
    v2, v1 = Q[:, :, 2], Q[:, :, 1]
    d2 = (vd * v2).sum(dim=-1)
    d1 = (vd * v1).sum(dim=-1)
    gn = torch.sqrt(grad_sq)
    cos2 = d2 / (torch.linalg.vector_norm(v2, dim=-1) * gn)
    cos1 = d1 / (torch.linalg.vector_norm(v1, dim=-1) * gn)
    corner = torch.minimum(cos2.abs(), cos1.abs())
    r0 = v2 * torch.where(d2 > 0.0, 1.0, -1.0)[:, None]
    r1 = v1 * torch.where(d1 > 0.0, 1.0, -1.0)[:, None]
    R = torch.stack([r0, r1, torch.linalg.cross(r0, r1, dim=-1)], dim=-1)
    rej_corner = corner < np.float32(params.corner_thresh)
    accepted = ~rej_grad & ~rej_ratio & ~rej_corner
    m = VERDICT_MARGIN
    near = (((r01 - thr).abs() < m) | ((r12 - thr).abs() < m)
            | ((corner - params.corner_thresh).abs() < m)) & ~rej_grad
    return R, accepted, near


# ---------------------------------------------------------------------------
# Detection of one volume
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Detection:
    """One volume's keypoints as the program reports them (coordinates at
    octave resolution, octave, level, scale, the stale strength, R), the
    candidates whose verdict lies within VERDICT_MARGIN (`near`, keys
    (octave, level, x, y, z)), each octave's candidates (`cands`: coords,
    level), and the pyramid for the descriptors."""
    coords: np.ndarray
    octave: np.ndarray
    level: np.ndarray
    sd: np.ndarray
    strength: np.ndarray
    R: np.ndarray
    near: set
    cands: list
    gpyr: list

    def __len__(self):
        return len(self.coords)


def detect(vol: torch.Tensor, plan: Plan, prec: str = "f32") -> Detection:
    rnd = rounder(prec)
    params = plan.params
    nl = params.num_kp_levels
    with full_f32():
        gp, dg, dm = pyramid(vol.to(torch.float32), plan, rnd)
        rows, near, cands = [], set(), []
        for o in range(len(gp)):
            coords, lvl, strength = extrema(dg[o], dm[o], params)
            cands.append((coords.cpu().numpy(), lvl.cpu().numpy()))
            if not len(lvl):
                continue
            scales = torch.tensor(plan.scales[o][1:1 + nl],
                                  dtype=torch.float32, device=vol.device)
            R, acc, nr = orient(gp[o][1:1 + nl], lvl, coords, scales[lvl],
                                plan.level_units(o), params,
                                plan.scales[o][nl], rnd)
            c, lv = coords.cpu().numpy(), lvl.cpu().numpy()
            for i in np.nonzero(nr.cpu().numpy())[0]:
                near.add((o, int(lv[i]), *(int(v) for v in c[i])))
            rows.append((o, c, lv, strength.cpu().numpy(),
                         acc.cpu().numpy(), R.cpu().numpy()))
    del dg
    if not rows:
        z = np.zeros(0)
        return Detection(np.zeros((0, 3)), z.astype(np.int32),
                         z.astype(np.int32), z, z,
                         np.zeros((0, 3, 3), np.float32), near, cands, gp)
    c = np.concatenate([r[1] for r in rows])
    lv = np.concatenate([r[2] for r in rows]).astype(np.int32)
    st = np.concatenate([r[3] for r in rows]).astype(np.float64)
    acc = np.concatenate([r[4] for r in rows])
    R = np.concatenate([r[5] for r in rows])
    octv = np.concatenate([np.full(len(r[2]), r[0], np.int32) for r in rows])
    idx = np.nonzero(acc)[0]
    sd = np.asarray(plan.scales, np.float64)[octv[idx], lv[idx] + 1]
    # The reference's compaction keeps every field but the strength:
    # survivor j carries the j-th candidate's (copy_Keypoint, sift.c:372).
    return Detection(c[idx].astype(np.float64), octv[idx], lv[idx], sd,
                     st[:len(idx)], R[idx], near, cands, gp)


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------


def _icosahedron():
    """(MT f32[3, 60], K f32[20], faces i64[20, 3]) of init_geometry
    (sift.c:148-259): unit vertices, inward faces' v0/v1 positions swapped
    (their bin indices not), and the Moller-Trumbore test rewritten as
    det = g.(e2 x e1), y = g.(e2 x -v0), z = g.(-v0 x e1), k = e2.(-v0 x
    e1) per face."""
    gr = 1.6180339887
    v = np.array([[0, 1, gr], [0, -1, gr], [0, 1, -gr], [0, -1, -gr],
                  [1, gr, 0], [-1, gr, 0], [1, -gr, 0], [-1, -gr, 0],
                  [gr, 0, 1], [-gr, 0, 1], [gr, 0, -1], [-gr, 0, -1]],
                 np.float32)
    faces = np.array([[0, 1, 8], [0, 8, 4], [0, 4, 5], [0, 5, 9], [0, 9, 1],
                      [1, 6, 8], [8, 6, 10], [8, 10, 4], [4, 10, 2],
                      [4, 2, 5], [5, 2, 11], [5, 11, 9], [9, 11, 7],
                      [9, 7, 1], [1, 7, 6], [3, 6, 7], [3, 7, 11],
                      [3, 11, 2], [3, 2, 10], [3, 10, 6]], np.int64)
    v = v / np.sqrt((v * v).sum(axis=1, keepdims=True)).astype(np.float32)
    tri = v[faces]
    n = np.cross(tri[:, 2] - tri[:, 1], tri[:, 1] - tri[:, 0])
    inward = np.einsum("fi,fi->f", n, tri[:, 0]) < 0
    tri[inward] = tri[inward][:, [1, 0, 2]]
    e1, e2, t = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], -tri[:, 0]
    q = np.cross(t, e1)
    mt = np.concatenate([np.cross(e2, e1).T, np.cross(e2, t).T, q.T], axis=1)
    return (mt.astype(np.float32),
            np.einsum("fi,fi->f", e2, q).astype(np.float32), faces)


_MT, _KC, _FACES = _icosahedron()


def _sparse4(vb):
    """[..., 4] trilinear weights of one axis over the 4 spatial bins."""
    base = torch.floor(vb)
    fr = vb - base
    cells = torch.arange(NB, dtype=torch.float32, device=vb.device)
    return (torch.where(cells == base[..., None], 1.0 - fr[..., None], 0.0)
            + torch.where(cells == base[..., None] + 1.0, fr[..., None], 0.0))


def _hist(grot, vbins, eps, rnd, chunk: int):
    """f32[K, 16, 48] histograms ([(cz, cy), (cx, vertex)]) of K windows'
    rotated gradients and spatial bins f32[K, 3, N]: each voxel's |g|
    spread over the vertices of the first face it pierces (barycentric)
    and over the spatial bins (trilinear), summed by a batched product
    per voxel chunk (icos_hist_bin, SIFT3D_desc_acc_interp,
    sift.c:1254-1363)."""
    K, _, N = grot.shape
    dev = grot.device
    mt = rnd(torch.from_numpy(_MT).to(dev))
    kc = torch.from_numpy(_KC).to(dev)
    faces = torch.from_numpy(_FACES).to(dev)
    iota = torch.arange(NFACES, device=dev)
    out = torch.zeros((K, NB * NB, NB * NVERT), dtype=torch.float32,
                      device=dev)
    for s in range(0, N, chunk):
        g = grot[:, :, s:s + chunk].transpose(1, 2)          # [K, n, 3]
        vb = vbins[:, :, s:s + chunk].transpose(1, 2)
        Fm = rnd(g) @ mt                                      # [K, n, 60]
        det, yn, zn = Fm[..., :20], Fm[..., 20:40], Fm[..., 40:]
        sgn = torch.sign(det)
        adet = det * sgn
        neg = -eps * adet
        ys, zs = yn * sgn, zn * sgn
        ok = ((adet >= eps) & (ys >= neg) & (zs >= neg)
              & (adet - ys - zs >= neg) & (kc * sgn >= 0.0))
        first = torch.where(ok, iota, NFACES).min(dim=-1).values
        gsq = (g * g).sum(dim=-1)
        hit = (first < NFACES) & (gsq >= eps)
        f = torch.clamp(first, max=NFACES - 1)
        onehot = iota == f[..., None]
        d_s = torch.where(onehot, det, 0.0).sum(dim=-1)
        y_s = torch.where(onehot, yn, 0.0).sum(dim=-1)
        z_s = torch.where(onehot, zn, 0.0).sum(dim=-1)
        # Only a hit's |det| is bounded below (by eps); elsewhere the
        # weight is zero, and a vanishing gradient's 1/det may overflow.
        inv = torch.where(hit, 1.0 / d_s, 0.0)
        by, bz = y_s * inv, z_s * inv
        mag = torch.where(hit, torch.sqrt(gsq), 0.0)
        bw = torch.stack([1.0 - by - bz, by, bz], dim=-1) * mag[..., None]
        B = torch.zeros(g.shape[:2] + (NVERT,), dtype=torch.float32,
                        device=dev).scatter_add_(2, faces[f], bw)
        Sx, Sy, Sz = (_sparse4(vb[..., a]) for a in range(3))
        ZY = (Sz[..., :, None] * Sy[..., None, :]).flatten(2)   # [K, n, 16]
        P = (Sx[..., :, None] * B[..., None, :]).flatten(2)     # [K, n, 48]
        out += rnd(ZY).transpose(1, 2) @ rnd(P)
    return out


def _row_sum(a):
    """Row sums of [K, 768] as a fixed tree of adds."""
    while a.shape[-1] % 2 == 0:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    out = a[..., 0]
    for j in range(1, a.shape[-1]):
        out = out + a[..., j]
    return out[..., None]


def normalize(h, params: Params):
    """L2-normalize, truncate, renormalize (sift.c:1402-1429,
    1508-1526)."""
    def norm1(x):
        return x * (1.0 / (torch.sqrt(_row_sum(x * x))
                           + float(np.float32(_DBL_EPSILON))))
    return norm1(torch.clamp(norm1(h),
                             max=float(np.float32(params.trunc_thresh))))


def _windows(levels, lvl, centers, R, sd, units, extents, dims, params):
    """(grot, vbins) f32[K, 3, N] of K keypoints' windows: the Gaussian-
    weighted gradient rotated by R^T, zero outside the sphere, the box and
    the 4x4x4 cube, and each voxel's spatial bin coordinates
    (extract_descrip, sift.c:1440-1492)."""
    K = centers.shape[0]
    sigma = sd * float(np.float32(params.desc_sig_fctr))
    rad = sigma * float(np.float32(params.desc_rad_fctr))
    half = true_div(rad, np.float32(_SQRT2))
    bin_fctr = 1.0 / (2.0 * half / float(NB))
    win, start = gather(levels, lvl, centers.round().long(), extents)
    u = [float(np.float32(x)) for x in units]
    inv = [float(np.float32(1.0) / np.float32(x)) for x in units]
    g3 = _grad(win, inv)
    mask, d3, sq = _sphere(start, centers, rad, u, extents, dims)

    def col(t):
        return t.reshape(K, 1, 1, 1)
    vbins = []
    for j in range(3):
        vkp = (d3[0] * col(R[:, 0, j]) + d3[1] * col(R[:, 1, j])
               + d3[2] * col(R[:, 2, j]))
        vb = (vkp + col(half)) * col(bin_fctr)
        mask &= (vb >= 0.0) & (vb < float(NB))
        vbins.append(vb.reshape(K, -1))
    s = col(sigma)
    w = torch.where(mask, torch.exp(-0.5 * sq / (s * s)), 0.0)
    wg = [w * g for g in g3]
    grot = [(wg[0] * col(R[:, 0, j]) + wg[1] * col(R[:, 1, j])
             + wg[2] * col(R[:, 2, j])).reshape(K, -1) for j in range(3)]
    return torch.stack(grot, dim=1), torch.stack(vbins, dim=1)


def describe(det: Detection, plan: Plan, idx=None, prec: str = "f32",
             voxels: int = 6_000_000, chunk: int = 65536):
    """(data f32[K, 768], xyz f32[K, 3]) of the keypoints idx (default
    all) of a Detection, from its own pyramid, octave by octave, in the
    order of idx."""
    rnd = rounder(prec)
    params = plan.params
    nl = params.num_kp_levels
    idx = np.arange(len(det)) if idx is None else np.asarray(idx, np.int64)
    data = np.zeros((len(idx), DESC_NUMEL), np.float32)
    xyz = np.zeros((len(idx), 3), np.float32)
    with full_f32():
        for o in np.unique(det.octave[idx]) if len(idx) else []:
            o = int(o)
            rows = np.nonzero(det.octave[idx] == o)[0]
            sel = idx[rows]
            g = det.gpyr[o]
            dev = g.device
            units = plan.level_units(o)
            dims = tuple(g.shape[1:])
            sig = np.float32(np.float32(plan.scales[o][nl])
                             * np.float32(params.desc_sig_fctr))
            rad = float(np.float32(sig * np.float32(params.desc_rad_fctr)))
            ext = tuple(window_extent(rad / units[a], dims[a])
                        for a in range(3))
            step = max(1, voxels // int(np.prod([e - 2 for e in ext])))
            centers = torch.as_tensor(det.coords[sel], dtype=torch.float32,
                                      device=dev)
            lvl = torch.as_tensor(det.level[sel] + 1, dtype=torch.int64,
                                  device=dev)
            R = torch.as_tensor(det.R[sel], dtype=torch.float32, device=dev)
            sd = torch.as_tensor(det.sd[sel], dtype=torch.float32, device=dev)
            hists = []
            for s in range(0, len(sel), step):
                sl = slice(s, s + step)
                grot, vb = _windows(g, lvl[sl], centers[sl], R[sl], sd[sl],
                                    units, ext, dims, params)
                hists.append(_hist(grot, vb, np.float32(params.bary_eps),
                                   rnd, chunk).reshape(-1, DESC_NUMEL))
                del grot, vb
            data[rows] = normalize(torch.cat(hists), params).cpu().numpy()
            xyz[rows] = (centers * float(2.0 ** o)).cpu().numpy()
    return data, xyz


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------


def match(d1: np.ndarray, d2: np.ndarray, nn_thresh: float, device,
          prec: str = "f32"):
    """(i1, i2): rows of d1 whose nearest row of d2 (squared distance from
    one product) passes Lowe's ratio test d1/d2 < nn_thresh."""
    if not len(d1) or not len(d2):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    rnd = rounder(prec)
    a = torch.as_tensor(d1, dtype=torch.float32, device=device)
    b = torch.as_tensor(d2, dtype=torch.float32, device=device)
    with full_f32():
        D = ((a * a).sum(1, keepdim=True) + (b * b).sum(1)[None]
             - 2.0 * (rnd(a) @ rnd(b).T))
    D = torch.clamp(D, min=0.0)
    best = torch.argmin(D, dim=1, keepdim=True)
    bd = torch.gather(D, 1, best)[:, 0]
    second = D.scatter(1, best, _BIG).amin(dim=1)
    ratio = torch.sqrt(bd) / torch.clamp(torch.sqrt(second), min=1e-30)
    ok = (ratio < float(np.float32(nn_thresh))) & (second < _BIG)
    i1 = np.nonzero(ok.cpu().numpy())[0]
    return i1, best[:, 0].cpu().numpy()[i1]


def sample4(seed: int, num_iter: int, n: int) -> torch.Tensor:
    """i64[num_iter, 4] minimal samples of 4 distinct indices of [0,
    max(n, 4)) from a seeded CPU generator: draw k samples [0, n - k) and
    shifts past the earlier picks."""
    gen = torch.Generator().manual_seed(int(seed))
    n = max(int(n), 4)
    r = [torch.randint(0, n - j, (num_iter,), generator=gen)
         for j in range(4)]
    i0 = r[0]
    i1 = r[1] + (r[1] >= i0)
    a, b = torch.minimum(i0, i1), torch.maximum(i0, i1)
    i2 = r[2] + (r[2] >= a)
    i2 = i2 + (i2 >= b)
    lo, hi = torch.minimum(a, i2), torch.maximum(b, i2)
    mid = a + b + i2 - lo - hi
    i3 = r[3] + (r[3] >= lo)
    i3 = i3 + (i3 >= mid)
    i3 = i3 + (i3 >= hi)
    return torch.stack([i0, i1, i2, i3], dim=1)


def ransac(src: np.ndarray, dst: np.ndarray, w: np.ndarray, num_iter: int,
           seed: int, err_thresh: float, device, prec: str = "f32"):
    """Affine f32[3, 4] with dst ~ A [src; 1] (None under 4 matches): every
    4-point hypothesis solved at once (a singular one counts no inliers),
    the first with the most inliers refit three times by weighted normal
    equations."""
    M = len(src)
    if M < 4:
        return None
    rnd = rounder(prec)
    dev = torch.device(device)
    S = torch.as_tensor(src, dtype=torch.float32, device=dev)
    Dt = torch.as_tensor(dst, dtype=torch.float32, device=dev)
    W = torch.as_tensor(w, dtype=torch.float32, device=dev)
    X = torch.cat([S, torch.ones((M, 1), device=dev)], dim=1)
    idx = sample4(seed, num_iter, M).to(dev)
    thr2 = float(np.float32(err_thresh * err_thresh))
    with full_f32():
        As, info = torch.linalg.solve_ex(X[idx], Dt[idx])       # [N, 4, 3]
        pred = torch.einsum("mi,nij->nmj", rnd(X), rnd(As))
        err2 = ((pred - Dt[None]) ** 2).sum(dim=-1)
        usable = (info == 0) & torch.isfinite(As).all(dim=2).all(dim=1)
        inl = (err2 < thr2) & usable[:, None]
        cur = inl[torch.argmax(inl.sum(dim=1))]
        eye = 1e-8 * torch.eye(4, dtype=torch.float32, device=dev)
        for _ in range(3):
            Xw = X * (cur.to(torch.float32) * W)[:, None]
            Ar, _ = torch.linalg.solve_ex(rnd(Xw.T) @ rnd(X) + eye,
                                          rnd(Xw.T) @ rnd(Dt))
            cur = ((rnd(X) @ rnd(Ar) - Dt) ** 2).sum(dim=-1) < thr2
    return Ar.T.cpu().numpy()

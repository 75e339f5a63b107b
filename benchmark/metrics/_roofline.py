"""The roofline yardstick: peaks, the least time, and each layer's work. A
layer's share of its roofline is the least time the card could take for
the layer's work over the device time its kernels took. The least time
is the larger of the bytes over the memory bandwidth and the operations
over the f32 rate (``bound``). The work is counted the same way whatever
implements it: from the layer's input and output shapes and from the
call's candidate and keypoint counts, each input byte read once and each
output byte written once; halo re-reads, tiles and launches are never
counted. Counts follow the kernel notes of the SIFT3D port's bring-up
(the ``bound`` of its smoke test and its byte and operation counts),
frozen here. A later change that renames a kernel, or moves work across
layers, makes a share read nothing (no kernel time of its names) or more
than 100% (work counted in one layer, done in another): the metric's
file then needs a benchmark change that points it again."""

from __future__ import annotations

import functools
import math

import numpy as np

# H100 SXM (NVIDIA data sheet): HBM3 bytes/s; f32 FLOP/s outside the
# tensor cores. Both assume the card's full 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAKS = f"{PEAK_BYTES:.3g} B/s, {PEAK_F32:.3g} f32 FLOP/s (H100 SXM)"
# f32 operations a voxel of the descriptor's sphere-and-cube takes: the
# gradient, the weight, two 3x3 rotations, the 20-face test (~15 each)
# and 24 weighted adds.
DESC_OPS_PER_VOXEL = 400


def bound(nbytes: float, ops: float) -> float:
    """Least time in seconds the card could take."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


def share(run, layer: str, kernels) -> float | None:
    """Percent of its roofline that `layer` reached over the traced calls,
    its time the summed device time of `kernels` (None where the trace
    holds none of them)."""
    if not run.trace or run.work is None:
        return None
    t = sum(run.trace["kernel_s"].get(k, 0.0) for k in kernels)
    if t <= 0.0:
        return None
    nbytes, ops = run.work[layer]
    return 100.0 * bound(nbytes, ops) / t


def pyramid_work(plan) -> tuple[float, float]:
    """Pyramid (the blur levels and the DoG) of one volume. Per blurred
    level of N voxels, as one function: read the level below (4N), write
    the level (4N) and, beside every level but octave 0's first, its DoG
    (4N); a multiply and an add per band tap on each axis, and the DoG's
    subtract, absolute value and max."""
    nbytes = ops = 0.0
    for (o, i), band in plan.bands.items():
        N = float(np.prod(plan.octave_dims[o]))
        dog = 1.0 if i > 0 else 0.0
        taps = sum(wd.shape[1] for wd, _ in band)
        nbytes += (8.0 + 4.0 * dog) * N
        ops += (2.0 * taps + 3.0 * dog) * N
    return nbytes, ops


def extrema_work(plan, cands) -> tuple[float, float]:
    """Extrema stencil of one volume, cands its candidates per octave.
    Per octave: the keypoint levels' DoG read once, a key written (8 B)
    per candidate; two threshold compares a voxel and 16 compares (8
    neighbours, above and below) a candidate."""
    nl = plan.params.num_kp_levels
    nbytes = ops = 0.0
    for o, (coords, _) in enumerate(cands):
        N = nl * float(np.prod(plan.octave_dims[o]))
        nbytes += 4.0 * N + 8.0 * len(coords)
        ops += 2.0 * N + 16.0 * len(coords)
    return nbytes, ops


def _boxes(coords, sd, rad_fctr: float, units, dims):
    """Per window: the voxels of its loop-bound box, in the kernels' f32
    arithmetic, and its radius in voxels."""
    c = np.asarray(coords, np.float32)
    rad = np.asarray(sd, np.float32) * np.float32(rad_fctr)
    box = np.ones(len(c))
    for a in range(3):
        ra = rad / np.float32(units[a])
        lo = np.maximum(np.floor(c[:, a] - ra), 1)
        hi = np.minimum(np.ceil(c[:, a] + ra), dims[a] - 2)
        box *= np.maximum(hi - lo + 1, 0)
    return box, rad / np.float32(np.prod(units) ** (1.0 / 3.0))


def orientation_work(plan, cands) -> tuple[float, float]:
    """Orientation of one volume's candidates (every candidate, as the
    layer takes them). Per candidate: its loop-bound box read once (4 B a
    voxel), A, vd, R and the flags written (76 B); the sphere test on
    every box voxel (11), the gradient, weight and 9 moment sums on the
    sphere's (40)."""
    p = plan.params
    nbytes = ops = 0.0
    for o, (coords, level) in enumerate(cands):
        if not len(coords):
            continue
        sd = np.asarray(plan.scales[o], np.float64)[1 + level]
        box, r = _boxes(coords, sd, p.ori_sig_fctr * p.ori_rad_fctr,
                        plan.level_units(o), plan.octave_dims[o])
        sphere = np.minimum(4.0 / 3.0 * math.pi * r.astype(np.float64) ** 3,
                            box)
        nbytes += float((4.0 * box).sum()) + 76.0 * len(coords)
        ops += float((11.0 * box + 40.0 * sphere).sum())
    return nbytes, ops


@functools.cache
def sphere_cube_fraction() -> float:
    """Share of the cube [-r, r]^3 inside both the sphere of radius r and
    the descriptor's cube of half-side r / sqrt(2), whatever its rotation:
    the integral over x of the area of a disc of radius sqrt(r^2 - x^2)
    cut by the square of half-side a (four circular segments off)."""
    a = 1.0 / math.sqrt(2.0)
    x = np.linspace(-a, a, 20001)
    rho2 = 1.0 - x * x
    rho = np.sqrt(rho2)
    seg = rho2 * np.arccos(np.minimum(a / rho, 1.0)) \
        - a * np.sqrt(np.maximum(rho2 - a * a, 0.0))
    area = math.pi * rho2 - 4.0 * seg
    return float(((area[1:] + area[:-1]) * np.diff(x)).sum() / 2.0) / 8.0


def descriptor_work(plan, kp) -> tuple[float, float]:
    """Descriptors of one volume's keypoints kp (coords, octave, sd). Per
    keypoint: its loop-bound box read once, its 768 bins written (4 B
    each); DESC_OPS_PER_VOXEL operations on each voxel of the box inside
    the sphere and the rotated cube (sphere_cube_fraction of the box)."""
    p = plan.params
    nbytes = ops = 0.0
    frac = sphere_cube_fraction()
    for o in np.unique(kp.octave):
        sel = kp.octave == o
        box, _ = _boxes(np.asarray(kp.coords)[sel], np.asarray(kp.sd)[sel],
                        p.desc_sig_fctr * p.desc_rad_fctr,
                        plan.level_units(int(o)), plan.octave_dims[int(o)])
        nbytes += float((4.0 * box).sum()) + 4.0 * 768 * int(sel.sum())
        ops += DESC_OPS_PER_VOXEL * frac * float(box.sum())
    return nbytes, ops


def traced_work(run) -> dict:
    """{layer: (bytes, operations)} over the traced calls: each call's
    volumes, the candidates the reference finds in them (counted once a
    distinct volume of the pool), and the keypoints the call returned."""
    from ..checks._sift3d import plan_for
    from ..reference import sift3d_plain as ref
    total = {k: [0.0, 0.0] for k in ("pyramid", "detect", "orientation",
                                     "descriptor")}
    memo = {}
    for slot, out in run.traced:
        vols = out["volumes"]
        plan = plan_for(run.cell.config, int(vols[0].shape[-1]))
        for v, (vol, kp) in enumerate(zip(vols, out["keypoints"])):
            if (slot, v) not in memo:
                memo[slot, v] = ref.candidates(vol, plan)
            cands = memo[slot, v]
            for layer, (b, o) in (
                    ("pyramid", pyramid_work(plan)),
                    ("detect", extrema_work(plan, cands)),
                    ("orientation", orientation_work(plan, cands)),
                    ("descriptor", descriptor_work(plan, kp))):
                total[layer][0] += b
                total[layer][1] += o
    return {k: tuple(v) for k, v in total.items()}

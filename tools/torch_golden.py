"""Golden JAX outputs for the PyTorch port's on-card check.

Runs the JAX package on the CPU in its reference program order
(DetectorParams(gpyr_impl="incremental", extrema_impl="xla")) over the
sparse bench phantom (bench.make_bench_volume) of --size (256), or with
--dense the dense one (bench.make_dense_volume), at voxel --units
(1,1,1), and stores every keypoint field plus the descriptors of all
keypoints in one compressed npz: tests/data/torch_golden_{cell}{size}.npz,
cell "sparse", "dense", or "aniso" for the sparse phantom at other units
than 1 (torch_golden_sparse256, dense256, sparse192 and aniso128 at
units 1,1,2.5 are in the repository). It also stores R64, each
keypoint's R from f64 moment sums (f64_sum_R): where two eigenvalues are
close, f32 sums taken in two orders move R past the 1e-5 bar, and
chip_smoke.py holds such a row to R64 instead. chip_smoke.py holds the
port's GPU run against these files.

--refine and --edge-thresh R turn on the two extensions (subvoxel
refinement, Hessian edge rejection): the file is then
torch_golden_refine{size}.npz (refine128 is in the repository, with
--edge-thresh 10), its coordinates fractional and R64 taken around the
fractional centers.

--register N writes torch_golden_register{N}.npz instead: the rotated and
translated N^3 pair of tools/bench_registration.py (make_pair with
np.random.default_rng(3)), registered by the JAX package with the default
parameters and with refine_subvoxel=True. It holds the true affine, each
configuration's affine, match and inlier counts, and the JAX-warped
moving volume sampled every 7th voxel along each axis.

--register-batch N --pairs P writes torch_golden_batch{N}x{P}.npz: P pairs
drawn as tools/bench_registration.py draws BASELINE config 5's batch
(make_pair(N) P times from np.random.default_rng(3), after the 192^3
pair), registered by the JAX package's register_batch with the default
parameters. Per pair b it holds A_true{b}, affine{b} (NaN where JAX found
no affine), matches{b}, inliers{b}, err{b} (corner error against the
truth), idx{b}, JAX's RANSAC hypothesis indices for the pair
(_sample_distinct4(PRNGKey(0), 500, matches{b}), which the port's RANSAC
is fed to reproduce JAX's inliers), and moving_sample{b}, the moving
volume every 7th voxel along each axis.

--funnel writes tests/data/torch_golden_funnel.json instead: the JAX
SIFT3D's detection funnel (SIFT3D._funnel: per octave and keypoint level
the candidates, the weak-gradient, eigenvalue-ratio and corner
rejections and the survivors) and keypoint count of each main-path cell
of chip_smoke.py (FUNNEL_CELLS: sparse256, dense256, sparse192, aniso128
and refine128), in the goldens' program order.

XLA:CPU contracts the blur's multiply-then-add chain (pyramid._diag_pass)
into fused multiply-adds under jit on CPUs with FMA, which moves the
pyramid by ulps away from the eager (and the port's) arithmetic. The
script therefore caps the XLA:CPU instruction set at SSE4.2, which has no
FMA: the jitted pyramid then equals the eager one bit for bit.

Usage: python tools/torch_golden.py [--dense] [--size N] [--units X,Y,Z]
                                    [--refine] [--edge-thresh R]
                                    [--register N]
                                    [--register-batch N --pairs P]
                                    [--funnel] [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# Every 7th voxel along each axis of a registration golden's moving volume.
MOVING_STRIDE = 7
# chip_smoke.py's main-path cells: (phantom, size, voxel units, extensions).
FUNNEL_CELLS = {
    "sparse256": ("sparse", 256, (1.0, 1.0, 1.0), {}),
    "dense256": ("dense", 256, (1.0, 1.0, 1.0), {}),
    "sparse192": ("sparse", 192, (1.0, 1.0, 1.0), {}),
    "aniso128": ("sparse", 128, (1.0, 1.0, 2.5), {}),
    "refine128": ("sparse", 128, (1.0, 1.0, 1.0),
                  {"refine_subvoxel": True, "edge_thresh": 10.0})}


def f64_sum_R(levels, lvl, coords, sd, units, params, sd_max: float,
              centers=None):
    """R f32[K, 3, 3] of K keypoints of one octave, with the moment sums in
    f64 as the C reference accumulates them (sift.c:978-983): the JAX
    package's assign_orientations under jax.enable_x64 on the levels
    f32[L, nx, ny, nz] widened to f64, so the gradients are f64 differences
    of the f32 samples and the structure tensor, the eigensolver and R run
    in f64; the weights and loop bounds stay f32. lvl i32[K] indexes
    levels, coords i32[K, 3] the window anchors, sd f32[K] <= sd_max;
    centers f32[K, 3], where given, the fractional window centers (within
    a voxel of the anchors; the windows take the fractional margin)."""
    import jax
    import jax.numpy as jnp
    from sift3d_tpu.orientation import assign_orientations
    with jax.enable_x64(True):
        ori = assign_orientations(
            jnp.asarray(np.asarray(levels, np.float64)),
            jnp.asarray(coords, jnp.int32), jnp.ones(len(coords), bool),
            jnp.asarray(sd, jnp.float32), tuple(units), params,
            centers=(None if centers is None
                     else jnp.asarray(centers, jnp.float32)),
            sd_max=sd_max, level_index=jnp.asarray(lvl, jnp.int32),
            fractional_centers=centers is not None, use_pallas=False)
        return np.asarray(ori.R)


def register_golden(n: int, out: Path) -> None:
    """The registration golden of the N^3 pair (see the module notes)."""
    from bench_registration import affine_corner_error, make_pair
    from sift3d_tpu import DetectorParams, SIFT3D
    from sift3d_tpu.registration import register
    fixed, moving, A_true = make_pair(n, np.random.default_rng(3))
    rows = dict(size=np.int32(n), A_true=A_true,
                moving_stride=np.int32(MOVING_STRIDE),
                moving_sample=np.asarray(moving.data)[::MOVING_STRIDE,
                                                      ::MOVING_STRIDE,
                                                      ::MOVING_STRIDE])
    for cfg, ext in (("default", {}), ("refined", {"refine_subvoxel": True})):
        params = DetectorParams(gpyr_impl="incremental", extrema_impl="xla",
                                **ext)
        t0 = time.perf_counter()
        # A detector pair takes the per-pair path, whose numerics the
        # batched one repeats (sift3d_tpu/registration.py:207-210).
        res = register(fixed, moving, num_iter=500,
                       detectors=(SIFT3D(params), SIFT3D(params)))
        dt = time.perf_counter() - t0
        err = affine_corner_error(res.affine, A_true, n)
        rows.update({f"{cfg}_affine": res.affine,
                     f"{cfg}_matches": np.int32(res.num_matches),
                     f"{cfg}_inliers": np.int32(res.num_inliers),
                     f"{cfg}_err": np.float64(err)})
        print(f"register{n} {cfg}: {res.num_matches} matches, "
              f"{res.num_inliers} inliers, corner error {err:.4f} vox, JAX "
              f"CPU {dt:.1f} s")
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **rows)
    print(f"-> {out} ({out.stat().st_size} bytes)")


def register_batch_golden(n: int, pairs: int, out: Path) -> None:
    """The batch registration golden of P N^3 pairs (see the module
    notes)."""
    from bench_registration import affine_corner_error, make_pair
    import jax
    from sift3d_tpu import DetectorParams, SIFT3D
    from sift3d_tpu.registration import _sample_distinct4, register_batch
    rng = np.random.default_rng(3)
    # The single-pair configuration's draws come first (make_pair(192):
    # the angle, then the shift).
    rng.uniform(6, 10)
    rng.uniform(-4, 4, 3)
    made = [make_pair(n, rng) for _ in range(pairs)]
    params = DetectorParams(gpyr_impl="incremental", extrema_impl="xla")
    t0 = time.perf_counter()
    res = register_batch(np.stack([np.asarray(f.data) for f, _, _ in made]),
                         np.stack([np.asarray(m.data) for _, m, _ in made]),
                         num_iter=500, det=SIFT3D(params))
    dt = time.perf_counter() - t0
    rows = dict(size=np.int32(n), pairs=np.int32(pairs),
                moving_stride=np.int32(MOVING_STRIDE))
    for b, ((_, moving, A_true), r) in enumerate(zip(made, res)):
        err = affine_corner_error(r.affine, A_true, n)
        affine = (np.full((3, 4), np.nan, np.float32) if r.affine is None
                  else r.affine)
        rows[f"idx{b}"] = np.asarray(_sample_distinct4(
            jax.random.PRNGKey(0), 500, jax.numpy.int32(r.num_matches)))
        rows.update({f"A_true{b}": A_true, f"affine{b}": affine,
                     f"matches{b}": np.int32(r.num_matches),
                     f"inliers{b}": np.int32(r.num_inliers),
                     f"err{b}": np.float64(err),
                     f"moving_sample{b}": np.asarray(moving.data)[
                         ::MOVING_STRIDE, ::MOVING_STRIDE, ::MOVING_STRIDE]})
        print(f"batch{n}x{pairs} pair {b}: {r.num_matches} matches, "
              f"{r.num_inliers} inliers, corner error {err:.4f} vox")
    print(f"JAX CPU register_batch {dt:.1f} s")
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **rows)
    print(f"-> {out} ({out.stat().st_size} bytes)")


def funnel_golden(out: Path) -> None:
    """The detection funnels of FUNNEL_CELLS (see the module notes)."""
    import json
    from bench import make_bench_volume, make_dense_volume
    from sift3d_tpu import DetectorParams, SIFT3D
    from sift3d_tpu.volume import Volume
    make = {"sparse": make_bench_volume, "dense": make_dense_volume}
    cells = {}
    for cell, (kind, size, units, ext) in FUNNEL_CELLS.items():
        params = DetectorParams(gpyr_impl="incremental", extrema_impl="xla",
                                **ext)
        det = SIFT3D(params)
        t0 = time.perf_counter()
        kp = det.detect_keypoints(Volume.from_array(make[kind](size),
                                                    units=units))
        dt = time.perf_counter() - t0
        cells[cell] = dict(
            phantom=kind, size=size, units=list(units), extensions=ext,
            num_keypoints=len(kp),
            funnel=[[o, s, f] for (o, s), f in det._funnel.items()])
        print(f"{cell}: {len(kp)} keypoints, "
              f"{sum(f['candidates'] for f in det._funnel.values())} "
              f"candidates, JAX CPU {dt:.1f} s", flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    # One line a cell.
    out.write_text("{\n" + ",\n".join(f"{json.dumps(c)}: {json.dumps(v)}"
                                      for c, v in cells.items()) + "\n}\n")
    print(f"-> {out} ({out.stat().st_size} bytes)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--units", default="1,1,1",
                    type=lambda s: tuple(float(u) for u in s.split(",")))
    ap.add_argument("--refine", action="store_true",
                    help="subvoxel refinement on")
    ap.add_argument("--edge-thresh", type=float, default=None,
                    help="Hessian edge rejection at this eigenvalue ratio")
    ap.add_argument("--register", type=int, metavar="N",
                    help="the registration golden of the N^3 pair")
    ap.add_argument("--register-batch", type=int, metavar="N",
                    help="the batch registration golden of --pairs N^3 "
                         "pairs")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--funnel", action="store_true",
                    help="the detection funnels of the main-path cells")
    ap.add_argument("--out", type=Path, help="write here instead")
    args = ap.parse_args(argv)
    units = args.units
    ext = args.refine or args.edge_thresh is not None
    cell = ("dense" if args.dense else "refine" if ext
            else "sparse" if units == (1.0, 1.0, 1.0) else "aniso")
    if args.register:
        cell, args.size = "register", args.register
    suffix = f"{args.size}"
    if args.register_batch:
        cell, suffix = "batch", f"{args.register_batch}x{args.pairs}"
    out = args.out or (REPO / "tests" / "data"
                       / ("torch_golden_funnel.json" if args.funnel
                          else f"torch_golden_{cell}{suffix}.npz"))
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_max_isa=SSE4_2").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.funnel:
        funnel_golden(out)
        return 0
    if args.register or args.register_batch:
        sys.path.insert(0, str(REPO / "tools"))
        if args.register_batch:
            register_batch_golden(args.register_batch, args.pairs, out)
        else:
            register_golden(args.register, out)
        return 0
    from bench import make_bench_volume, make_dense_volume
    from sift3d_tpu import DetectorParams, SIFT3D
    from sift3d_tpu.volume import Volume

    vol = Volume.from_array(
        (make_dense_volume if args.dense else make_bench_volume)(args.size),
        units=units)
    params = DetectorParams(gpyr_impl="incremental", extrema_impl="xla",
                            refine_subvoxel=args.refine,
                            edge_thresh=args.edge_thresh)
    det = SIFT3D(params)
    t0 = time.perf_counter()
    kp = det.detect_keypoints(vol)
    desc = det.extract_descriptors(kp)
    dt = time.perf_counter() - t0
    nl = params.num_kp_levels
    R64 = np.zeros_like(kp.R, dtype=np.float32)
    for o in np.unique(kp.octave):
        idx = np.nonzero(kp.octave == o)[0]
        scales = np.asarray(det._plan.scales[o][1:1 + nl], np.float32)
        # With an extension on, the keypoint's own (refined) scale and
        # center; windows sized as the JAX package sizes them then.
        sd = kp.sd[idx] if ext else scales[kp.level[idx]]
        sd_max = float(scales.max()) * (2.0 ** (1.0 / nl) if ext else 1.0)
        R64[idx] = f64_sum_R(np.asarray(det._gpyr[o])[1:1 + nl],
                             kp.level[idx], np.rint(kp.coords[idx]), sd,
                             det._plan.level_units(o), params, sd_max,
                             centers=kp.coords[idx] if ext else None)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out, size=np.int32(args.size), units=np.asarray(units, np.float64),
        refine_subvoxel=np.bool_(args.refine),
        edge_thresh=np.float64(np.nan if args.edge_thresh is None
                               else args.edge_thresh),
        coords=kp.coords, octave=kp.octave, level=kp.level, sd=kp.sd,
        strength=kp.strength, R=kp.R, R64=R64, desc_xyz=desc.xyz,
        desc_sd=desc.sd, desc=desc.data)
    print(f"{cell}{args.size} at units {units}: {len(kp)} keypoints, JAX "
          f"CPU {dt:.1f} s -> {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

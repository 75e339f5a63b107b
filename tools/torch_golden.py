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

XLA:CPU contracts the blur's multiply-then-add chain (pyramid._diag_pass)
into fused multiply-adds under jit on CPUs with FMA, which moves the
pyramid by ulps away from the eager (and the port's) arithmetic. The
script therefore caps the XLA:CPU instruction set at SSE4.2, which has no
FMA: the jitted pyramid then equals the eager one bit for bit.

Usage: python tools/torch_golden.py [--dense] [--size N] [--units X,Y,Z]
                                    [--out PATH]
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

def f64_sum_R(levels, lvl, coords, sd, units, params, sd_max: float):
    """R f32[K, 3, 3] of K keypoints of one octave, with the moment sums in
    f64 as the C reference accumulates them (sift.c:978-983): the JAX
    package's assign_orientations under jax.enable_x64 on the levels
    f32[L, nx, ny, nz] widened to f64, so the gradients are f64 differences
    of the f32 samples and the structure tensor, the eigensolver and R run
    in f64; the weights and loop bounds stay f32. lvl i32[K] indexes
    levels, coords i32[K, 3], sd f32[K] <= sd_max."""
    import jax
    import jax.numpy as jnp
    from sift3d_tpu.orientation import assign_orientations
    with jax.enable_x64(True):
        ori = assign_orientations(
            jnp.asarray(np.asarray(levels, np.float64)),
            jnp.asarray(coords, jnp.int32), jnp.ones(len(coords), bool),
            jnp.asarray(sd, jnp.float32), tuple(units), params,
            sd_max=sd_max, level_index=jnp.asarray(lvl, jnp.int32),
            fractional_centers=False, use_pallas=False)
        return np.asarray(ori.R)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--units", default="1,1,1",
                    type=lambda s: tuple(float(u) for u in s.split(",")))
    ap.add_argument("--out", type=Path, help="write here instead")
    args = ap.parse_args(argv)
    units = args.units
    cell = ("dense" if args.dense
            else "sparse" if units == (1.0, 1.0, 1.0) else "aniso")
    out = args.out or (REPO / "tests" / "data"
                       / f"torch_golden_{cell}{args.size}.npz")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_max_isa=SSE4_2").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from bench import make_bench_volume, make_dense_volume
    from sift3d_tpu import DetectorParams, SIFT3D
    from sift3d_tpu.volume import Volume

    vol = Volume.from_array(
        (make_dense_volume if args.dense else make_bench_volume)(args.size),
        units=units)
    params = DetectorParams(gpyr_impl="incremental", extrema_impl="xla")
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
        R64[idx] = f64_sum_R(np.asarray(det._gpyr[o])[1:1 + nl],
                             kp.level[idx], kp.coords[idx],
                             scales[kp.level[idx]], det._plan.level_units(o),
                             params, float(scales.max()))
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out, size=np.int32(args.size), units=np.asarray(units, np.float64),
        coords=kp.coords, octave=kp.octave, level=kp.level, sd=kp.sd,
        strength=kp.strength, R=kp.R, R64=R64, desc_xyz=desc.xyz,
        desc_sd=desc.sd, desc=desc.data)
    print(f"{cell}{args.size} at units {units}: {len(kp)} keypoints, JAX "
          f"CPU {dt:.1f} s -> {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Golden JAX outputs for the PyTorch port's on-card check.

Runs the JAX package on the CPU in its reference program order
(DetectorParams(gpyr_impl="incremental", extrema_impl="xla")) over the
256^3 sparse bench phantom (bench.make_bench_volume) and stores every
keypoint field plus the descriptors of all keypoints in one compressed
npz. chip_smoke.py holds the port's GPU run against this file.

XLA:CPU contracts the blur's multiply-then-add chain (pyramid._diag_pass)
into fused multiply-adds under jit on CPUs with FMA, which moves the
pyramid by ulps away from the eager (and the port's) arithmetic. The
script therefore caps the XLA:CPU instruction set at SSE4.2, which has no
FMA: the jitted pyramid then equals the eager one bit for bit.

Usage: python tools/torch_golden.py
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SIZE = 256
OUT = REPO / "tests" / "data" / f"torch_golden_sparse{SIZE}.npz"


def main() -> int:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_max_isa=SSE4_2").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from bench import make_bench_volume
    from sift3d_tpu import DetectorParams, SIFT3D

    vol = make_bench_volume(SIZE)
    params = DetectorParams(gpyr_impl="incremental", extrema_impl="xla")
    det = SIFT3D(params)
    t0 = time.perf_counter()
    kp = det.detect_keypoints(vol)
    desc = det.extract_descriptors(kp)
    dt = time.perf_counter() - t0
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT, size=np.int32(SIZE), coords=kp.coords, octave=kp.octave,
        level=kp.level, sd=kp.sd, strength=kp.strength, R=kp.R,
        desc_xyz=desc.xyz, desc_sd=desc.sd, desc=desc.data)
    print(f"{len(kp)} keypoints, JAX CPU {dt:.1f} s -> {OUT} "
          f"({OUT.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

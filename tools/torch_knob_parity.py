"""The port against the JAX package under each value of its TPU knobs.

For every value of gpyr_impl and desc_precision that the JAX package runs
on the CPU, runs the JAX SIFT3D (XLA:CPU capped at SSE4.2, as the goldens)
and the port's SIFT3D on the CPU (its one exact f32 path) on the
tests/conftest.py phantom of --size (48), and prints per value: whether
the keypoint rows (coordinates, octave, level, scale) are identical, the
largest relative stale-strength difference of the port and of JAX's
sequential order ("incremental") from JAX under the value, the largest R
difference and the largest descriptor relative L2 difference.

Usage: python tools/torch_knob_parity.py [--size N]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
CASES = {"incremental": {"gpyr_impl": "incremental"},
         "auto": {}, "composed": {"gpyr_impl": "composed"},
         "chain": {"gpyr_impl": "chain"},
         "desc_precision=highest": {"gpyr_impl": "incremental",
                                    "desc_precision": "highest"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=48)
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_max_isa=SSE4_2").strip()
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import jax
    jax.config.update("jax_platforms", "cpu")
    from conftest import make_phantom
    import sift3d_tpu as s3d
    import sift3d_tpu_torch as st

    vol = make_phantom(args.size)
    runs = {}
    for name, knobs in CASES.items():
        jp = s3d.DetectorParams(**knobs)
        det = s3d.SIFT3D(jp)
        kp = det.detect_keypoints(vol)
        tdet = st.SIFT3D(st.from_jax_params(dataclasses.asdict(jp)), "cpu")
        tkp = tdet.detect_keypoints(vol)
        runs[name] = (kp, det.extract_descriptors(kp), tkp,
                      tdet.extract_descriptors(tkp))
    seq = runs["incremental"][0]
    print(f"port vs JAX at {args.size}^3, each knob value")
    for name, (kp, d, tkp, td) in runs.items():
        rows = all(np.array_equal(getattr(kp, f), getattr(tkp, f))
                   for f in ("coords", "octave", "level", "sd"))
        ref = np.abs(kp.strength)
        port = float(np.max(np.abs(tkp.strength - kp.strength) / ref))
        jseq = float(np.max(np.abs(seq.strength - kp.strength) / ref))
        rerr = float(np.abs(tkp.R - kp.R).max())
        derr = float(np.max(np.linalg.norm(td.data - d.data, axis=1)
                            / np.linalg.norm(d.data, axis=1)))
        print(f"  {name:<24} {len(kp)} keypoints, rows identical {rows}, "
              f"stale strength max rel: port {port:.3g}, JAX incremental "
              f"{jseq:.3g}; R max {rerr:.3g}; descriptors max rel-L2 "
              f"{derr:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

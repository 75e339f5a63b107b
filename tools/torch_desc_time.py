"""Device time of the fused descriptor kernel, octave by octave.

Detects the keypoints of a 256^3 bench phantom (sparse and dense, made on
the card by sift3d_tpu_torch.phantoms) with SIFT3D(device="cuda"), then
times ops.desc_kernel.desc_fused on each octave's keypoints: CUDA events
around 10 back-to-back calls, median of 10 such rounds. It times the
package of the checkout it sits in; to compare two kernels on one card,
run each checkout's copy in one session (old, new, new, old).

Usage: python tools/torch_desc_time.py
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import numpy as np
    import torch

    import sift3d_tpu_torch as st
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.phantoms import bench_volume

    if not torch.cuda.is_available():
        print("torch_desc_time: no CUDA device", file=sys.stderr)
        return 1
    print(f"{dk.__file__} on {torch.cuda.get_device_name(0)}")
    params = st.DetectorParams()
    nl = params.num_kp_levels
    for cell in ("sparse", "dense"):
        vol = bench_volume(cell, 256, "cuda").cpu().numpy()
        det = st.SIFT3D(params, "cuda")
        kp = det.detect_keypoints(vol)
        total = 0.0
        for o in np.unique(kp.octave):
            idx = np.nonzero(kp.octave == o)[0]

            def put(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a[idx]),
                                       dtype=dtype, device="cuda")
            call = (det._gpyr[o][0, 1:1 + nl], put(kp.level, torch.int64),
                    put(kp.coords, torch.float32), put(kp.R, torch.float32),
                    put(kp.sd, torch.float32), det._plan.level_units(o),
                    params, det._plan.scales[o][nl])
            for _ in range(2):
                dk.desc_fused(*call)
            rounds = []
            for _ in range(10):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    dk.desc_fused(*call)
                end.record()
                end.synchronize()
                rounds.append(start.elapsed_time(end) / 10)
            ms = statistics.median(rounds)
            total += ms
            print(f"  {cell} octave {o}: {len(idx)} keypoints, "
                  f"desc_fused {ms:.4f} ms")
        print(f"  {cell}, all octaves: {total:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

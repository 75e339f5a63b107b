"""Where the time goes in the PyTorch port's main path on one GPU.

Runs SIFT3D(device="cuda") detect_keypoints + extract_descriptors on a
256^3 bench phantom (bench.make_bench_volume, or make_dense_volume with
--dense) and prints:
 - the wall time of detect and of describe, each ending in a device sync
   (median of 7 runs after a warm-up);
 - from torch.profiler over one more run: device time by kernel, its sum,
   and that sum as a share of the profiled wall time (the device's busy
   share; the rest is host time with the device idle).
--table PATH also writes the profiler's full table there.

Usage: python tools/torch_profile.py [--dense] [--table PATH]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SIZE = 256
REPEATS = 7


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--table", metavar="PATH",
                    help="write the full profiler table to this file")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    import bench
    import sift3d_tpu_torch as st

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cell = f"{'dense' if args.dense else 'sparse'}{SIZE}"
    vol = (bench.make_dense_volume(SIZE) if args.dense
           else bench.make_bench_volume(SIZE))
    det = st.SIFT3D(st.DetectorParams(), "cuda")

    def run():
        t0 = time.perf_counter()
        kp = det.detect_keypoints(vol)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        det.extract_descriptors(kp)
        torch.cuda.synchronize()
        return len(kp), (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    run()
    runs = [run() for _ in range(REPEATS)]
    n_kp = runs[0][0]
    det_ms = statistics.median(r[1] for r in runs)
    desc_ms = statistics.median(r[2] for r in runs)
    tot_ms = statistics.median(r[1] + r[2] for r in runs)
    print(f"{cell}: {n_kp} keypoints on {card}")
    print(f"  wall median over {REPEATS}: detect {det_ms:.2f} ms, "
          f"describe {desc_ms:.2f} ms, total {tot_ms:.2f} ms")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    events.sort(key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in events) / 1e3
    print(f"  profiled run: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), idle share "
          f"{100 * (1 - busy / wall):.1f}%")
    for e in events[:15]:
        print(f"    {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    if args.table:
        out = Path(args.table)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())

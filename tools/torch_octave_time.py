"""Device time of octave 0's blur chain and extrema stage on one GPU.

On the 256^3 sparse bench phantom (bench.make_bench_volume, built on the
card by sift3d_tpu_torch.phantoms), scaled to [-1, 1], it times with CUDA
events (median of 9 after a warm-up):
 - ``chain_octave(x, plan, 0)``: the six levels of octave 0, the first
   blur and five blurs with their DoG and max |DoG|;
 - ``detect_extrema_octave(dog, dogmax, params)`` at octave 0: the
   threshold, the stencil and the compaction of the candidates into scan
   order with their strength;
and, from torch.profiler over one more run of each, the device time and
count of every kernel, so a blurred level's device time can be read per
kernel.

It calls only those two functions, whose signatures every version of the
port keeps, so an A/B runs the same script in two trees: unpack the other
tree with ``git archive``, copy this file into its tools/, and run each
copy in turn in one call (A, B, B, A).

Usage: python tools/torch_octave_time.py
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SIZE = 256
REPEATS = 9


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_octave_time: no CUDA device", file=sys.stderr)
        return 1
    import sift3d_tpu_torch as st
    from sift3d_tpu_torch.detect import detect_extrema_octave
    from sift3d_tpu_torch.ops.blur_kernel import chain_octave
    from sift3d_tpu_torch.phantoms import bench_volume
    from sift3d_tpu_torch.pyramid import make_plan, scale_to_unit

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    params = st.DetectorParams()
    x = scale_to_unit(bench_volume("sparse", SIZE, "cuda"))
    plan = make_plan(x.shape, (1.0, 1.0, 1.0), params)
    _, dog, dogmax = chain_octave(x, plan, 0)

    def chain():
        chain_octave(x, plan, 0)

    def extrema():
        detect_extrema_octave(dog, dogmax, params)

    print(f"{REPO.name}: octave 0 of the {SIZE}^3 sparse phantom on {card}")
    for name, fn in (("chain_octave", chain),
                     ("detect_extrema_octave", extrema)):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        print(f"  {name}: median {statistics.median(times):.4f} ms over "
              f"{REPEATS} (min {min(times):.4f}, max {max(times):.4f})")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
        events.sort(key=_device_us, reverse=True)
        busy = sum(_device_us(e) for e in events) / 1e3
        print(f"    device busy {busy:.4f} ms in "
              f"{sum(e.count for e in events)} device operations:")
        for e in events:
            print(f"    {_device_us(e) / 1e3:9.4f} ms  {e.count:4d}x  "
                  f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

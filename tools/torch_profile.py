"""Where the time goes in the PyTorch port's main path on one GPU.

Runs SIFT3D(device="cuda") detect_keypoints + extract_descriptors on a
--size (256) bench phantom (bench.make_bench_volume, or make_dense_volume
with --dense, built on the card by sift3d_tpu_torch.phantoms), with
--refine under DetectorParams(refine_subvoxel=True, edge_thresh=10.0)
(BASELINE config 2), or with --batch B detect_keypoints_batch +
extract_descriptors_batch on B such phantoms (the bench one and B - 1
drawn from seeds 101, 102, ...), and prints, per volume or per batch:
 - the wall time of detect and of describe, each ending in a device sync
   (median of --repeats runs, default 7, after a warm-up, with the spread
   between the quartiles), and the same runs' profiling.StageTimes report;
   the input comes from host memory, or with --on-card from a tensor
   already on the card (no upload);
 - the program's own record of those runs (profiling.report: per span,
   the median self time and count a call) and its counters a run (host
   syncs, bytes each way, launches per kernel);
 - the detection funnel (profiling.format_funnel: candidates, rejections
   by stage and survivors per octave and level; of the last volume for a
   batch);
 - from torch.profiler over one more run: device time by kernel, its sum,
   and that sum as a share of the profiled wall time (the device's busy
   share; the rest is host time with the device idle), and the number of
   device operations launched (kernels, copies and fills: the sum of
   `count` over the device events), and the host operations that took
   the most self CPU time; the spans' images on the card's timeline are
   not device work;
 - the card's idle time in that run's detect and describe stages, each
   stretch put down to the innermost program span open on the host then
   (profiling.idle_by_span, on the shared clock), and the share of it
   that a stage span below the calls' roots covers;
 - torch.cuda.max_memory_allocated() over describe, beside what was
   allocated when describe started (the pyramid it reads).
--table PATH also writes the profiler's full table there.

It calls only detect_keypoints and extract_descriptors (or their batch
forms), so a parent/change A/B runs this file in both trees: unpack the
other tree with ``git archive``, copy this file into its tools/, and run
the copies in turn in one call (A, B, B, A); tools/torch_ab_wall.py
alternates the two trees run by run in one process instead.

Usage: python tools/torch_profile.py [--dense] [--size N] [--refine]
                                     [--batch B] [--on-card] [--repeats N]
                                     [--table PATH]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--refine", action="store_true",
                    help="subvoxel refinement and edge rejection on")
    ap.add_argument("--batch", type=int, default=0,
                    help="a batch of this many volumes")
    ap.add_argument("--on-card", action="store_true",
                    help="the input already on the card (no upload)")
    ap.add_argument("--repeats", type=int, default=7,
                    help="runs the wall times are the median of")
    ap.add_argument("--table", metavar="PATH",
                    help="write the full profiler table to this file")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    import sift3d_tpu_torch as st
    from sift3d_tpu_torch import profiling
    from sift3d_tpu_torch.phantoms import bench_volume

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cell = (f"{'dense' if args.dense else 'sparse'}{args.size}"
            f"{' refined' if args.refine else ''}"
            f"{f' batch of {args.batch}' if args.batch else ''}"
            f"{', input on the card' if args.on_card else ''}")
    kind = "dense" if args.dense else "sparse"
    vol = bench_volume(kind, args.size, "cuda").cpu().numpy()
    if args.batch:
        vol = np.stack([vol] + [
            bench_volume(kind, args.size, "cuda", seed=100 + b).cpu().numpy()
            for b in range(1, args.batch)])
    if args.on_card:
        vol = torch.from_numpy(vol).cuda()
    params = (st.DetectorParams(refine_subvoxel=True, edge_thresh=10.0)
              if args.refine else st.DetectorParams())
    det = st.SIFT3D(params, "cuda")
    if args.batch:
        detect, describe = det.detect_keypoints_batch, \
            det.extract_descriptors_batch
    else:
        detect, describe = det.detect_keypoints, det.extract_descriptors

    def run(stages=None):
        stages = stages or profiling.StageTimes()
        t0 = time.perf_counter()
        with stages.stage("detect"):
            kp = detect(vol)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with stages.stage("describe"):
            describe(kp)
            torch.cuda.synchronize()
        n = sum(len(k) for k in kp) if args.batch else len(kp)
        return n, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    run()
    times = profiling.StageTimes()
    runs = [run(times) for _ in range(args.repeats)]
    n_kp = runs[0][0]
    det_ms = statistics.median(r[1] for r in runs)
    desc_ms = statistics.median(r[2] for r in runs)
    tot = [r[1] + r[2] for r in runs]
    q1, _, q3 = (statistics.quantiles(tot, n=4) if len(tot) > 1
                 else (tot[0],) * 3)
    print(f"{cell}: {n_kp} keypoints on {card}")
    print(f"  wall median over {args.repeats}: detect {det_ms:.2f} ms, "
          f"describe {desc_ms:.2f} ms, total {statistics.median(tot):.2f} "
          f"ms (quartiles {q1:.2f}-{q3:.2f})")
    print(f"  StageTimes over the {args.repeats} runs:")
    print("\n".join("    " + line for line in times.report().splitlines()))
    calls = profiling.read()["calls"][-2 * args.repeats:]
    print(f"  the program's spans over the {args.repeats} runs (median self "
          f"time and count a call):")
    print("\n".join("    " + line
                    for line in profiling.report(calls).splitlines()))
    counters = {}
    for c in calls:
        for k, v in c["counters"].items():
            counters[k] = counters.get(k, 0) + v
    print("  counters a run: " + ", ".join(
        f"{k} {v / args.repeats:g}" for k, v in sorted(counters.items())))

    kp = detect(vol)
    print("  detection funnel" + (" (the batch's last volume)"
                                  if args.batch else "") + ":")
    print("\n".join("    " + line for line in profiling.format_funnel(
        profiling.detect_stats(det, kp[-1] if args.batch else kp))
        .splitlines()))

    kp = detect(vol)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    describe(kp)
    torch.cuda.synchronize()
    mib = 2.0 ** 20
    print(f"  describe memory: {base / mib:.1f} MiB allocated at its start, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / mib:.1f}"
          f" MiB")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    # The spans have an image on the card's timeline: not device work.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0
              and e.key not in times.times
              and not e.key.startswith("sift3d.")]
    events.sort(key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in events) / 1e3
    launches = sum(e.count for e in events)
    print(f"  profiled run: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), idle share "
          f"{100 * (1 - busy / wall):.1f}%, {launches} device launches "
          f"(detect + describe)")
    for e in events[:15]:
        print(f"    {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print("  host operations by self CPU time:")
    for e in host[:12]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    full = profiling.read()["full"][-2:]
    idle = profiling.idle_by_span(trace, full, within=("detect", "describe"))
    total = sum(idle.values())
    roots = {s[0][0] for s in full}
    staged = sum(v for k, v in idle.items() if k not in roots | {"_none"})
    print(f"  card idle in the profiled run's detect and describe: "
          f"{total * 1e3:.2f} ms, {100 * staged / max(total, 1e-12):.1f}% "
          f"of it under a stage span; by innermost program span:")
    for k, v in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"    {v * 1e3:9.3f} ms  {k}")
    if args.table:
        out = Path(args.table)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Stage timing, traces and the detection funnel.

The port of sift3d_tpu/profiling.py, with its names and text formats:

 - ``StageTimes.stage(name, sync=...)``: times a block on the host and
   marks it as a ``torch.profiler.record_function`` span, so that it shows
   in a trace; before the clock stops it synchronizes each CUDA device
   that holds a tensor among the leaves of ``sync`` (a pytree, read when
   the block ends: a list or dict the block fills works), and no other.
   The port's Keypoints and Descriptors hold host arrays, which their
   host copy has already waited for: they need no sync.
 - ``StageTimes.report()``: the accumulated times as a table.
 - ``detect_stats`` / ``format_funnel``: the per-(octave, level) funnel
   of the last detection (``SIFT3D._funnel``: candidates, the weak
   gradient, eigenvalue ratio and corner rejections in the reference's
   short-circuit order, sift.c:996-1102, and the survivors), the numbers
   that localize a change of keypoint count to one filter stage.
 - ``trace(log_dir)``: a ``torch.profiler`` trace of the enclosed block,
   host activity and, for a CUDA device, the card's kernels and copies,
   written into log_dir as Chrome-trace JSON (chrome://tracing, Perfetto;
   no TensorBoard needed).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves


def _synchronize(tree) -> None:
    """torch.cuda.synchronize for each CUDA device holding a tensor among
    the leaves of tree."""
    devices = {leaf.device for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor)
               and leaf.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimes:
    """Accumulates wall-clock time per named stage."""

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; the CUDA devices of the tensors in `sync` (an
        optional pytree) are synchronized before the clock stops so device
        work is attributed correctly."""
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync is not None:
                    _synchronize(sync)
                self.times[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'stage':<28}{'ms':>10}{'calls':>8}{'%':>7}"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(
                f"{name:<28}{t * 1e3:>10.2f}{self.counts[name]:>8}"
                f"{pct:>6.1f}%")
        lines.append(f"{'total':<28}{total * 1e3:>10.2f}")
        return "\n".join(lines)


def detect_stats(detector, kp) -> dict:
    """Per-level detection funnel for a completed detect_keypoints call:
    candidates -> grad-reject -> ratio-reject -> corner-reject -> survivors
    per (octave, level), in the reference's short-circuit rejection order
    (assign_eig_ori, sift.c:996-1102)."""
    out = {"num_keypoints": len(kp), "per_level": {}, "funnel": {}}
    oct_lvl = list(zip(kp.octave.tolist(), kp.level.tolist()))
    for o, s in sorted(set(oct_lvl)):
        out["per_level"][f"o{o}s{s}"] = oct_lvl.count((o, s))
    funnel = getattr(detector, "_funnel", None) or {}
    total = {"candidates": 0, "reject_grad": 0, "reject_ratio": 0,
             "reject_corner": 0, "survivors": 0}
    for (o, s), f in sorted(funnel.items()):
        out["funnel"][f"o{o}s{s}"] = dict(f)
        for k in total:
            total[k] += f[k]
    if funnel:
        out["funnel"]["total"] = total
    return out


def format_funnel(stats: dict) -> str:
    """Render detect_stats() as an aligned funnel table."""
    cols = ["candidates", "reject_grad", "reject_ratio", "reject_corner",
            "survivors"]
    lines = [f"{'level':<8}" + "".join(f"{c:>14}" for c in cols)]
    for name, f in stats.get("funnel", {}).items():
        lines.append(f"{name:<8}" + "".join(f"{f[c]:>14}" for c in cols))
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir, device: torch.device | str = "cuda"):
    """Capture a torch.profiler trace of the enclosed block: host activity,
    and the card's where `device` (the detector's) is a CUDA device. The
    trace is written into log_dir as <host>_<pid>.<ns>.pt.trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(
        log_dir / f"{socket.gethostname()}_{os.getpid()}."
                  f"{time.time_ns()}.pt.trace.json"))

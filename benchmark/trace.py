"""Reading a torch.profiler trace of the traced calls.

The profiler's Chrome trace holds the device's kernels, copies and sets
(categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``), the host's
operators (``cpu_op``) and the harness's spans (``user_annotation``).
``summarize`` reduces it to what the per-layer metrics read: the traced
window (from the first ``call`` span's start to the last one's end), the
seconds in which anything ran on the device, the kernels' summed device
time by name, the kernel launches, and the longest idle stretches of the
device, each named by the harness span and the host operator that were
running at its middle (``_python`` where no operator ran).
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(ev: dict) -> str:
    """A device event's name without return type, namespace, template
    arguments and parameters (kernels), in the characters of a name."""
    name = ev.get("name", "")
    if ev.get("cat") == "kernel":
        name = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
        name = re.split(r"[(<]", name, maxsplit=1)[0].strip()
        name = name.split("::")[-1]
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name) or "_"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(path, calls: int, spans=("call",)) -> dict:
    """Summary of the Chrome trace at `path` over `calls` traced calls;
    `spans` are the harness's span names, innermost last, that label an
    idle gap."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") in spans]
    outer = [e for e in ann if e["name"] == "call"]
    if not outer:
        return {}
    w0 = min(e["ts"] for e in outer)
    w1 = max(e["ts"] + e["dur"] for e in outer)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                  for e in dev)
    by_name = defaultdict(float)
    for e in dev:
        by_name[short_name(e)] += e["dur"] * 1e-6
    tid = outer[0].get("tid")
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") == "cpu_op" and e.get("tid") == tid
                 and w0 <= e["ts"] < w1)
    top = []
    for s, e, n in ops:            # outermost operators: disjoint, sorted
        if not top or s >= top[-1][1]:
            top.append((s, e, n))
    starts = [t[0] for t in top]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        span = "_"
        for name in spans:          # innermost named span around the middle
            if any(a["name"] == name and a["ts"] <= mid < a["ts"] + a["dur"]
                   for a in ann):
                span = name
        i = bisect.bisect_right(starts, mid) - 1
        op = top[i][2] if i >= 0 and mid < top[i][1] else "_python"
        gaps[f"{span}:{op}"] += (g1 - g0) * 1e-6
    kernels = sum(1 for e in dev if e.get("cat") == "kernel")
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernel_s": dict(by_name),
        "launches": kernels,
        "calls": calls,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
    }

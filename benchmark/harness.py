"""The harness: one run of one cell, driven by the files this directory
holds (README.md).

A run: make the cell's pool of inputs from the seed on the device, set
the entry up, warm it up on every batch of the pool, then call it in a
closed loop (the next batch when the previous call's results are on the
host) for ``--seconds``. With ``--trace 1`` the loop's spans end in a
device sync, and a further ``TRACE_CALLS`` calls run under
torch.profiler. After the window: the peak device memory, the program's
state freed, the comparison of a sample of the window's answers with
the plain reference (benchmark/checks/), the metrics (one reader each
under benchmark/metrics/), the import guard, and the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import math
import os
import random
import re
import resource
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

from . import guard
from . import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = ROOT / "build" / "bench_out"
TRACE_CALLS = 8
# The harness's spans, outermost first (trace.summarize labels idle gaps
# by the innermost).
SPANS = ("call", "between_calls", "detect", "describe")


def load(kind: str, name: str):
    """The module benchmark/<kind>/<name>.py, loaded by its path."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    modname = f"benchmark.{kind}._" + re.sub(r"\W", "_", name)
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads, with its configuration,
    its traffic and the metrics it reports."""
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def cell_from_manifest(manifest: dict, workload: str, root=ROOT) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(
        name=workload, config=load_json(Path(root) / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in manifest["end_to_end"]
                    if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)])


class Spans:
    """Host-clock spans around the calls into the program's layers, each
    also a profiler label; with sync, a span ends in a device sync."""

    def __init__(self, device: torch.device, sync: bool):
        self.device = device
        self.sync = sync and device.type == "cuda"
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(name):
            t = time.perf_counter()
            try:
                yield
            finally:
                if self.sync:
                    torch.cuda.synchronize(self.device)
                self.times[name].append(time.perf_counter() - t)


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers: the cell, the set-up
    time, the window (its seconds and each call's latency and units), the
    spans of the window's calls, and with tracing the traced calls ((pool
    slot, output) each) and the trace's summary."""
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    traced: list = dataclasses.field(default_factory=list)
    trace: dict | None = None

    @functools.cached_property
    def work(self) -> dict | None:
        """Each layer's bytes and operations over the traced calls
        (metrics/_roofline.py), or None without a trace."""
        if not self.traced:
            return None
        from .metrics import _roofline
        return _roofline.traced_work(self)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    """The card's name and power limit, and its clock, temperature and
    draw, as nvidia-smi gives them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                            "clocks.sm,temperature.gpu,power.draw",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, log=print) -> dict:
    """One run of `cell`; returns the result object of the last line.
    `log` takes the lines printed before it (standard error)."""
    dev = torch.device(device)
    gen = load("generators", cell.traffic["generator"])
    entry = load("entries", cell.traffic["entry"])
    check = load("checks", cell.traffic["check"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    marks = [("imports and device", time.perf_counter())]
    pool = gen.make(cell.traffic["params"], seed, dev)
    _sync(dev)
    marks.append(("inputs", time.perf_counter()))
    state = entry.setup(cell.config, dev)
    quiet = Spans(dev, sync=False)
    for k in range(2):               # every shape of the cell, twice
        for batch in pool:
            entry.call(state, batch, quiet)
        _sync(dev)
        marks.append((f"warm-up {k + 1}", time.perf_counter()))
    run = Run(cell)
    run.setup_s = time.perf_counter() - t_start
    log("set-up: " + ", ".join(f"{name} {t - prev:.3f} s"
                               for (name, t), prev in zip(
                                   marks, [t_start] + [t for _, t in marks])))
    for line in entry.describe(state):
        log(line)

    # The measured window: a closed loop over the pool's batches in turn.
    spans = Spans(dev, sync=trace)
    rng = random.Random(seed)
    kept = [None] * len(pool)        # one call a slot, drawn from the seed
    seen = [0] * len(pool)
    counts = []
    faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
    host_load = os.getloadavg()[0]
    t0 = time.perf_counter()
    i = 0
    while True:
        slot = i % len(pool)
        ts = time.perf_counter()
        out = entry.call(state, pool[slot], spans)
        te = time.perf_counter()
        run.calls.append((te - ts, out["units"]))
        counts.append(out["counts"])
        seen[slot] += 1
        if rng.randrange(seen[slot]) == 0:
            kept[slot] = (i, out)
        i += 1
        if te - t0 >= seconds and i >= len(pool):
            break
    run.window_s = te - t0
    faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - faults
    run.spans = dict(spans.times)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    if trace:
        run.traced, run.trace = _traced_calls(entry, state, pool, dev,
                                              cell.name)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    log(f"window: {len(run.calls)} calls in {run.window_s:.4f} s; "
        f"set-up {run.setup_s:.4f} s; peak device memory {peak} bytes; "
        f"{faults / len(run.calls):.0f} host page faults a call; host "
        f"load {host_load:.2f} -> {os.getloadavg()[0]:.2f} on "
        f"{len(os.sched_getaffinity(0))} cores, {torch.get_num_threads()} "
        f"torch threads; card {card_line() if dev.type == 'cuda' else dev.type}")
    for slot in [None] + list(range(len(pool))):
        lat = sorted(t for j, (t, _) in enumerate(run.calls)
                     if slot is None or j % len(pool) == slot)
        at = [lat[min(len(lat) - 1, int(q / 100 * len(lat)))]
              for q in (0, 10, 50, 90, 95, 99, 100)]
        log(f"call latency ms{'' if slot is None else f' (slot {slot})'}: "
            "p0, p10, p50, p90, p95, p99, p100 "
            + ", ".join(f"{1e3 * t:.3f}" for t in at))
    for key in sorted({k for c in counts for k in c}):
        vals = sorted(c[key] for c in counts)
        log(f"per call {key}: min {vals[0]} median "
            f"{vals[len(vals) // 2]} max {vals[-1]}")
    sample = [(slot, k[0], k[1]) for slot, k in enumerate(kept) if k]
    t_check = time.perf_counter()
    compared = check.compare(sample, pool, cell.config, seed, dev, log,
                             **cell.traffic.get("check_params", {}))
    correct = all(v <= lim for v, lim in compared.values())
    log(f"check: {time.perf_counter() - t_check:.3f} s; host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": cell.chips,
        "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(run.calls),
              "failed": 0 if correct else len(sample),
              "metrics": metrics, "device": device_info}
    if trace and run.trace:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {
            "device_ops": [list(kv) for kv in run.trace["device_ops"]],
            "idle_gaps": [list(kv) for kv in run.trace["idle_gaps"]]}
    # A NaN or an infinite reading is written as text: JSON has no number
    # for it.
    result["compared"] = {
        k: {"value": v if math.isfinite(v) else str(v), "limit": lim}
        for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        log(f"compared {k}: {v!r} (limit {lim!r})"
            f"{'' if v <= lim else ' FAILED'}")
    return result


def _traced_calls(entry, state, pool, dev, name):
    """TRACE_CALLS calls in a closed loop under torch.profiler: their
    (slot, output) and the trace's summary."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    spans = Spans(dev, sync=True)
    traced = []
    with torch.profiler.profile(activities=acts) as prof:
        for j in range(TRACE_CALLS):
            with torch.profiler.record_function("call"):
                out = entry.call(state, pool[j % len(pool)], spans)
            with torch.profiler.record_function("between_calls"):
                traced.append((j % len(pool), out))
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"trace.{name}.json"
    prof.export_chrome_trace(str(path))
    try:
        summary = trace_mod.summarize(path, TRACE_CALLS, SPANS)
    finally:
        path.unlink(missing_ok=True)
    return traced, summary


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(line):
        print(line, file=sys.stderr, flush=True)

    bad = guard.forbidden_modules()
    if bad:
        log(f"benchmark: modules of JAX or the JAX package loaded: {bad}")
        return 3
    cell = cell_from_manifest(load_json(ROOT / "BENCHMARK.json"),
                              args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
            f"found {found}")
        return 2
    from .metrics import _roofline
    log(f"roofline peaks {_roofline.PEAKS}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start, log)
    bad = guard.forbidden_modules()
    if bad:
        log(f"benchmark: modules of JAX or the JAX package loaded: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


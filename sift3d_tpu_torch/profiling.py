"""Spans, counters, stage timing, traces and the detection funnel.

The recorder (process-wide: a call records the spans and counts of the
thread that opened it; the totals are shared under a lock):

 - ``span(name)`` is a context manager that stamps its start and end on
   one host clock (``time.perf_counter_ns``) and records its parent. A
   public call of ``SIFT3D`` (``detect_keypoints[_batch]``,
   ``extract_descriptors[_batch]``) opens a root span,
   ``span(name, root=True)``; every span opened inside it belongs to that
   call. While a ``torch.profiler`` is running, each span is also a
   ``torch.profiler.record_function`` of the same name, so that it sits in
   the trace beside the card's kernels; with no profiler running it is only
   the in-memory record (a record_function costs ~10x a bare span even
   with the profiler off).
 - ``count(name, n)`` adds to a counter of the current call and to its
   process-wide total (``counter(name)``): ``host_syncs``, ``h2d_async``,
   ``h2d_bytes``, ``d2h_bytes``, ``launch.<kernel symbol>``
   (ops/_build.call) and ``kernels.builds``.
 - ``to_device``, ``to_host`` and ``read_int`` are the main path's
   host-device crossings, each inside a span (``sift3d.to_device``,
   ``sift3d.to_host``, ``sift3d.read_int``) that counts its bytes. An
   upload is stream-ordered: staged in pinned memory, it waits for
   nothing and counts one ``h2d_async``. A copy home waits for the work
   queued before it, since the host reads its value, and counts one
   ``host_syncs``; the rows and descriptors land in pinned memory. On the
   CPU the helpers copy nothing and count nothing.
 - ``read()``: the last RING_CALLS calls' records (per span name: count,
   host time and self time, the time outside its child spans; per counter:
   its total), the full span lists with stamps of the last FULL_CALLS
   calls, and the process-wide totals. ``report()`` renders the per-stage
   medians in ``StageTimes.report``'s layout.
 - ``trace_clock(trace)`` maps a span's stamp onto a torch.profiler Chrome
   trace's ``ts`` (its ``ts + baseTimeNanoseconds / 1000`` is Unix time in
   microseconds); ``idle_by_span`` puts each idle stretch of the card in
   such a trace down to the innermost span that was open on the host.

The port of sift3d_tpu/profiling.py, with its names and text formats:

 - ``StageTimes.stage(name, sync=...)``: times a block on the host as a
   span of the recorder; before the clock stops it synchronizes each CUDA
   device that holds a tensor among the leaves of ``sync`` (a pytree, read
   when the block ends: a list or dict the block fills works), and no
   other. The port's Keypoints and Descriptors hold host arrays, which
   their host copy has already waited for: they need no sync.
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
import statistics
import threading
import time
from collections import defaultdict, deque
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves

# Calls whose records the ring keeps (a fixed constant, not a setting).
RING_CALLS = 4096
# Calls whose full span lists, with stamps, are kept.
FULL_CALLS = 32
# Device event categories of a torch.profiler Chrome trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# A record_function's enter and exit, without the Python class around
# them (its event in the trace is the same, at a quarter of the cost).
_rf_enter = torch._C._autograd._record_function_with_args_enter
_rf_exit = torch._C._autograd._record_function_with_args_exit
_now = time.perf_counter_ns

_lock = threading.Lock()          # guards the process-wide records
_calls: deque = deque(maxlen=RING_CALLS)
_full: deque = deque(maxlen=FULL_CALLS)
_thread_counters: list = []       # each thread's counter totals
_span_totals: dict = {}           # name -> [count, ns]


class _Thread(threading.local):
    """A thread's open call (None outside one) and its counter totals."""

    def __init__(self):
        self.call = None
        self.counters = defaultdict(int)
        with _lock:
            _thread_counters.append(self.counters)


_tls = _Thread()


class _Call:
    """A public call being recorded: its spans [name, parent, t0, t1]
    (index 0 the root), the stack of open ones and its counters."""
    __slots__ = ("spans", "stack", "counters")

    def __init__(self, name: str, t0: int):
        self.spans = [[name, -1, t0, 0]]
        self.stack = [0]
        self.counters = defaultdict(int)


class span:
    """``with span(name):`` a stamped span of the recorder (the module
    docstring); ``root=True`` for a public call, which opens a call's
    record unless one is open in this thread (a public call inside
    another is a span of the outer one)."""
    __slots__ = ("name", "root", "_rf", "_call", "_i", "_t0")

    def __init__(self, name: str, root: bool = False):
        self.name = name
        self.root = root

    def __enter__(self):
        self._rf = (_rf_enter(self.name)
                    if _autograd_profiler._is_profiler_enabled else None)
        call = _tls.call
        t = _now()
        if call is not None:
            self._i = i = len(call.spans)
            call.spans.append([self.name, call.stack[-1], t, 0])
            call.stack.append(i)
        elif self.root:
            call = _tls.call = _Call(self.name, t)
            self._i = 0
        else:
            self._t0 = t
        self._call = call
        return self

    def __exit__(self, *exc):
        t = _now()
        call = self._call
        if call is None:
            with _lock:
                tot = _span_totals.setdefault(self.name, [0, 0])
                tot[0] += 1
                tot[1] += t - self._t0
        else:
            call.spans[self._i][3] = t
            call.stack.pop()
            if self._i == 0:
                _tls.call = None
                _close(call)
        if self._rf is not None:
            _rf_exit(self._rf)
        return False


def _close(call: _Call) -> None:
    """The closed call's record into the ring, its span list into the
    full lists, its spans into the process-wide totals. Both are kept as
    tuples and dicts of numbers and names, which the garbage collector
    stops tracking: records that live for many calls then add nothing to
    its full collections."""
    spans = call.spans
    own = [t1 - t0 for _, _, t0, t1 in spans]
    for _, parent, t0, t1 in spans[1:]:
        own[parent] -= t1 - t0
    agg = {}
    for (name, _, t0, t1), s in zip(spans, own):
        a = agg.get(name)
        if a is None:
            a = agg[name] = [0, 0, 0]
        a[0] += 1
        a[1] += t1 - t0
        a[2] += s
    root = spans[0]
    record = {"root": root[0], "t0": root[2], "t1": root[3],
              "spans": {k: tuple(v) for k, v in agg.items()},
              "counters": dict(call.counters)}
    full = tuple(map(tuple, spans))
    with _lock:
        for name, (n, ns, _) in agg.items():
            tot = _span_totals.setdefault(name, [0, 0])
            tot[0] += n
            tot[1] += ns
        _calls.append(record)
        _full.append(full)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the current call and to its total."""
    t = _tls
    t.counters[name] += n
    if t.call is not None:
        t.call.counters[name] += n


def _crossed(kind: str, bytes_name: str, nbytes: int) -> None:
    """count(kind) and count(bytes_name, nbytes), at once."""
    for c in ((_tls.counters,) if _tls.call is None
              else (_tls.counters, _tls.call.counters)):
        c[kind] += 1
        c[bytes_name] += nbytes


def counter(name: str) -> int:
    """The process-wide total of counter `name`."""
    with _lock:
        return sum(c.get(name, 0) for c in _thread_counters)


def to_device(x, dtype=None, device=None) -> torch.Tensor:
    """torch.as_tensor(x, dtype=dtype, device=device). Host memory bound
    for a CUDA device is copied into a pinned block of torch's caching
    host allocator and from there onto the device's current stream
    without a wait, inside a span that counts one h2d_async and the
    bytes (h2d_bytes). The caller may change x as soon as this returns;
    the allocator hands the block out again only once its copy has run."""
    if (device is None
            or (device if isinstance(device, torch.device)
                else torch.device(device)).type != "cuda"
            or (isinstance(x, torch.Tensor) and x.device.type != "cpu")):
        return torch.as_tensor(x, dtype=dtype, device=device)
    with span("sift3d.to_device"):
        src = torch.as_tensor(x, dtype=dtype)
        staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        staged.copy_(src)
        out = staged.to(device, non_blocking=True)
    _crossed("h2d_async", "h2d_bytes", out.nbytes)
    return out


def to_host(t: torch.Tensor) -> torch.Tensor:
    """t.cpu(); from a CUDA device into pinned memory, waiting once for
    t's stream, inside a span that counts one host sync and the copy's
    bytes (d2h_bytes)."""
    if t.device.type != "cuda":
        return t.cpu()
    with span("sift3d.to_host"):
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
    _crossed("host_syncs", "d2h_bytes", out.nbytes)
    return out


def read_int(t: torch.Tensor) -> int:
    """int(t) of a one-element tensor; from a CUDA device, inside a span
    that counts one host sync and the element's bytes (d2h_bytes)."""
    if t.device.type != "cuda":
        return int(t)
    with span("sift3d.read_int"):
        n = int(t)
    _crossed("host_syncs", "d2h_bytes", t.element_size())
    return n


def read() -> dict:
    """The recorder's contents: "calls", the records of the last
    RING_CALLS public calls, oldest first ({"root": name, "t0", "t1":
    stamps in ns, "spans": {name: (count, ns, self ns)}, "counters":
    {name: total}}); "full", the span lists (name, parent index, t0, t1)
    of the last FULL_CALLS calls (index 0 the root); "counters" and
    "spans" ({name: [count, ns]}), the process-wide totals."""
    with _lock:
        counters = defaultdict(int)
        for c in _thread_counters:
            for k, v in list(c.items()):
                counters[k] += v
        return {"calls": list(_calls), "full": [list(s) for s in _full],
                "counters": dict(counters),
                "spans": {k: list(v) for k, v in _span_totals.items()}}


def report(calls=None) -> str:
    """Per span name, its self time (the time outside its child spans, so
    that the rows add up to the calls' time) and its count, each the median
    over the calls of one root name, added over the root names (a detect
    call plus a describe call), in StageTimes.report's layout; of `calls`
    (default: the recorded ones, read()["calls"])."""
    calls = read()["calls"] if calls is None else calls
    by_root = defaultdict(list)
    for c in calls:
        by_root[c["root"]].append(c["spans"])
    table = StageTimes()
    for group in by_root.values():
        for name in {n for spans in group for n in spans}:
            n, _, own = zip(*(spans.get(name, (0, 0, 0)) for spans in group))
            table.times[name] += statistics.median(own) * 1e-9
            table.counts[name] += int(statistics.median(n))
    return table.report()


def trace_clock(trace: dict):
    """A function from a span's stamp (ns, the recorder's clock) to the
    ``ts`` (us) of the torch.profiler Chrome trace `trace` (its parsed
    JSON), whose ``ts + baseTimeNanoseconds / 1000`` is Unix time in us."""
    offset = time.time_ns() - time.perf_counter_ns()
    base = int(trace.get("baseTimeNanoseconds", 0))
    return lambda ns: (ns + offset - base) * 1e-3


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_by_span(trace: dict, spans=None, within=None) -> dict:
    """Seconds in which nothing ran on the card (no kernel, copy or set in
    the Chrome trace `trace`, parsed), each put down to the innermost
    recorded span open on the host then ("_none" where none was): of the
    span lists `spans` (default: read()["full"]), inside the trace's
    user_annotation events named in `within` (default: the spans' roots).
    The span lists are laid onto the trace by trace_clock."""
    spans = read()["full"] if spans is None else spans
    to_ts = trace_clock(trace)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    if within is None:
        windows = [(to_ts(s[0][2]), to_ts(s[0][3])) for s in spans if s]
    else:
        windows = [(e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in within]
    busy = _merge((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in DEVICE_CATS)
    idle = []
    for w0, w1 in _merge(windows):
        t = w0
        for b0, b1 in busy:
            if b1 <= t or b0 >= w1:
                continue
            if b0 > t:
                idle.append((t, b0))
            t = max(t, b1)
        if t < w1:
            idle.append((t, w1))
    # Span boundaries: (time, 0 end / 1 start, depth order, name).
    marks = []
    for lst in spans:
        depth = []
        for name, parent, t0, t1 in lst:
            d = depth[parent] + 1 if parent >= 0 else 0
            depth.append(d)
            marks.append((to_ts(t0), 1, d, name))
            marks.append((to_ts(t1), 0, -d, name))
    marks.sort()
    out = defaultdict(float)
    stack, k = [], 0
    for g0, g1 in idle:
        while k < len(marks) and marks[k][0] <= g0:
            _, start, _, name = marks[k]
            stack.append(name) if start else stack.pop()
            k += 1
        t = g0
        while k < len(marks) and marks[k][0] < g1:
            out[stack[-1] if stack else "_none"] += marks[k][0] - t
            t, start, _, name = marks[k]
            stack.append(name) if start else stack.pop()
            k += 1
        out[stack[-1] if stack else "_none"] += g1 - t
    return {k: v * 1e-6 for k, v in out.items()}


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
        with span(name):
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

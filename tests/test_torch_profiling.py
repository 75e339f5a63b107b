"""The port's profiling module and detection funnel against the JAX
package's (sift3d_tpu/profiling.py, SIFT3D._funnel).

The JAX funnels come from one child process whose XLA:CPU is capped at
SSE4.2 (see test_torch_pipeline.py), at the JAX package's default
parameters and with both extensions on, on the 48^3 phantom of
tests/test_detect.py's funnel test."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_phantom  # noqa: E402

import sift3d_tpu_torch as st  # noqa: E402
from sift3d_tpu_torch import profiling  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CASES = {"default": {},
         "refined": {"refine_subvoxel": True, "edge_thresh": 10.0}}
COLS = ("candidates", "reject_grad", "reject_ratio", "reject_corner",
        "survivors")

_CHILD = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
from conftest import make_phantom
from sift3d_tpu import DetectorParams, SIFT3D
cfg = json.loads(sys.argv[1])
out = {}
for name, knobs in cfg["cases"].items():
    det = SIFT3D(DetectorParams(**knobs))
    kp = det.detect_keypoints(make_phantom(48))
    out[name] = {"num_keypoints": len(kp),
                 "funnel": [[o, s, f] for (o, s), f in det._funnel.items()]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_funnels():
    """{case: (keypoint count, {(octave, level): counts})} of the JAX
    SIFT3D, from one child process."""
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=SSE4_2").strip())
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", _CHILD,
                        json.dumps({"cases": CASES})],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    return {name: (v["num_keypoints"],
                   {(o, s): f for o, s, f in v["funnel"]})
            for name, v in got.items()}


@pytest.fixture(scope="module")
def port_runs():
    """{case: (detector, keypoints)} of the port on the CPU."""
    out = {}
    for name, knobs in CASES.items():
        det = st.SIFT3D(st.DetectorParams(**knobs), "cpu")
        out[name] = (det, det.detect_keypoints(make_phantom(48)))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_funnel_equals_jax(jax_funnels, port_runs, name):
    """Count for count, every (octave, level), in JAX's key order."""
    n_jax, ref = jax_funnels[name]
    det, kp = port_runs[name]
    assert len(kp) == n_jax
    assert ref, "JAX collected no funnel"
    assert list(det._funnel) == list(ref)
    assert det._funnel == ref
    assert sum(f["survivors"] for f in det._funnel.values()) == len(kp)


@pytest.mark.parametrize("name", list(CASES))
def test_detect_stats_equal_jax_on_port_detector(port_runs, name):
    """The JAX package's detect_stats and format_funnel give the port's
    output on the port's own detector and keypoints."""
    from sift3d_tpu import profiling as jprof
    det, kp = port_runs[name]
    stats = profiling.detect_stats(det, kp)
    assert stats == jprof.detect_stats(det, kp)
    assert json.dumps(stats) == json.dumps(jprof.detect_stats(det, kp))
    assert profiling.format_funnel(stats) == jprof.format_funnel(stats)


def test_funnel_consistency(port_runs):
    """tests/test_detect.py:108-132 on the port's stats: candidates - grad
    - ratio - corner == survivors, per level and in total; survivors sum
    to the keypoint count."""
    det, kp = port_runs["default"]
    stats = profiling.detect_stats(det, kp)
    assert stats["funnel"], "funnel not collected"
    total = stats["funnel"]["total"]
    assert (total["candidates"] - total["reject_grad"]
            - total["reject_ratio"] - total["reject_corner"]
            == total["survivors"])
    assert total["survivors"] == len(kp)
    for name, f in stats["funnel"].items():
        assert (f["candidates"] - f["reject_grad"] - f["reject_ratio"]
                - f["reject_corner"] == f["survivors"]), name
    assert "candidates" in profiling.format_funnel(stats)


def test_edge_rejections_count_as_candidates_only(port_runs):
    """With the edge test on, a candidate it drops is a candidate and
    survives no stage: the stage counts then leave the edge rejections
    over, as JAX's do."""
    det, kp = port_runs["refined"]
    for f in det._funnel.values():
        left = (f["candidates"] - f["reject_grad"] - f["reject_ratio"]
                - f["reject_corner"] - f["survivors"])
        assert left >= 0
    assert sum(f["survivors"] for f in det._funnel.values()) == len(kp)


def test_text_formats_equal_jax():
    """format_funnel and StageTimes.report give JAX's text on the same
    input dicts."""
    from sift3d_tpu import profiling as jprof
    rng = np.random.default_rng(7)
    funnel = {f"o{o}s{s}": {c: int(v) for c, v in
                            zip(COLS, rng.integers(0, 5000, 5))}
              for o in range(3) for s in range(3)}
    stats = {"num_keypoints": 3, "per_level": {}, "funnel": funnel}
    assert profiling.format_funnel(stats) == jprof.format_funnel(stats)
    assert profiling.format_funnel({}) == jprof.format_funnel({})
    ours, theirs = profiling.StageTimes(), jprof.StageTimes()
    for name, t, n in (("detect", 0.0123456, 3), ("describe", 0.25, 1),
                       ("a stage with a long name!", 1e-6, 7)):
        for st_ in (ours, theirs):
            st_.times[name] = t
            st_.counts[name] = n
    assert ours.report() == theirs.report()
    assert profiling.StageTimes().report() == jprof.StageTimes().report()


def test_stage_times_and_syncs_no_cpu_device(monkeypatch):
    """A stage whose sync holds CPU tensors, arrays and the port's
    Keypoints never touches CUDA."""
    def boom(*a, **k):
        raise AssertionError("torch.cuda.synchronize called")
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    times = profiling.StageTimes()
    out = []
    with times.stage("detect", sync=out):
        out.append(torch.ones(4) * 2)
        out.append({"a": np.zeros(3), "kp": st.Keypoints.empty()})
    with times.stage("detect", sync=torch.zeros(2)):
        pass
    with times.stage("describe"):
        pass
    assert times.counts == {"detect": 2, "describe": 1}
    assert all(t >= 0.0 for t in times.times.values())
    assert times.report().splitlines()[0].startswith("stage")


def test_stage_syncs_each_cuda_device_once(monkeypatch):
    """The devices synchronized are exactly the CUDA devices of the
    tensors in sync (fake CUDA leaves: no card here)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)

    def on(dev):
        leaf = type("Leaf", (torch.Tensor,),
                    {"device": property(lambda self: torch.device(dev))})
        return torch.zeros(1).as_subclass(leaf)
    tree = [on("cuda:1"), {"x": on("cuda:1"), "y": on("cpu")}]
    with profiling.StageTimes().stage("x", sync=tree):
        pass
    assert synced == [torch.device("cuda:1")]


def test_trace_writes_a_span(tmp_path):
    """trace() writes a Chrome-trace JSON in which the stages' spans
    appear around the detection's host work."""
    det = st.SIFT3D(st.DetectorParams(), "cpu")
    times = profiling.StageTimes()
    with profiling.trace(tmp_path, device="cpu"):
        res = {}
        with times.stage("detect", sync=res):
            res["kp"] = det.detect_keypoints(make_phantom(32))
        with times.stage("describe", sync=res):
            res["desc"] = det.extract_descriptors(res["kp"])
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert {"detect", "describe"} <= set(spans)
    d, x = spans["detect"], spans["describe"]
    assert d["ts"] + d["dur"] <= x["ts"]
    assert times.counts == {"detect": 1, "describe": 1}


def test_batch_leaves_the_last_volumes_funnel():
    """After detect_keypoints_batch, _funnel is the last volume's, as the
    JAX SIFT3D's (each volume's assembly replaces it,
    sift3d_tpu/pipeline.py:1420-1490); over a mesh axis too."""
    from sift3d_tpu_torch.parallel import MeshBatchSIFT3D, make_mesh
    vols = [make_phantom(32), np.ascontiguousarray(make_phantom(32)[::-1])]
    single = []
    for v in vols:
        det = st.SIFT3D(st.DetectorParams(), "cpu")
        det.detect_keypoints(v)
        single.append(det._funnel)
    assert single[0] != single[1]
    det = st.SIFT3D(st.DetectorParams(), "cpu")
    det.detect_keypoints_batch(np.stack(vols))
    assert det._funnel == single[1]
    mesh = MeshBatchSIFT3D(st.DetectorParams(),
                           make_mesh({"b": 2}, ["cpu", "cpu"]))
    mesh.detect_keypoints_batch(np.stack(vols))
    assert mesh._funnel == single[1]


def test_no_candidates_leaves_an_empty_funnel():
    det = st.SIFT3D(st.DetectorParams(), "cpu")
    kp = det.detect_keypoints(np.zeros((24, 24, 24), np.float32))
    assert len(kp) == 0 and det._funnel == {}
    assert profiling.detect_stats(det, kp)["funnel"] == {}


def test_sharded_detector_keeps_no_funnel():
    """JAX's ShardedSIFT3D keeps no funnel; neither does the port's."""
    from sift3d_tpu_torch.parallel import ShardedSIFT3D, make_mesh
    det = ShardedSIFT3D(st.DetectorParams(), make_mesh({"z": 2},
                                                       ["cpu", "cpu"]))
    kp = det.detect_keypoints(make_phantom(32))
    assert profiling.detect_stats(det, kp)["funnel"] == {}



FUNNEL_GOLDEN = REPO / "tests" / "data" / "torch_golden_funnel.json"


@pytest.mark.parametrize("cell", ["sparse256", "dense256", "sparse192",
                                  "aniso128", "refine128"])
def test_funnel_golden_agrees_with_keypoint_golden(cell):
    """The JAX funnels chip_smoke.py holds the card to survive, per octave
    and level, into exactly the keypoints of the cell's own golden file,
    and each level's rejections leave its survivors (or, with the edge
    test on, at least them)."""
    gold = json.loads(FUNNEL_GOLDEN.read_text())[cell]
    kp = np.load(REPO / "tests" / "data" / f"torch_golden_{cell}.npz")
    assert gold["size"] == int(kp["size"])
    assert gold["num_keypoints"] == len(kp["coords"])
    per_level = {}
    for o, s in zip(kp["octave"].tolist(), kp["level"].tolist()):
        per_level[(o, s)] = per_level.get((o, s), 0) + 1
    funnel = {(o, s): f for o, s, f in gold["funnel"]}
    assert {k: f["survivors"] for k, f in funnel.items()
            if f["survivors"]} == per_level
    assert list(funnel) == sorted(funnel)
    for f in funnel.values():
        left = (f["candidates"] - f["reject_grad"] - f["reject_ratio"]
                - f["reject_corner"])
        assert (left >= f["survivors"] if gold["extensions"]
                else left == f["survivors"])


# -- the recorder ----------------------------------------------------------

HARNESS_NAMES = {"call", "between_calls", "detect", "describe"}


def _inside_parents(spans):
    """Every span of a call's list lies inside its parent."""
    for name, parent, t0, t1 in spans[1:]:
        assert 0 <= parent < len(spans), name
        _, _, p0, p1 = spans[parent]
        assert p0 <= t0 <= t1 <= p1, (name, spans[parent][0])


def test_batch_records_one_root_per_public_call():
    """A small CPU batch detect + describe, and a single volume's: one
    record a public call, rooted at its name, every span inside its parent,
    every name the recorder's own (never a name of the harness's spans)."""
    vols = np.stack([make_phantom(32),
                     np.ascontiguousarray(make_phantom(32)[::-1])])
    det = st.SIFT3D(st.DetectorParams(), "cpu")
    kps = det.detect_keypoints_batch(vols)
    det.extract_descriptors_batch(kps)
    kp = det.detect_keypoints(vols[0])
    det.extract_descriptors(kp)
    calls = profiling.read()["calls"][-4:]
    assert [c["root"] for c in calls] == [
        "sift3d.detect_batch", "sift3d.describe_batch", "sift3d.detect",
        "sift3d.describe"]
    full = profiling.read()["full"][-4:]
    assert [s[0][0] for s in full] == [c["root"] for c in calls]
    for call, spans in zip(calls, full):
        _inside_parents(spans)
        assert spans[0][1] == -1
        names = {s[0] for s in spans}
        assert all(n.startswith("sift3d.") for n in names)
        assert not names & HARNESS_NAMES
        assert set(call["spans"]) == names
        for name, (n, ns, own) in call["spans"].items():
            assert n == sum(s[0] == name for s in spans)
            assert 0 <= own <= ns
        # self times add up to the root's time
        assert sum(own for _, _, own in call["spans"].values()) == \
            call["t1"] - call["t0"]
        assert call["counters"].get("host_syncs", 0) == 0   # the CPU
    detect = {s[0] for s in full[0]}
    assert {"sift3d.detect.plan", "sift3d.detect.upload_scale",
            "sift3d.detect.pyramid", "sift3d.detect.extrema",
            "sift3d.detect.orientation", "sift3d.detect.rows_home",
            "sift3d.detect.assembly"} <= detect
    describe = {s[0] for s in full[1]}
    assert {"sift3d.describe.check", "sift3d.describe.gather",
            "sift3d.describe.histograms", "sift3d.describe.normalize",
            "sift3d.describe.scatter"} <= describe
    assert len(full[0]) + len(full[1]) <= 100


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler running, the path and StageTimes never enter a
    torch.profiler.record_function."""
    def boom(*a, **k):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(profiling, "_rf_enter", boom)
    det = st.SIFT3D(st.DetectorParams(), "cpu")
    times = profiling.StageTimes()
    with times.stage("detect"):
        kp = det.detect_keypoints(make_phantom(32))
    det.extract_descriptors(kp)
    assert times.counts == {"detect": 1}


def test_spans_map_onto_the_trace(tmp_path):
    """Under profiling.trace, each span of the recorded calls is also a
    user_annotation of the trace, and trace_clock lays the recorder's
    stamps onto it within 0.5 ms."""
    det = st.SIFT3D(st.DetectorParams(), "cpu")
    kp = det.detect_keypoints(make_phantom(32))      # warm
    with profiling.trace(tmp_path, device="cpu"):
        kp = det.detect_keypoints(make_phantom(32))
        det.extract_descriptors(kp)
    full = profiling.read()["full"][-2:]
    trace = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())
    to_ts = profiling.trace_clock(trace)
    ann = {}
    for e in sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        ann.setdefault(e["name"], []).append(e)
    seen = {}
    n = 0
    for spans in full:
        for name, _, t0, t1 in spans:
            k = seen[name] = seen.get(name, -1) + 1
            e = ann[name][k]
            assert abs(to_ts(t0) - e["ts"]) < 500, name
            assert abs(to_ts(t1) - (e["ts"] + e["dur"])) < 500, name
            n += 1
    assert n == sum(len(v) for k, v in ann.items() if k.startswith("sift3d."))


def test_ring_stays_bounded():
    """The ring keeps the last RING_CALLS calls, the full span lists the
    last FULL_CALLS; counters add up within a call and in total."""
    base = profiling.counter("test.ticks")
    for i in range(profiling.RING_CALLS + 5):
        with profiling.span("sift3d.detect", root=True):
            with profiling.span("sift3d.detect.plan"):
                profiling.count("test.ticks", 2)
            profiling.count("test.ticks")
    r = profiling.read()
    assert len(r["calls"]) == profiling.RING_CALLS
    assert len(r["full"]) == profiling.FULL_CALLS
    assert r["calls"][-1]["counters"] == {"test.ticks": 3}
    assert profiling.counter("test.ticks") - base == \
        3 * (profiling.RING_CALLS + 5)
    assert all(len(s) == 2 for s in r["full"])


def test_nested_public_call_and_loose_spans():
    """A public call inside another is a span of the outer call; a span
    outside any call is kept only in the totals."""
    t = profiling.read()["spans"].get("loose", [0, 0])[0]
    with profiling.span("loose"):
        with profiling.span("sift3d.describe", root=True):
            with profiling.span("sift3d.detect", root=True):
                pass
    last = profiling.read()["calls"][-1]
    assert last["root"] == "sift3d.describe"
    assert last["spans"]["sift3d.detect"][0] == 1
    assert profiling.read()["full"][-1][1][:2] == ("sift3d.detect", 0)
    assert profiling.read()["spans"]["loose"][0] == t + 1


def test_report_has_stage_times_layout():
    """report() gives per span name the median self time and count over
    each root's calls (a span a call lacks counts 0 there), added over the
    roots, in StageTimes.report's layout."""
    ms = 1_000_000
    calls = [{"root": "sift3d.detect", "t0": 0, "t1": 0,
              "spans": {"sift3d.detect": [1, 9 * ms, 1 * ms],
                        "sift3d.detect.plan": [k, 8 * ms, (8 + k) * ms],
                        "sift3d.to_device": [2 * k, ms, ms]},
              "counters": {}} for k in (1, 2, 3)]
    calls += [{"root": "sift3d.describe", "t0": 0, "t1": 0,
               "spans": {"sift3d.describe": [1, 5 * ms, 4 * ms]}
               | ({"sift3d.to_device": [4, ms, ms]} if k else {}),
               "counters": {}} for k in (0, 1, 1)]
    text = profiling.report(calls)
    ref = profiling.StageTimes()
    ref.times.update({"sift3d.detect": 1e-3, "sift3d.detect.plan": 10e-3,
                      "sift3d.to_device": 2e-3, "sift3d.describe": 4e-3})
    ref.counts.update({"sift3d.detect": 1, "sift3d.detect.plan": 2,
                       "sift3d.to_device": 4 + 4, "sift3d.describe": 1})
    assert text == ref.report()


def test_crossings_on_the_cpu_copy_and_count_nothing():
    """On the CPU the helpers stage nothing: a tensor already there comes
    back as the same object, and neither host_syncs nor h2d_async (nor
    any other counter) moves."""
    before = profiling.read()["counters"]
    a = np.arange(6, dtype=np.float64)
    t = profiling.to_device(a, torch.float32, "cpu")
    assert t.dtype == torch.float32 and t.tolist() == a.tolist()
    assert profiling.to_device(t, torch.float32, "cpu") is t
    assert profiling.to_device(t, None, torch.device("cpu")) is t
    assert profiling.to_device(t) is t
    assert profiling.to_host(t) is t
    assert profiling.read_int(torch.tensor([5])[0]) == 5
    assert profiling.read()["counters"] == before


def test_idle_by_span_on_a_synthetic_trace(monkeypatch):
    """Idle stretches of the card inside the windows, each put down to the
    innermost span open on the host; trace_clock maps a stamp to the trace
    by the host clocks' offset and the trace's base time."""
    base = 1_700_000_000 * 10 ** 9
    monkeypatch.setattr(profiling.time, "time_ns", lambda: base + 7)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: 7)

    def ns(t_us):       # the stamp that trace_clock maps to t_us
        return t_us * 1000

    spans = [[["sift3d.detect", -1, ns(0), ns(100)],
              ["sift3d.detect.plan", 0, ns(10), ns(30)],
              ["sift3d.to_device", 1, ns(20), ns(25)],
              ["sift3d.detect.assembly", 0, ns(60), ns(90)]]]
    trace = {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "detect", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 5, "dur": 17},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 40, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 95, "dur": 20}]}
    got = profiling.idle_by_span(trace, spans, within=("detect",))
    want = {"sift3d.detect": 5 + 10 + 5, "sift3d.to_device": 3,
            "sift3d.detect.plan": 5, "sift3d.detect.assembly": 20}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-6, abs=2e-9), k


def test_threads_record_their_own_calls():
    """Threads (more than cores, a short switch interval) each record
    their own calls; no count or span of the shared totals is lost."""
    import sys
    import threading
    n_threads, n_calls = 16, 200
    base = profiling.counter("test.threads")
    spans = profiling.read()["spans"].get("sift3d.thread", [0, 0])[0]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(i):
        for _ in range(n_calls):
            with profiling.span("sift3d.thread", root=True):
                with profiling.span(f"sift3d.thread.{i}"):
                    profiling.count("test.threads")
                profiling.count("test.threads")

    try:
        pool = [threading.Thread(target=work, args=(i,))
                for i in range(n_threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.counter("test.threads") - base == \
        2 * n_threads * n_calls
    assert profiling.read()["spans"]["sift3d.thread"][0] - spans == \
        n_threads * n_calls
    for c in profiling.read()["calls"][-50:]:
        assert c["root"] == "sift3d.thread"
        assert c["counters"] == {"test.threads": 2}
        assert len(c["spans"]) == 2

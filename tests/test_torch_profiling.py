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

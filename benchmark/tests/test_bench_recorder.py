"""The pipeline's readers of the program's own record: None on an empty
record or without a recorder, exact values on a synthetic one, and every
one of them in a traced run's line."""

import pytest

from benchmark import harness
from benchmark.metrics import _recorder

READERS = ("pipeline.host_syncs_per_call.kp", "pipeline.sync_wait_ms.kp",
           "pipeline.copy_mb_per_call.kp", "pipeline.detect_host_ms.kp",
           "pipeline.describe_host_ms.kp")
MS = 1_000_000      # ns


def _call(root, spans, counters):
    return {"root": root, "t0": 0, "t1": 0, "spans": spans,
            "counters": counters}


# Three detect calls and two describe calls; each kind's median is the
# middle detect call and the mean of the two describe calls.
SYNTHETIC = [
    _call("sift3d.detect_batch",
          {"sift3d.detect_batch": [1, 50 * MS, 1 * MS],
           "sift3d.detect.assembly": [1, k * MS, k * MS],
           "sift3d.to_device": [12, 2 * k * MS, 2 * k * MS],
           "sift3d.read_int": [6, 10 * MS, 10 * MS],
           "sift3d.to_host": [6, 3 * MS, 3 * MS]},
          {"host_syncs": 24 + k, "h2d_bytes": 100, "d2h_bytes": k * 1000})
    for k in (1, 3, 2)] + [
    _call("sift3d.describe_batch",
          {"sift3d.describe_batch": [1, 20 * MS, 1 * MS],
           "sift3d.describe.check": [1, k * MS, k * MS],
           "sift3d.describe.gather": [6, 8 * MS, 2 * MS],
           "sift3d.describe.scatter": [1, 1 * MS, 1 * MS],
           "sift3d.to_device": [24, 6 * MS, 6 * MS],
           "sift3d.to_host": [1, 4 * MS, 4 * MS]},
          {"host_syncs": 25, "h2d_bytes": 500_000, "d2h_bytes": 5_000_000})
    for k in (1, 2)]
WANT = {
    "pipeline.host_syncs_per_call.kp": 26 + 25,
    "pipeline.sync_wait_ms.kp": (2 * 2 + 10 + 3) + (6 + 4),
    "pipeline.copy_mb_per_call.kp": (100 + 2000 + 5_500_000) * 1e-6,
    "pipeline.detect_host_ms.kp": 2,
    "pipeline.describe_host_ms.kp": 1.5 + 2 + 1,
}


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("record", [None, [], SYNTHETIC[:3]],
                         ids=["no_recorder", "empty", "detect_only"])
def test_reader_reads_nothing_without_calls(monkeypatch, name, record):
    monkeypatch.setattr(_recorder, "calls", lambda: record)
    assert harness.load("metrics", name).read(None) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_record(monkeypatch, name):
    monkeypatch.setattr(_recorder, "calls", lambda: SYNTHETIC)
    assert harness.load("metrics", name).read(None) == \
        pytest.approx(WANT[name], rel=1e-12)


def test_traced_run_reports_every_reader():
    """A traced run of the cut cell on the CPU reports all five; the CPU
    crosses to no card, so the crossings read zero there."""
    from _tiny import run
    result, _, _ = run("sparse256-b16", trace=True)
    got = result["metrics"]
    assert set(READERS) <= set(got)
    assert got["pipeline.host_syncs_per_call.kp"]["value"] == 0.0
    assert got["pipeline.detect_host_ms.kp"]["value"] > 0.0
    assert got["pipeline.describe_host_ms.kp"]["value"] > 0.0

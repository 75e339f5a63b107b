"""A run's last line: exactly the contract's keys, the compared numbers
last; and no result without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from _tiny import REGISTRATION, run

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["sparse256-b16", REGISTRATION])
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_last_line_has_the_contract_keys(workload, trace):
    result, line, lines = run(workload, trace)
    obj = json.loads(line)
    keys = list(obj)
    assert keys[-1] == "compared"
    assert set(keys) == set(KEYS + ["compared"]
                            + (["breakdown"] if trace else []))
    assert obj["correct"] is True and obj["failed"] == 0
    assert obj["attempted"] >= 2
    dev = obj["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(obj["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in obj["breakdown"].values())
    for m in obj["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        assert "setup_s" in obj["metrics"] and len(obj["metrics"]) == 3
    for k, v in obj["compared"].items():
        assert set(v) == {"value", "limit"}
        assert any(x.startswith(f"compared {k}:") for x in lines[-8:])
    assert lines[-1].startswith("compared ")


def test_no_result_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "sparse256-b16", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "needs 1 CUDA card" in r.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "sparse256-b16", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""

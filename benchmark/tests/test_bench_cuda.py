"""A short run of each cell of BENCHMARK.json on the card (``python -m
pytest -m cuda benchmark/tests``); skipped without one."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload",
                         [w["name"] for w in MANIFEST["workloads"]])
def test_short_run_on_the_card_is_correct(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        workload, "--seed", str(2 ** 31 + 5), "--seconds",
                        "2", "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    obj = json.loads(r.stdout.strip().splitlines()[-1])
    assert obj["correct"] is True, r.stderr[-4000:]
    assert obj["device"]["platform"] == "gpu"
    assert 0 < obj["device"]["busy_s"] <= obj["device"]["window_s"]
    for name, m in obj["metrics"].items():
        if name.endswith(("_roofline.kp", "_roofline.reg")):
            assert 0 < m["value"] <= 100, (name, m)

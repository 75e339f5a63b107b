"""Cells cut to sizes a CPU test run holds: those of BENCHMARK.json, and
the registration cell kept for a later change (PERF.md section 7), built
from its traffic file and configuration with the metrics it would
report."""

import json
import time

from benchmark import harness

MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")
REGISTRATION = "reg256-dense-p8"
SIZES = {"sparse256-b16": dict(n=40, batch=2),
         # sparse blobs at 64^3: every pair finds an affine
         REGISTRATION: dict(n=64, batch=1, blobs=400, centre=[0.08, 0.92],
                            width=[0.01, 0.06])}
_REG_METRICS = {
    "end_to_end": [("pairs_per_s", "pairs/s"), ("reg_call_p95_ms", "ms"),
                   ("setup_s", "s")],
    "per_layer": [("pipeline.detect_describe_ms.reg", "ms"),
                  ("registration.match_ransac_ms.reg", "ms"),
                  ("blur_roofline.reg", "%"), ("extrema_roofline.reg", "%"),
                  ("ori_roofline.reg", "%"), ("desc_roofline.reg", "%"),
                  ("device.idle_pct.reg", "%")]}


def tiny_cell(workload: str) -> harness.Cell:
    if workload == REGISTRATION:
        cell = harness.Cell(
            name=workload,
            config=harness.load_json(
                harness.HERE / "configs" / "regsift3d-t1-1mm.json"),
            traffic=harness.load_json(
                harness.HERE / "traffic" / f"{workload}.json"),
            chips=1,
            **{k: [{"name": n, "unit": u} for n, u in v]
               for k, v in _REG_METRICS.items()})
    else:
        cell = harness.cell_from_manifest(MANIFEST, workload)
    cell.traffic["params"].update(SIZES[workload])
    return cell


def run(workload: str, trace: bool = False, seed: int = 2 ** 31 + 99,
        seconds: float = 0.5):
    """(result, its last line as printed) of a run of the cut cell on the
    CPU, past the harness's look for a card."""
    lines = []
    result = harness.run_cell(tiny_cell(workload), seed, seconds, trace,
                              "cpu", time.perf_counter(), lines.append)
    return result, json.dumps(result), lines

"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths), w
            assert (ROOT / w).is_file()


def test_every_name_and_unit_uses_the_allowed_characters():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [x["name"] for x in MANIFEST["configs"] + MANIFEST["workloads"]
             + metrics]
    names += [w[k] for w in MANIFEST["workloads"] for k in ("config",
                                                             "traffic")]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in MANIFEST[group]]
        assert len(ns) == len(set(ns))
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_entries_have_just_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    pairs = set()
    for w in MANIFEST["workloads"]:
        pairs.add((w["config"], w["traffic"]))
        cell = harness.cell_from_manifest(MANIFEST, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names, m
    assert len(pairs) == len(MANIFEST["workloads"])
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_run_seconds_fits_the_check_with_24_cells():
    s = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("w", [w["name"] for w in MANIFEST["workloads"]])
def test_harness_finds_every_file_of_a_cell_by_name(w):
    cell = harness.cell_from_manifest(MANIFEST, w)
    conf = {c["name"]: c for c in MANIFEST["configs"]}[
        {x["name"]: x for x in MANIFEST["workloads"]}[w]["config"]]
    assert conf["file"].startswith("benchmark/configs/")
    assert cell.config["name"] == conf["name"]
    assert cell.config["source"] == conf["source"]
    for key in ("detector", "units", "limits"):
        assert key in cell.config
    for kind in ("generator", "check"):
        mod = harness.load(kind + "s", cell.traffic[kind])
        assert callable(getattr(mod, "make" if kind == "generator"
                                else "compare"))
    path = ROOT / "benchmark" / "entries" / f"{cell.traffic['entry']}.py"
    assert path.is_file()
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load("metrics", m["name"]).read), m

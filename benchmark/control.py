"""Readings for a cell's limits: the control, or the program's.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]
        [--program]

For each seed it makes the cell's pool as a run does and answers each of
the pool's batches once (a window of one call a batch), then judges the
answers by the cell's own check and limits (``compare`` of
checks/<check>.py), as a run's check judges the window's. The control
answers with the plain reference in the program's place, computed in TF32
(the check's ``reference_call``, ``prec="tf32"``): a sound control reads
``correct`` false. With ``--program`` the program answers, through the
cell's entry, in one process for all the seeds. The benchmark's own runs
run neither.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def readings(cell, pool, seed: int, device, answer, log) -> dict:
    """{name: (value, limit)}: the cell's check of answer(batch) for
    every batch of the pool."""
    check = harness.load("checks", cell.traffic["check"])
    sample = [(slot, 0, answer(batch)) for slot, batch in enumerate(pool)]
    return check.compare(sample, pool, cell.config, seed, device, log,
                         **cell.traffic.get("check_params", {}))


def reference_answer(cell, device, prec: str):
    """The plain reference at `prec` in the program's place."""
    check = harness.load("checks", cell.traffic["check"])
    return lambda batch: check.reference_call(cell.config, batch, device,
                                              prec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)

    def log(line):
        print(line, file=sys.stderr, flush=True)
    cell = harness.cell_from_manifest(
        harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    gen = harness.load("generators", cell.traffic["generator"])
    dev = torch.device("cuda")
    if args.program:
        entry = harness.load("entries", cell.traffic["entry"])
        state = entry.setup(cell.config, dev)
        spans = harness.Spans(dev, sync=False)
        answer = lambda batch: entry.call(state, batch, spans)  # noqa: E731
    else:
        answer = reference_answer(cell, dev, "tf32")
    for seed in args.seeds:
        t = time.perf_counter()
        pool = gen.make(cell.traffic["params"], seed, dev)
        limited = readings(cell, pool, seed, dev, answer, log)
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "side": "program" if args.program else "control (tf32)",
            "correct": all(v <= lim for v, lim in limited.values()),
            "numbers": {k: v for k, (v, _) in limited.items()},
            "limits": cell.config["limits"],
            "seconds": time.perf_counter() - t}), flush=True)
        del pool
    return 0


if __name__ == "__main__":
    sys.exit(main())

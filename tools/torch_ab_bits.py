"""Bit-for-bit A/B of the port's results between two trees, one process.

Loads sift3d_tpu_torch from this checkout (A) and from --other (B), as
tools/torch_ab_wall.py does, makes a benchmark cell's pool of batches on
the card from each --seed (benchmark/generators, the cell's traffic and
configuration files), and runs detect_keypoints_batch +
extract_descriptors_batch of every batch through both trees. Every
keypoint field (coordinates, octave, level, sd, stale strength, R), every
descriptor field (xyz, sd, data) and the funnel must be equal bit for
bit. Prints the card and one line per batch; exits 1 at a difference.

Usage: python tools/torch_ab_bits.py --other DIR [--cell sparse256-b16]
                                     [--seed N ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from torch_ab_wall import load  # noqa: E402

KP_FIELDS = ("coords", "octave", "level", "sd", "strength", "R")
DESC_FIELDS = ("xyz", "sd", "data")


def same_bits(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def differences(res_a, res_b) -> list[str]:
    """The fields in which two trees' (keypoints, descriptors, funnel)
    differ, as 'volume b: field' strings."""
    (kps_a, descs_a, fun_a), (kps_b, descs_b, fun_b) = res_a, res_b
    out = [] if fun_a == fun_b else ["funnel"]
    if len(kps_a) != len(kps_b):
        return out + ["number of volumes"]
    for b, (ka, kb, da, db) in enumerate(zip(kps_a, kps_b, descs_a,
                                             descs_b)):
        out += [f"volume {b}: keypoints.{f}" for f in KP_FIELDS
                if not same_bits(getattr(ka, f), getattr(kb, f))]
        out += [f"volume {b}: descriptors.{f}" for f in DESC_FIELDS
                if not same_bits(getattr(da, f), getattr(db, f))]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the tree to compare with (B)")
    ap.add_argument("--cell", default="sparse256-b16")
    ap.add_argument("--seed", type=int, nargs="+", default=[2 ** 31 + 5])
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_ab_bits: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.cell)
    cfg_file = next(c["file"] for c in bench["configs"]
                    if c["name"] == cell["config"])
    config = json.loads((REPO / cfg_file).read_text())
    traffic = json.loads(
        (REPO / "benchmark/traffic" / f"{cell['traffic']}.json").read_text())
    if traffic["generator"] != "blob_phantoms":
        raise SystemExit(f"torch_ab_bits: no generator for {args.cell}")
    from benchmark.generators import blob_phantoms
    trees = {"A": load(REPO, "s3t_a"),
             "B": load(args.other.resolve(), "s3t_b")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"{args.cell}, A = {REPO}, B = {args.other.resolve()}, on {card}")
    dets = {k: st.SIFT3D(st.DetectorParams(**config["detector"]), "cuda")
            for k, st in trees.items()}
    units = tuple(config["units"])
    bad = 0
    for seed in args.seed:
        pool = blob_phantoms.make(traffic["params"], seed, "cuda")
        for i, batch in enumerate(pool):
            res = {}
            for k, det in dets.items():
                kps = det.detect_keypoints_batch(batch["vols"], units)
                descs = det.extract_descriptors_batch(kps)
                res[k] = (kps, descs, det._funnel)
            diff = differences(res["A"], res["B"])
            n = sum(len(kp) for kp in res["A"][0])
            print(f"  seed {seed} batch {i}: {len(res['A'][0])} volumes, "
                  f"{n} keypoints: "
                  f"{'bit-identical' if not diff else ', '.join(diff)}")
            bad += bool(diff) or n == 0
    print("BITS OK" if not bad else f"BITS DIFFER in {bad} batches")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""Interleaved A/B of the port's wall time between two trees, one process.

Loads sift3d_tpu_torch from this checkout (A) and from --other (B: another
tree of the repository, e.g. the parent commit unpacked with ``git
archive``) under two module names, each with its own kernel build, and
times the same work in both, alternating A and B round by round, so that
drift and the spread between processes hit both alike:
 - default: SIFT3D.detect_keypoints + extract_descriptors on the --size
   (256) sparse bench phantom, or --dense, already on the card; with
   --refine under DetectorParams(refine_subvoxel=True, edge_thresh=10.0);
 - --register: register() of the phantom against its copy rotated by 8
   degrees about z and shifted by (2, -1, 3) voxels (500 hypotheses);
 - --shards S: the default work through parallel.ShardedSIFT3D on S
   shards of the card (make_mesh({"z": S}, ["cuda:0"] * S));
 - --batch B: detect_keypoints_batch + extract_descriptors_batch on B
   volumes, the phantom and B - 1 drawn from seeds 101, 102, ...
 - --host: the volume (or batch) held in host memory, a numpy array that
   each call uploads (default: already on the card).
Each run ends in a device sync. Prints the card, then per tree the median
wall and its quartiles over --rounds (41) rounds after a warm-up, and the
median of the paired differences A - B with the share of rounds in which
A was the faster.

Usage: python tools/torch_ab_wall.py --other DIR [--size N] [--dense]
                                     [--refine] [--register] [--shards S]
                                     [--batch B] [--host] [--rounds N]
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def load(root: Path, name: str):
    """The tree's package sift3d_tpu_torch, imported as module `name`."""
    pkg = root / "sift3d_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the tree to compare with (B)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--refine", action="store_true")
    ap.add_argument("--register", action="store_true")
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--rounds", type=int, default=41)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_ab_wall: no CUDA device", file=sys.stderr)
        return 1
    trees = {"A": load(REPO, "s3t_a"),
             "B": load(args.other.resolve(), "s3t_b")}
    phantoms = importlib.import_module("s3t_a.phantoms")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()

    n = args.size
    kind = "dense" if args.dense else "sparse"
    vol = phantoms.bench_volume(kind, n, "cuda")
    vols = torch.stack([vol] + [
        phantoms.bench_volume(kind, n, "cuda", seed=100 + b)
        for b in range(1, args.batch)]) if args.batch else None
    moving = None
    if args.register:
        th = np.deg2rad(8.0)
        A = np.eye(4)
        A[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        c = np.full(3, (n - 1) / 2.0)
        A[:3, 3] = c - A[:3, :3] @ c + np.array([2.0, -1.0, 3.0])
        moving = trees["A"].warp_volume(
            vol, np.linalg.inv(A)[:3].astype(np.float32), (n, n, n),
            device="cuda").data
    if args.host:
        vol, vols, moving = (None if v is None else v.cpu().numpy()
                             for v in (vol, vols, moving))

    def job(st):
        params = (st.DetectorParams(refine_subvoxel=True, edge_thresh=10.0)
                  if args.refine else st.DetectorParams())
        if args.shards:
            par = importlib.import_module(st.__name__ + ".parallel")
            det = par.ShardedSIFT3D(params, mesh=par.make_mesh(
                {"z": args.shards}, ["cuda:0"] * args.shards))
        else:
            det = st.SIFT3D(params, "cuda")
        if args.register:
            return lambda: st.register(vol, moving, num_iter=500,
                                       detectors=det, device="cuda")
        if args.batch:
            return lambda: det.extract_descriptors_batch(
                det.detect_keypoints_batch(vols))
        return lambda: det.extract_descriptors(det.detect_keypoints(vol))

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    jobs = {k: job(st) for k, st in trees.items()}
    for fn in jobs.values():      # builds the kernels, warms the caches
        fn()
        fn()
    walls = {"A": [], "B": []}
    for r in range(args.rounds):
        for k in ("AB" if r % 2 == 0 else "BA"):
            walls[k].append(timed(jobs[k]))

    what = (f"{'dense' if args.dense else 'sparse'}{n}"
            f"{' refined' if args.refine else ''}"
            f"{' register pair' if args.register else ''}"
            f"{f' on {args.shards} shards' if args.shards else ''}"
            f"{f' batch of {args.batch}' if args.batch else ''}, input "
            f"{'in host memory' if args.host else 'on the card'}")
    print(f"{what}, {args.rounds} rounds alternating A and B, on {card}")
    for k, root in (("A", REPO), ("B", args.other.resolve())):
        w = walls[k]
        q1, _, q3 = statistics.quantiles(w, n=4)
        print(f"  {k} ({root}): median {statistics.median(w):.2f} ms "
              f"(quartiles {q1:.2f}-{q3:.2f})")
    d = [a - b for a, b in zip(walls["A"], walls["B"])]
    print(f"  A - B paired: median {statistics.median(d):.2f} ms; A faster "
          f"in {sum(x < 0 for x in d)} of {len(d)} rounds")
    return 0


if __name__ == "__main__":
    sys.exit(main())

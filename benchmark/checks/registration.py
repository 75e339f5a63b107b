"""Check of the register_batch entry against the plain reference.

The seed draws ``check_calls`` of the calls the harness hands over. For
every pair of each, the reference detects and describes both volumes
again on the card and matches and fits them with the configuration's
settings and RANSAC seed. Besides the numbers of _sift3d.py (every
shared keypoint's descriptor is compared):

- ``match_diff``: matches (moving, fixed coordinates) found on one side
  only, the most over the pairs;
- ``affine_vox``: the mean distance in voxels between the program's and
  the reference's affines over the volume's corners, the most over the
  pairs (inf where one side has an affine and the other none).

Each side's distance from the true warp is printed, not compared.
``reference_call`` answers a batch as the entry does, with the reference
at a given precision in the program's place (benchmark/control.py).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from . import _sift3d

ref = _sift3d.ref


def corner_error(A, B, n: int) -> float:
    if A is None and B is None:
        return 0.0
    if A is None or B is None:
        return float("inf")
    c = np.array([[x, y, z, 1.0] for x in (0, n - 1) for y in (0, n - 1)
                  for z in (0, n - 1)])
    d = c @ (np.asarray(A, np.float64) - np.asarray(B, np.float64)).T
    return float(np.linalg.norm(d, axis=1).mean())


def reference_pair(fixed, moving, plan, reg: dict, device,
                   prec: str = "f32"):
    """(Detection, descriptors) of both volumes, matches (moving xyz,
    fixed xyz) and affine, as the reference registers the pair."""
    sides = []
    for vol in (fixed, moving):
        d = ref.detect(vol, plan, prec)
        data, xyz = ref.describe(d, plan, None, prec)
        sides.append((d, data, xyz))
    (df, data_f, xyz_f), (dm, data_m, xyz_m) = sides
    i1, i2 = ref.match(data_m, data_f, reg["nn_thresh"], device, prec)
    src, dst = xyz_m[i1], xyz_f[i2]
    w = (1.0 / (4.0 ** dm.octave[i1] + 4.0 ** df.octave[i2])).astype(
        np.float32)
    A = ref.ransac(src, dst, w, reg["num_iter"], reg["seed"],
                   reg["err_thresh"], device, prec)
    return sides, (src, dst), A


def match_diff(a, b) -> int:
    sa = {tuple(np.round(r, 3)) for r in np.concatenate(a, axis=1)}
    sb = {tuple(np.round(r, 3)) for r in np.concatenate(b, axis=1)}
    return len(sa ^ sb)


def reference_call(config: dict, batch: dict, device, prec: str) -> dict:
    P, n = batch["fixed"].shape[0], batch["fixed"].shape[-1]
    plan = _sift3d.plan_for(config, n)
    pairs = [reference_pair(batch["fixed"][b], batch["moving"][b], plan,
                            config["registration"], device, prec)
             for b in range(P)]
    sides = [pair[0][k] for k in (0, 1) for pair in pairs]
    results = [SimpleNamespace(matches_moving=src, matches_fixed=dst,
                               affine=A, num_matches=len(src),
                               num_inliers=None)
               for _, (src, dst), A in pairs]
    return {"keypoints": [d for d, _, _ in sides],
            "descriptors": [SimpleNamespace(data=data)
                            for _, data, _ in sides],
            "results": results}


def compare(sample, pool, config: dict, seed: int, device, log,
            check_calls: int = 1) -> dict:
    rng = np.random.default_rng([seed, 2])
    reg = config["registration"]
    total = {}
    for j in sorted(rng.choice(len(sample), min(check_calls, len(sample)),
                               replace=False)):
        slot, call, out = sample[j]
        batch = pool[slot]
        P, n = batch["fixed"].shape[0], batch["fixed"].shape[-1]
        plan = _sift3d.plan_for(config, n)
        for b in range(P):
            sides, (src, dst), A = reference_pair(
                batch["fixed"][b], batch["moving"][b], plan, reg, device)
            res = out["results"][b]
            for v, (d, _, _) in zip((b, P + b), sides):
                ds = out["descriptors"][v]
                part = _sift3d.compare_volume(
                    out["keypoints"][v], lambda i, ds=ds: ds.data[i], d,
                    plan, rng, None)
                _sift3d.fold(total, part)
            part = {"match_diff": match_diff(
                        (res.matches_moving, res.matches_fixed), (src, dst)),
                    "affine_vox": corner_error(res.affine, A, n)}
            truth = batch["affine"][b]
            log(f"check call {call} pair {b}: "
                f"{[sum(len(c[1]) for c in d.cands) for d, _, _ in sides]} "
                f"candidates, {[len(d) for d, _, _ in sides]} reference "
                f"keypoints, {len(src)} reference and {res.num_matches} "
                f"program matches, {res.num_inliers} inliers, {part}, "
                f"from the true warp {corner_error(res.affine, truth, n):.4f}"
                f" (reference {corner_error(A, truth, n):.4f}) voxels, "
                f"totals {total}")
            _sift3d.fold(total, part)
            del sides
    return _sift3d.limited(total, config)

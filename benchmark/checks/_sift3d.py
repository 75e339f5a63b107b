"""Comparing a volume's keypoints and descriptors with the reference's.

The numbers (each held to a limit in the configuration's ``limits``):

- ``kp_rows``: keypoint rows that differ from the reference's, in
  order: octave, level and coordinates, position by position, plus the
  difference in count. A candidate whose orientation verdict the
  reference finds within its VERDICT_MARGIN may be on either side and is
  passed over.
- ``strength_rel``: the largest relative difference of the (stale)
  strengths over the rows both sides have.
- ``r_err``: the largest absolute difference of an element of R over the
  keypoints both sides have.
- ``desc_rel``: the largest rel-L2 difference of a descriptor, over a
  sample of the shared keypoints drawn from the seed (or all of them),
  each described from the reference's own pyramid at the program's R.
  The descriptor stage is judged on the program's R, as a served token
  is judged on the tokens served before it: a voxel whose bin coordinate
  lies within R's last bits of the cube's lower face falls in or out and
  moves a descriptor by ~1e-3, so with the reference's own R the stage
  would be judged on R's rounding. R itself is held by ``r_err``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..reference import sift3d_plain as ref


def plan_for(config: dict, n: int) -> ref.Plan:
    return ref.make_plan((n, n, n), config["units"],
                         ref.Params.from_config(config["detector"]))


def keys(kp) -> list:
    return [(int(o), int(lv), *(int(v) for v in c))
            for o, lv, c in zip(kp.octave, kp.level, kp.coords)]


def compare_volume(kp, desc_of, d: ref.Detection, plan: ref.Plan, rng,
                   nsample: int | None, prec: str = "f32") -> dict:
    """Numbers of one volume: kp the program's keypoints (coords, octave,
    level, strength, R), desc_of(indices) its descriptors f32[k, 768] of
    those keypoints, d the reference's Detection. nsample: descriptors
    compared (None: all shared keypoints)."""
    kp_keys, ref_keys = keys(kp), keys(d)
    in_kp, in_ref = set(kp_keys), set(ref_keys)
    p = [k for k in kp_keys if k in in_ref or k not in d.near]
    r = [k for k in ref_keys if k in in_kp or k not in d.near]
    rows = abs(len(p) - len(r)) + sum(a != b for a, b in zip(p, r))
    m = min(len(kp), len(d))
    sp, sr = np.asarray(kp.strength[:m]), d.strength[:m]
    strength = float(np.max(np.abs(sp - sr) / np.maximum(sr, 1e-30),
                            initial=0.0))
    pos = {k: i for i, k in enumerate(ref_keys)}
    shared = [(i, pos[k]) for i, k in enumerate(kp_keys) if k in pos]
    ip = np.array([a for a, _ in shared], np.int64)
    ir = np.array([b for _, b in shared], np.int64)
    r_err = float(np.max(np.abs(np.asarray(kp.R)[ip] - d.R[ir]),
                         initial=0.0))
    if nsample is not None and len(ip) > nsample:
        pick = np.sort(rng.choice(len(ip), nsample, replace=False))
        ip, ir = ip[pick], ir[pick]
    desc = 0.0
    if len(ip):
        got = np.asarray(desc_of(ip), np.float32)
        at_r = dataclasses.replace(d, R=d.R.copy())
        at_r.R[ir] = np.asarray(kp.R, np.float32)[ip]
        want, _ = ref.describe(at_r, plan, ir, prec)
        desc = float(np.max(np.linalg.norm(got - want, axis=1)
                            / np.maximum(np.linalg.norm(want, axis=1),
                                         1e-30)))
    return {"kp_rows": rows, "strength_rel": strength, "r_err": r_err,
            "desc_rel": desc, "shared": len(shared), "described": len(ip)}


class Described:
    """A volume's descriptors as the reference makes them at `prec`, in
    the form an entry returns them (``data[idx]``), each described only
    when read."""

    def __init__(self, d: ref.Detection, plan: ref.Plan, prec: str):
        self.d, self.plan, self.prec = d, plan, prec

    @property
    def data(self):
        return self

    def __getitem__(self, idx):
        return ref.describe(self.d, self.plan, idx, self.prec)[0]


def fold(total: dict, part: dict) -> None:
    """Add kp_rows, take the largest of the other numbers; a NaN stays."""
    for k, v in part.items():
        prev = total.get(k, 0)
        if k in ("kp_rows", "shared", "described"):
            total[k] = prev + v
        else:
            total[k] = (math.nan if math.isnan(prev) or math.isnan(v)
                        else max(prev, v))


def limited(total: dict, config: dict) -> dict:
    """{name: (value, limit)} of every number the configuration limits."""
    lim = config["limits"]
    return {k: (total[k], lim[k]) for k in lim if k in total}

"""Check of the detect + describe entry against the plain reference.

The harness hands over one call of the window for each slot of the pool
(drawn from the seed among that slot's calls). Every volume of the
``check_calls`` of them that the seed draws is detected again by the
reference on the card: its keypoint rows, strengths and R are compared,
and the descriptors of ``desc_sample`` of its shared keypoints, drawn
from the seed (_sift3d.py).

``reference_call`` answers a batch as the entry does, with the reference
at a given precision in the program's place: the control
(benchmark/control.py) is judged by ``compare`` as a run is.
"""

from __future__ import annotations

import numpy as np

from . import _sift3d


def reference_call(config: dict, batch: dict, device, prec: str) -> dict:
    vols = batch["vols"]
    plan = _sift3d.plan_for(config, vols.shape[-1])
    kps = [_sift3d.ref.detect(v, plan, prec) for v in vols]
    return {"keypoints": kps,
            "descriptors": [_sift3d.Described(d, plan, prec) for d in kps]}


def compare(sample, pool, config: dict, seed: int, device, log,
            check_calls: int = 2, desc_sample: int = 32) -> dict:
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(sample), min(check_calls, len(sample)),
                      replace=False)
    total = {}
    for j in sorted(pick):
        slot, call, out = sample[j]
        vols = pool[slot]["vols"]
        plan = _sift3d.plan_for(config, vols.shape[-1])
        for b in range(vols.shape[0]):
            d = _sift3d.ref.detect(vols[b], plan)
            ds = out["descriptors"][b]
            part = _sift3d.compare_volume(out["keypoints"][b],
                                          lambda i: ds.data[i], d, plan, rng,
                                          desc_sample)
            log(f"check call {call} volume {b}: "
                f"{sum(len(c[1]) for c in d.cands)} candidates, "
                f"{len(d)} reference keypoints, "
                f"{len(out['keypoints'][b])} program keypoints, {part}")
            _sift3d.fold(total, part)
            del d
    return _sift3d.limited(total, config)

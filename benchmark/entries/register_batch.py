"""Entry: SIFT3D registration of a batch of volume pairs.

One call is ``register_batch`` of P fixed and P moving volumes f32[P, n,
n, n] with the configuration's matching and RANSAC settings, through one
SIFT3D that lives across calls; it returns when every pair's affine is
on the host. The SIFT3D is handed to register_batch inside a thin
stand-in of the harness's own, which spans the two calls register_batch
makes into it and keeps their results for the check.
"""

from __future__ import annotations

from sift3d_tpu_torch import SIFT3D, DetectorParams, register_batch

from ..checks.registration import corner_error


class _Spanned:
    """The detector that register_batch drives, each of its two calls
    inside a span, its results kept."""

    def __init__(self, det: SIFT3D, spans):
        self.det, self.spans = det, spans
        self.device = det.device
        self.keypoints = self.descriptors = None

    def detect_keypoints_batch(self, vols, units=(1.0, 1.0, 1.0)):
        with self.spans("detect"):
            self.keypoints = self.det.detect_keypoints_batch(vols, units)
        return self.keypoints

    def extract_descriptors_batch(self, kps):
        with self.spans("describe"):
            self.descriptors = self.det.extract_descriptors_batch(kps)
        return self.descriptors


def setup(config: dict, device) -> dict:
    return {"det": SIFT3D(DetectorParams(**config["detector"]), device),
            "units": tuple(config["units"]), "reg": config["registration"]}


def describe(state: dict):
    yield f"sub-batch: {state['det'].sub_batch} volumes"


def call(state: dict, batch: dict, spans) -> dict:
    det = _Spanned(state["det"], spans)
    r = state["reg"]
    res = register_batch(batch["fixed"], batch["moving"],
                         nn_thresh=r["nn_thresh"], err_thresh=r["err_thresh"],
                         num_iter=r["num_iter"], kp_limit=r["kp_limit"],
                         seed=r["seed"], units=state["units"], det=det,
                         device=det.device)
    n = batch["fixed"].shape[-1]
    err = max(corner_error(x.affine, a, n)
              for x, a in zip(res, batch["affine"]))
    return {"units": {"pairs": len(res), "volumes": 2 * len(res)},
            "counts": {"keypoints": sum(len(k) for k in det.keypoints),
                       "matches": sum(x.num_matches for x in res),
                       "inliers": sum(x.num_inliers for x in res),
                       "worst_corner_err_mvox": round(1000 * min(err, 1e6))},
            "keypoints": det.keypoints, "descriptors": det.descriptors,
            "results": res,
            "volumes": list(batch["fixed"]) + list(batch["moving"])}

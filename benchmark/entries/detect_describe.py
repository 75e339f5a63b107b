"""Entry: keypoints and descriptors of a batch of volumes.

One call is ``SIFT3D.detect_keypoints_batch`` on f32[B, n, n, n] and
``extract_descriptors_batch`` on its keypoints, through one SIFT3D that
lives across calls; it returns when both results are on the host.
"""

from __future__ import annotations

from sift3d_tpu_torch import SIFT3D, DetectorParams


def setup(config: dict, device) -> dict:
    return {"det": SIFT3D(DetectorParams(**config["detector"]), device),
            "units": tuple(config["units"])}


def describe(state: dict):
    yield f"sub-batch: {state['det'].sub_batch} volumes"


def call(state: dict, batch: dict, spans) -> dict:
    det = state["det"]
    with spans("detect"):
        kps = det.detect_keypoints_batch(batch["vols"], state["units"])
    with spans("describe"):
        descs = det.extract_descriptors_batch(kps)
    return {"units": {"volumes": len(kps)},
            "counts": {"keypoints": sum(len(k) for k in kps)},
            "keypoints": kps, "descriptors": descs,
            "volumes": list(batch["vols"])}

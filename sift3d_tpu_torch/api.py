"""Functional convenience API mirroring the reference's public surface
(sift3d_detect_keypoints / sift3d_extract_descriptors, sift.h) and the
upstream 1.x line's register_SIFT3D. The object API (pipeline.SIFT3D)
remains the primary interface."""

from __future__ import annotations

import torch

from .keypoints import Descriptors, Keypoints
from .params import DetectorParams
from .pipeline import SIFT3D
from .registration import RegistrationResult, register


def detect_keypoints(vol, params: DetectorParams = DetectorParams(),
                     device: torch.device | str = "cuda",
                     detector: SIFT3D | None = None) -> Keypoints:
    """Detect keypoints in one call. Pass (and keep) a `detector` to reuse
    its pyramid for extract_descriptors."""
    det = detector if detector is not None else SIFT3D(params, device)
    return det.detect_keypoints(vol)


def detect_and_extract(vol, params: DetectorParams = DetectorParams(),
                       device: torch.device | str = "cuda", limit: int = 0):
    """Keypoints + descriptors in one call; optional strongest-N limit
    (the reference CLI uses 100)."""
    det = SIFT3D(params, device)
    kp = det.detect_keypoints(vol)
    if limit:
        kp = kp.sort_by_strength(limit)
    return kp, det.extract_descriptors(kp) if len(kp) else Descriptors.empty()


def register_sift3d(fixed, moving, params: DetectorParams | None = None,
                    device: torch.device | str = "cuda",
                    **kwargs) -> RegistrationResult:
    """Full SIFT3D registration (the upstream register_SIFT3D capability)
    on `device`: detect + describe both volumes, match, RANSAC affine."""
    return register(fixed, moving, params=params, device=device, **kwargs)

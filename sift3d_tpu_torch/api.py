"""Functional convenience API mirroring the reference's public surface
(sift3d_detect_keypoints / sift3d_extract_descriptors, sift.h). The object
API (pipeline.SIFT3D) remains the primary interface."""

from __future__ import annotations

import numpy as np
import torch

from .keypoints import Descriptors, Keypoints
from .params import DESC_NUMEL, DetectorParams
from .pipeline import SIFT3D


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
    if len(kp):
        desc = det.extract_descriptors(kp)
    else:
        desc = Descriptors(xyz=np.zeros((0, 3), np.float32),
                           sd=np.zeros(0, np.float32),
                           data=np.zeros((0, DESC_NUMEL), np.float32))
    return kp, desc

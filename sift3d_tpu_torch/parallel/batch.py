"""A batch of volumes over the devices of a mesh axis.

Counterpart of sift3d_tpu/pipeline.py:926 _detect_full_shardmap_fn (chosen
at :1371-1380) and of sift3d_tpu/registration.py:342-351's batch sharded
over a mesh axis: the batch is split into contiguous shares, one per
device of the axis, and each device runs the single-device batch path
(SIFT3D.detect_keypoints_batch / extract_descriptors_batch) on its share.
One process drives the devices (parallel/mesh.py), share after share;
results come back in batch order, equal to the unsharded batch's.
"""

from __future__ import annotations

import numpy as np

from ..params import DetectorParams
from ..pipeline import SIFT3D, _as_batch
from .mesh import Mesh, cuda_devices, make_mesh


class MeshBatchSIFT3D:
    """detect_keypoints_batch and extract_descriptors_batch, as SIFT3D's,
    with the batch split over the devices of `axis` of `mesh` (default:
    every visible CUDA device). A mesh of CPU devices runs the plain
    versions."""

    def __init__(self, params: DetectorParams = DetectorParams(),
                 mesh: Mesh | None = None, axis: str = "b",
                 stale_strength_compat: bool = True):
        self.mesh = mesh if mesh is not None else make_mesh(
            {axis: len(cuda_devices())})
        # One detector per entry of the axis (devices may repeat): each
        # holds its share's pyramid for the descriptors.
        self._dets = [SIFT3D(params, d, stale_strength_compat)
                      for d in self.mesh.axis_devices(axis)]
        self.device = self._dets[0].device
        self._shares: list[tuple[SIFT3D, int, int]] | None = None

    def detect_keypoints_batch(self, vols, units=(1.0, 1.0, 1.0)):
        """Keypoints of each volume of the batch (f32[B, nx, ny, nz], or a
        sequence of volumes), in batch order."""
        data = _as_batch(vols)
        sizes = [len(a) for a in
                 np.array_split(np.arange(data.shape[0]), len(self._dets))]
        self._shares, out, a = [], [], 0
        for det, n in zip(self._dets, sizes):
            if n:
                out += det.detect_keypoints_batch(data[a:a + n], units)
                self._shares.append((det, a, n))
            a += n
        return out

    @property
    def _funnel(self) -> dict | None:
        """The last volume's funnel, as SIFT3D's after a batch."""
        return self._shares[-1][0]._funnel if self._shares else None

    def extract_descriptors_batch(self, kps):
        """Descriptors of the keypoint lists of the last
        detect_keypoints_batch, each share on its device."""
        if self._shares is None:
            raise ValueError("no Gaussian pyramid available; call "
                             "detect_keypoints_batch first")
        B = sum(n for *_, n in self._shares)
        if len(kps) != B:
            raise ValueError(f"{len(kps)} keypoint lists for a batch of "
                             f"{B} volumes")
        return [d for det, a, n in self._shares
                for d in det.extract_descriptors_batch(kps[a:a + n])]

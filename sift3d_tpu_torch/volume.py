"""Volume: a float32 3-D image tensor with real-world voxel units.

Counterpart of the reference's sift3d_image (imtypes_private.h:73-81).
Units parameterize filter tap spacing and window radii. Only
single-channel volumes are supported by the detector
(sift3d_detect_keypoints, sift.c:1220-1226).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import profiling


@dataclasses.dataclass(frozen=True)
class Volume:
    data: torch.Tensor                          # f32[nx, ny, nz]
    units: tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.data.shape)

    @classmethod
    def from_array(cls, arr, units=(1.0, 1.0, 1.0),
                   device: torch.device | str = "cpu") -> "Volume":
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr, dtype=np.float32)
        t = profiling.to_device(arr, torch.float32, device)
        if t.ndim != 3:
            raise ValueError(f"expected a 3-D volume, got shape "
                             f"{tuple(t.shape)}")
        return cls(t.contiguous(), tuple(float(u) for u in units))

    def to(self, device: torch.device | str) -> "Volume":
        return Volume(profiling.to_device(self.data, None, device),
                      self.units)


def as_volume(vol, device: torch.device | str) -> Volume:
    """A Volume on `device` from a Volume, a tensor or an array (unit
    voxels for the latter two)."""
    if isinstance(vol, Volume):
        return vol.to(device)
    return Volume.from_array(vol, device=device)

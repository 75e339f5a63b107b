"""Host-facing keypoint and descriptor stores.

Struct-of-arrays stores with the reference's output formats: keypoint CSV
rows [strength, x, y, z, o, sd, R00..R22] (sift3d_keypoint_store_save,
sift.c:1741-1803 — column 0 is strength), descriptor CSV rows
[x, y, z, el0..el767] (sift3d_descriptor_store_to_mat_rm,
sift.c:1673-1726).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import native
from .params import DESC_NUMEL


def write_csv(path: str, mat: np.ndarray) -> None:
    """Reference CSV format: '%f'-formatted, comma-delimited, a newline
    after each row; gzip when the name ends in .gz (write_Mat_rm,
    imutil.c:405-479), by the native writer (native.py, as
    sift3d_tpu/keypoints.py:26-30)."""
    native.csv_write(path, np.atleast_2d(np.asarray(mat, np.float64)))


@dataclasses.dataclass
class Keypoints:
    """N keypoints: integer voxel coordinates at octave resolution, octave
    and level indices, absolute scale, strength and orientation matrix."""
    coords: np.ndarray    # f64[N, 3] (integer-valued; doubles, as in the C)
    octave: np.ndarray    # i32[N]
    level: np.ndarray     # i32[N]  (raw level index s)
    sd: np.ndarray        # f64[N] absolute scale
    strength: np.ndarray  # f64[N]
    R: np.ndarray         # f32[N, 3, 3]

    def __len__(self) -> int:
        return len(self.coords)

    def __getitem__(self, idx) -> "Keypoints":
        return Keypoints(self.coords[idx], self.octave[idx], self.level[idx],
                         self.sd[idx], self.strength[idx], self.R[idx])

    @classmethod
    def empty(cls) -> "Keypoints":
        return cls(coords=np.zeros((0, 3)), octave=np.zeros(0, np.int32),
                   level=np.zeros(0, np.int32), sd=np.zeros(0),
                   strength=np.zeros(0), R=np.zeros((0, 3, 3), np.float32))

    def sort_by_strength(self, limit: int = 0) -> "Keypoints":
        """Descending-strength stable sort, optionally truncated to the
        strongest `limit` (sift3d_keypoint_store_sort_by_strength,
        sift.c:1885-1900)."""
        out = self[np.argsort(-self.strength, kind="stable")]
        if limit and len(out) > limit:
            out = out[:limit]
        return out

    def to_matrix(self) -> np.ndarray:
        """[N, 3] base-octave coordinates
        (sift3d_keypoint_store_to_mat_rm, sift.c:1644-1671)."""
        return self.coords * (2.0 ** self.octave)[:, None]

    def save(self, path: str) -> None:
        """Reference keypoint CSV: [strength, x, y, z, o, sd, R row-major]."""
        n = len(self)
        mat = np.zeros((n, 15), dtype=np.float64)
        mat[:, 0] = self.strength
        mat[:, 1:4] = self.coords
        mat[:, 4] = self.octave
        mat[:, 5] = self.sd
        mat[:, 6:15] = self.R.reshape(n, 9)
        write_csv(path, mat)


@dataclasses.dataclass
class Descriptors:
    """N descriptors: base-octave coordinates, scale, 768-element vectors."""
    xyz: np.ndarray   # f32[N, 3]
    sd: np.ndarray    # f32[N]
    data: np.ndarray  # f32[N, 768]

    def __len__(self) -> int:
        return len(self.xyz)

    def __getitem__(self, idx) -> "Descriptors":
        return Descriptors(self.xyz[idx], self.sd[idx], self.data[idx])

    @classmethod
    def empty(cls) -> "Descriptors":
        return cls(xyz=np.zeros((0, 3), np.float32),
                   sd=np.zeros(0, np.float32),
                   data=np.zeros((0, DESC_NUMEL), np.float32))

    def to_matrix(self) -> np.ndarray:
        """[N, 771]: x y z el0..el767."""
        return np.concatenate(
            [self.xyz.astype(np.float32), self.data], axis=1)

    def save(self, path: str) -> None:
        write_csv(path, self.to_matrix())

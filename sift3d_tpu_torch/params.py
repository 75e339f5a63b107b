"""Detector configuration.

One frozen dataclass holds the parameters of the reference detector: the
five runtime parameters its setters expose (peak_thresh, corner_thresh,
num_kp_levels, sigma_n, sigma0 — defaults at sift.c:31-35), the
compile-time switches behind its #defines (CUBOID_EXTREMA at sift.c:24,
SIFT3D_GAUSS_WIDTH_FCTR at imutil.c:1264-1266) and its internal constants
(sift.c:38-45). Citations are into the reference C sources of SIFT3D.

Two opt-in extensions of the JAX package sit beside them, off by default
as there (refinement.py): subvoxel refinement (refine_subvoxel) and
Hessian edge rejection (edge_thresh, a ratio of eigenvalue magnitudes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# float32 machine epsilon, for the barycentric stability threshold
# (reference: bary_eps = FLT_EPSILON * 1E1, sift.c:40).
_FLT_EPSILON = 1.1920928955078125e-07

# Descriptor geometry (reference: imtypes_private.h:38-58): fixed
# architectural constants of the descriptor, not tunables.
NHIST_PER_DIM = 4
ICOS_NVERT = 12
ICOS_NFACES = 20
DESC_NUM_TOTAL_HIST = NHIST_PER_DIM ** 3  # 64
DESC_NUMEL = DESC_NUM_TOTAL_HIST * ICOS_NVERT  # 768

@dataclasses.dataclass(frozen=True)
class DetectorParams:
    """SIFT3D detector/descriptor parameters. Hashable and immutable."""

    # --- runtime parameters (reference setters, sift.c:499-565) ---
    peak_thresh: float = 0.1       # relative DoG peak threshold, in (0, 1]
    corner_thresh: float = 0.4     # minimum corner score, in [0, 1]
    num_kp_levels: int = 3         # keypoint levels per octave
    sigma_n: float = 1.15          # nominal scale of the input data
    sigma0: float = 1.6            # scale of the base pyramid level

    # --- compile-time switches of the reference ---
    cuboid_extrema: bool = False   # full 80-neighbor extrema test (sift.c:24)
    gauss_width_fctr: float = 3.0  # kernel half-width = ceil(fctr * sigma)

    # --- internal constants (sift.c:38-45) ---
    max_eig_ratio: float = 0.90
    ori_grad_thresh: float = 1e-10
    bary_eps: float = _FLT_EPSILON * 1e1
    ori_sig_fctr: float = 1.5
    ori_rad_fctr: float = 3.0
    desc_sig_fctr: float = 7.071067812   # 5 * sqrt(2)
    desc_rad_fctr: float = 2.0
    trunc_thresh: float = 0.2 * 128.0 / DESC_NUMEL

    # --- opt-in extensions of the JAX package (refinement.py) ---
    refine_subvoxel: bool = False
    edge_thresh: Optional[float] = None

    def __post_init__(self):
        # The reference setters' range checks (sift.c:499-565).
        if not (0.0 < self.peak_thresh <= 1.0):
            raise ValueError(
                f"peak_thresh must be in (0, 1], got {self.peak_thresh}")
        if not (0.0 <= self.corner_thresh <= 1.0):
            raise ValueError(
                f"corner_thresh must be in [0, 1], got {self.corner_thresh}")
        if self.num_kp_levels < 1:
            raise ValueError(
                f"num_kp_levels must be >= 1, got {self.num_kp_levels}")
        if self.sigma_n < 0.0:
            raise ValueError(f"sigma_n must be >= 0, got {self.sigma_n}")
        if self.sigma0 < 0.0:
            raise ValueError(f"sigma0 must be >= 0, got {self.sigma0}")
        # sigma_n may not exceed the scale of the first pyramid level
        # (set_scales_Pyramid check, imutil.c:1582-1588).
        if self.sigma_n > self.first_level_scale:
            raise ValueError(
                f"sigma_n ({self.sigma_n}) exceeds the scale of the first "
                f"pyramid level ({self.first_level_scale})")
        if self.edge_thresh is not None and self.edge_thresh < 1.0:
            raise ValueError(
                f"edge_thresh must be >= 1 (eigenvalue magnitude ratio), "
                f"got {self.edge_thresh}")

    @property
    def extensions(self) -> bool:
        """Subvoxel refinement or edge rejection is on."""
        return self.refine_subvoxel or self.edge_thresh is not None

    # --- derived pyramid structure (resize_SIFT3D, sift.c:434-435) ---

    @property
    def first_level(self) -> int:
        return -1  # sift.c:437

    @property
    def num_dog_levels(self) -> int:
        return self.num_kp_levels + 2

    @property
    def num_gpyr_levels(self) -> int:
        return self.num_dog_levels + 1

    def level_scale(self, octave: int, level: int) -> float:
        """sigma(o, s) = sigma0 * 2^(o + s/num_kp_levels)
        (set_scales_Pyramid, imutil.c:1578-1579)."""
        return self.sigma0 * 2.0 ** (octave + level / self.num_kp_levels)

    @property
    def first_level_scale(self) -> float:
        return self.level_scale(0, self.first_level)

    def num_octaves(self, dims: tuple[int, int, int]) -> int:
        """last_octave = floor(log2(min dim)) - 3, i.e. the smallest level
        has >= 8 voxels per dimension (resize_SIFT3D, sift.c:441-454)."""
        last_octave = int(math.log2(float(min(dims)))) - 3
        if last_octave < 0:
            raise ValueError(
                f"input too small: must have at least 8 voxels per "
                f"dimension, got {dims}")
        return last_octave + 1


def from_jax_params(d: dict) -> DetectorParams:
    """DetectorParams from ``dataclasses.asdict`` of the JAX package's
    DetectorParams: the reference fields and the two extensions are kept,
    the execution knobs of the TPU pipeline are dropped."""
    keep = {f.name for f in dataclasses.fields(DetectorParams)}
    return DetectorParams(**{k: v for k, v in d.items() if k in keep})

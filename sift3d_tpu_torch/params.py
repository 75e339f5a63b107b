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

Last come the execution knobs of the JAX package's TPU pipeline
(sift3d_tpu/params.py:68-176), with its names, defaults and checks, so
that every configuration of the JAX package is one of the port's
(from_jax_params) and a value JAX refuses is refused here too. They
choose how the TPU computes, never what: on every other backend the JAX
package computes all of them in f32, and the port computes its one exact
f32 path at every value:

- conv_precision, conv_tail_precision, conv_exact_from_octave: MXU passes
  of the blur matmuls. JAX's CPU blur is f32 whatever they say; the
  port's blur kernels are f32 on CUDA cores (csrc/blur.cu, rounded
  multiply and add, no FMA).
- gpyr_impl: the port always runs its sequential chain (s3d_blur_x +
  s3d_blur_yz_dog), which is JAX's "incremental" and "chain" order (and
  the goldens'). "auto" and "composed" are JAX's composed operators off a
  TPU; against them the chain meets every reference bar but the stale
  strength, whose DoG values the composed rounding moves by as much as
  it moves JAX's own sequential order (tests/test_torch_params.py).
- desc_precision: bf16 weight products exist only in the TPU descriptor
  kernel; JAX's CPU descriptor is f32 at both values, and s3d_desc_fused
  sums exact integers of f32 factors at both.
- desc_vbins: how the TPU kernel receives the spatial bins; JAX's CPU
  path ignores it, and s3d_desc_fused rebuilds each voxel's bins from the
  rotation at both values.
- extrema_impl: every value gives the same candidates in JAX; the port
  launches s3d_extrema_candidates on a CUDA tensor at every value ("xla"
  does not reach the plain version there) and the plain route on a CPU
  tensor.
- kp_per_level: JAX's candidate capacity, retried larger on overflow, so
  its results never depend on it; the port counts the candidates exactly.
- dense_octave_acc, dense_octave_cand, sparse_desc_groups,
  split_desc_chunks, min_chunk_cost, hint_history: the hinted TPU
  programs' policy; validated, no effect.
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

    # --- the JAX package's TPU execution knobs (sift3d_tpu/params.py:
    #     68-176); the port computes its exact f32 path at every value
    #     (module notes) ---
    kp_per_level: Optional[int] = None
    conv_precision: str = "high_xy"
    desc_precision: str = "default"
    conv_tail_precision: str = "high"
    conv_exact_from_octave: int = 2
    gpyr_impl: str = "auto"
    dense_octave_acc: int = 64
    dense_octave_cand: int = 512
    sparse_desc_groups: bool = True
    split_desc_chunks: int = 4
    min_chunk_cost: int = 3_500_000
    hint_history: int = 4
    desc_vbins: str = "affine"
    extrema_impl: str = "auto"

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
        # The JAX package's checks of its execution knobs
        # (sift3d_tpu/params.py:216-246).
        if self.conv_precision not in ("highest", "high_xy", "high",
                                       "default"):
            raise ValueError(
                f"conv_precision must be 'highest', 'high_xy', 'high' or "
                f"'default', got {self.conv_precision!r}")
        if self.desc_precision not in ("highest", "default"):
            raise ValueError(
                f"desc_precision must be 'highest' or 'default', "
                f"got {self.desc_precision!r}")
        if self.conv_tail_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"conv_tail_precision must be 'highest', 'high' or "
                f"'default', got {self.conv_tail_precision!r}")
        if self.conv_exact_from_octave < 0:
            raise ValueError(
                f"conv_exact_from_octave must be >= 0, "
                f"got {self.conv_exact_from_octave}")
        if self.dense_octave_acc < 1 or self.dense_octave_cand < 1:
            raise ValueError(
                f"dense_octave_acc/cand must be >= 1, got "
                f"{self.dense_octave_acc}/{self.dense_octave_cand}")
        if self.split_desc_chunks < 0:
            raise ValueError(
                f"split_desc_chunks must be >= 0, "
                f"got {self.split_desc_chunks}")
        if self.min_chunk_cost < 0:
            raise ValueError(
                f"min_chunk_cost must be >= 0, got {self.min_chunk_cost}")
        if self.hint_history < 1:
            raise ValueError(
                f"hint_history must be >= 1, got {self.hint_history}")
        if self.desc_vbins not in ("packed", "affine"):
            raise ValueError(
                f"desc_vbins must be 'packed' or 'affine', "
                f"got {self.desc_vbins!r}")
        if self.extrema_impl not in ("auto", "xla", "pallas", "interpret"):
            raise ValueError(
                f"extrema_impl must be 'auto', 'xla', 'pallas' or "
                f"'interpret', got {self.extrema_impl!r}")
        if self.gpyr_impl not in ("auto", "composed", "incremental",
                                  "chain"):
            raise ValueError(
                f"gpyr_impl must be 'auto', 'composed', 'incremental' or "
                f"'chain', got {self.gpyr_impl!r}")

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
    DetectorParams, every field kept; a field the port does not know
    raises ValueError."""
    known = {f.name for f in dataclasses.fields(DetectorParams)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"fields the port does not know: {unknown}")
    return DetectorParams(**d)

"""Scale-space pyramid: host-side plan and the per-octave builder.

Reference semantics (citations into the SIFT3D C sources):
 - level scale sigma(o, s) = sigma0 * 2^(o + s/num_kp_levels)
   (imutil.c:1578-1579); first_level = -1 (sift.c:437).
 - octave dims halve (integer) per octave (imutil.c:1545-1548); the octave
   count is floor(log2(min dim)) - 3 + 1 (sift.c:441-454).
 - the first blur takes the [-1, 1]-scaled input from sigma_n to
   sigma(0, -1); level s is level s-1 blurred by the octave-0 incremental
   kernel for (s-1 -> s); the next octave starts from every 2nd voxel of
   level (last - 2) (build_gpyr, sift.c:662-711; im_downsample_2x,
   imutil.c:591-617).
 - the octave-0 kernel bank serves every octave with unit = 1.0, so the tap
   spacing in voxels is 1/units (apply_Sep_FIR_filter, imutil.c:1127).
 - DoG[s] = gpyr[s] - gpyr[s+1] (build_dog, sift.c:713-732).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .filters import conv_diagonals, gauss_kernel, incremental_sigma
from .params import DetectorParams


@dataclasses.dataclass(frozen=True)
class PyramidPlan:
    """Static description of the pyramid for one (dims, units, params)."""
    params: DetectorParams
    input_dims: tuple[int, int, int]
    units: tuple[float, float, float]
    num_octaves: int
    # octave_dims[o] = (nx, ny, nz)
    octave_dims: tuple[tuple[int, int, int], ...]
    # scales[o][i]: absolute scale of stacked level i (raw level
    # s = i + first_level)
    scales: tuple[tuple[float, ...], ...]
    # float32 taps: first_taps blur the input; level_taps[i] blurs stacked
    # level i-1 -> i (i = 1..num_gpyr_levels-1)
    first_taps: tuple[float, ...]
    level_taps: tuple[tuple[float, ...], ...]

    @property
    def num_gpyr_levels(self) -> int:
        return self.params.num_gpyr_levels

    def level_units(self, octave: int) -> tuple[float, float, float]:
        f = 2.0 ** octave
        return tuple(u * f for u in self.units)

    def unit_factor(self, octave: int, axis: int) -> float:
        """Tap spacing in voxels at this octave and axis: the reference
        applies the kernel bank with unit = 1.0 (build_gpyr, sift.c:675),
        so unit_factor = 1 / level_units (imutil.c:754-755)."""
        return 1.0 / self.level_units(octave)[axis]

    def conv_diags(self, octave: int, taps) -> list[tuple[np.ndarray, int]]:
        """Per-axis banded operators (Wd, lo) of one blur at one octave."""
        dims = self.octave_dims[octave]
        return [conv_diagonals(dims[a], np.asarray(taps, np.float32),
                               self.unit_factor(octave, a))
                for a in range(3)]


def make_plan(input_dims: Sequence[int], units: Sequence[float],
              params: DetectorParams) -> PyramidPlan:
    dims = tuple(int(d) for d in input_dims)
    units = tuple(float(u) for u in units)
    num_octaves = params.num_octaves(dims)

    octave_dims = [dims]
    for _ in range(1, num_octaves):
        octave_dims.append(tuple(d // 2 for d in octave_dims[-1]))

    L = params.num_gpyr_levels
    fl = params.first_level
    scales = tuple(
        tuple(params.level_scale(o, i + fl) for i in range(L))
        for o in range(num_octaves))

    wf = params.gauss_width_fctr
    first_taps = gauss_kernel(
        incremental_sigma(params.sigma_n, scales[0][0]), wf)
    level_taps = [()]  # stacked level 0 has no incremental filter
    for i in range(1, L):
        level_taps.append(tuple(gauss_kernel(
            incremental_sigma(scales[0][i - 1], scales[0][i]), wf).tolist()))

    return PyramidPlan(
        params=params, input_dims=dims, units=units, num_octaves=num_octaves,
        octave_dims=tuple(octave_dims), scales=scales,
        first_taps=tuple(first_taps.tolist()), level_taps=tuple(level_taps))


def scale_to_unit(vol: torch.Tensor) -> torch.Tensor:
    """Scale to [-1, 1] by the max absolute value (im_scale,
    imutil.c:697-713); a zero image passes through unchanged."""
    m = vol.abs().max()
    return torch.where(m == 0.0, vol, vol / m)


def downsample_2x(vol: torch.Tensor) -> torch.Tensor:
    """Every 2nd voxel; output dims floor(n/2) (im_downsample_2x,
    imutil.c:591-617)."""
    nx, ny, nz = (d // 2 for d in vol.shape)
    return vol[: 2 * nx: 2, : 2 * ny: 2, : 2 * nz: 2].contiguous()


def build_gpyr_and_dog(vol: torch.Tensor, plan: PyramidPlan):
    """Per octave: gpyr f32[L, nx, ny, nz], dog f32[L-1, nx, ny, nz] and
    dogmax f32[L-1] (per-level max |DoG|), each octave built by
    ops.blur_kernel.chain_octave. vol is the [-1, 1]-scaled input."""
    from .ops.blur_kernel import chain_octave
    L = plan.num_gpyr_levels
    gpyr, dogs, dogmax = [], [], []
    for o in range(plan.num_octaves):
        src = vol if o == 0 else downsample_2x(gpyr[o - 1][L - 3])
        gp, dg, dm = chain_octave(src, plan, o)
        gpyr.append(gp)
        dogs.append(dg)
        dogmax.append(dm)
    return gpyr, dogs, dogmax

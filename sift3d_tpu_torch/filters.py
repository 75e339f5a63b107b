"""Host-side filter construction: Gaussian taps and banded blur operators.

The reference blurs its scale space with a separable FIR filter that has
three quirks (convolve_sep_gen, imutil.c:742-861):

 1. Tap positions are scaled by ``unit_factor = filter_unit / voxel_unit``
    and sampled with linear interpolation, so one physical-units kernel
    serves every octave (imutil.c:754-757, 805-818).
 2. Boundaries mirror with C int-truncation semantics and a ``0.1`` epsilon
    on the upper edge, so the upper boundary is a 0.9/0.1 lerp of the two
    outermost samples (imutil.c:843-850).
 3. Fractional positions in (-1, 0) do not mirror and extrapolate.

Each axis pass is therefore a fixed linear map of the n samples along that
axis, stored here as a band: ``out[i] = sum_k Wd[i, k] * in[i + lo + k]``.
The blur kernel (ops/blur_kernel.py) applies it.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# DBL_EPSILON in init_Gauss_filter's `x /= sigma + DBL_EPSILON`
# (imutil.c:1291).
_DBL_EPSILON = 2.220446049250313e-16
# The upper-boundary mirror fudge (conv_eps, imutil.c:752).
_CONV_EPS = np.float32(0.1)


def gauss_kernel(sigma: float, width_fctr: float = 3.0) -> np.ndarray:
    """Normalized Gaussian taps, float32, as init_Gauss_filter
    (imutil.c:1267-1319): half-width max(ceil(width_fctr*sigma), 1),
    float32 tap values, sequential float32 normalization."""
    half_width = max(int(math.ceil(sigma * width_fctr)), 1) if sigma > 0 else 1
    width = 2 * half_width + 1
    kernel = np.empty(width, dtype=np.float32)
    for i in range(width):
        x = (float(i) - half_width) / (sigma + _DBL_EPSILON)
        kernel[i] = np.float32(math.exp(-0.5 * x * x))
    acc = np.float32(0.0)
    for i in range(width):
        acc = np.float32(acc + kernel[i])
    return kernel / acc


def incremental_sigma(s_cur: float, s_next: float) -> float:
    """Blur increment from absolute scale s_cur to s_next
    (init_Gauss_incremental_filter, imutil.c:1322-1343)."""
    if s_cur > s_next:
        raise ValueError(f"s_cur ({s_cur}) > s_next ({s_next})")
    return math.sqrt(s_next * s_next - s_cur * s_cur)


@functools.lru_cache(maxsize=None)
def _conv_matrix(n: int, taps: tuple, unit_factor: float) -> np.ndarray:
    """The n x n matrix W with ``out = W @ signal`` for one pass."""
    taps_arr = np.asarray(taps, dtype=np.float32)
    half_width = len(taps_arr) // 2
    uf = np.float32(unit_factor)
    dim_end = n - 1

    W = np.zeros((n, n), dtype=np.float64)
    xs = np.arange(n, dtype=np.float32)
    for d in range(-half_width, half_width + 1):
        tap = float(taps_arr[d + half_width])
        step = np.float32(np.float32(d) * uf)
        pos = xs - step
        # Mirror rule with C int-truncation semantics (imutil.c:843-850).
        ipos = np.trunc(pos).astype(np.int64)
        lo_mask = ipos < 0
        hi_mask = (~lo_mask) & (ipos >= dim_end)
        pos = np.where(lo_mask, -pos, pos)
        pos = np.where(
            hi_mask,
            np.float32(2.0 * dim_end).astype(np.float32) - pos - _CONV_EPS,
            pos)
        # Linear-interpolated sample (SAMP_AND_ACC, imutil.c:779-796).
        idx_lo = np.trunc(pos).astype(np.int64)
        frac = (pos - idx_lo.astype(np.float32)).astype(np.float64)
        # Clamp on degenerate tiny levels where the C code would read out
        # of bounds (kernel half-width >= n - 1).
        idx_lo_c = np.clip(idx_lo, 0, n - 1)
        idx_hi_c = np.clip(idx_lo + 1, 0, n - 1)
        np.add.at(W, (np.arange(n), idx_lo_c), tap * (1.0 - frac))
        np.add.at(W, (np.arange(n), idx_hi_c), tap * frac)
    return W.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _conv_diagonals(n: int, taps: tuple, unit_factor: float):
    W = _conv_matrix(n, taps, unit_factor)
    rows, cols = np.nonzero(W)
    if rows.size == 0:
        return np.zeros((n, 1), np.float32), 0
    d = cols.astype(np.int64) - rows.astype(np.int64)
    lo, hi = int(d.min()), int(d.max())
    Wd = np.zeros((n, hi - lo + 1), np.float32)
    Wd[rows, cols - rows - lo] = W[rows, cols]
    return Wd, lo


def conv_diagonals(n: int, taps: np.ndarray,
                   unit_factor: float) -> tuple[np.ndarray, int]:
    """Banded form ``(Wd [n, B], lo)`` of one convolve_sep_gen pass along
    an axis of length n: ``out[i] = sum_k Wd[i, k] * signal[i + lo + k]``,
    out-of-range reads carrying zero weight. Cached per
    (n, taps, unit_factor)."""
    return _conv_diagonals(
        n, tuple(np.asarray(taps, np.float32).tolist()), float(unit_factor))

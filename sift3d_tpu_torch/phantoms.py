"""The bench phantoms of bench.py, built with torch on any device.

bench.make_bench_volume and make_dense_volume sum Gaussian blobs in numpy,
which takes minutes for the dense one at 256^3; the card builds the same
volume in about a second. chip_smoke.py and the tools under tools/ use it.
"""

from __future__ import annotations

import numpy as np
import torch

# (seed, blobs, center range, width range) of bench.make_bench_volume
# (bench._make_phantom) and bench.make_dense_volume.
_PHANTOMS = {"sparse": (42, 150, (0.08, 0.92), (0.01, 0.06)),
             "dense": (7, 2500, (0.04, 0.96), (0.006, 0.02))}


def bench_volume(cell: str, n: int, device,
                 seed: int | None = None) -> torch.Tensor:
    """bench.make_bench_volume(n) ("sparse") or make_dense_volume(n)
    ("dense") as f32[n, n, n] on `device`: the same random draws and 1-D
    exponentials in numpy, the same f64 products, rounded to f32 and summed
    blob by blob in the same order, so the volume is bit-identical. Another
    `seed` draws another phantom of the same kind."""
    bench_seed, blobs, cr, sr = _PHANTOMS[cell]
    rng = np.random.default_rng(bench_seed if seed is None else seed)
    ax = np.arange(n, dtype=np.float64)
    vol = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    for _ in range(blobs):
        c = rng.uniform(cr[0] * n, cr[1] * n, 3)
        s = rng.uniform(sr[0] * n, sr[1] * n, 3)
        amp = rng.uniform(0.2, 1.0) * rng.choice([-1, 1])
        e = [torch.from_numpy(np.exp(-(((ax - c[a]) / s[a]) ** 2)))
             .to(device) for a in range(3)]
        eyz = e[1][:, None] * e[2][None, :]
        vol += ((e[0][:, None, None] * eyz[None]) * float(amp)) \
            .to(torch.float32)
    return vol

"""How often torch's first CPU exp call comes out inaccurate.

On the CPU torch computes exp of a float tensor with MKL's vector math,
split over its OpenMP threads. This starts --procs fresh processes; each
computes the orientation moments of the port's plain version
(ops.ori_kernel._moments_chunk: 16 keypoints on two random 48^3 levels)
twice, once cold and once warm, and reports whether the first call's
Gaussian weights differ from the second's, and its largest error against
exp in f64. With --warm each process first calls ops.warm_cpu_math, as
the plain versions do; with --jax it imports jax first, as the tests that
hold the port to the JAX package do.

Usage: python tools/torch_cpu_exp_check.py [--procs 16] [--warm] [--jax]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CHILD = """
import sys
if {jax}:
    import jax  # noqa: F401
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from sift3d_tpu_torch.ops import ori_kernel, warm_cpu_math
from sift3d_tpu_torch.params import DetectorParams
from sift3d_tpu_torch.windows import window_extent

if {warm}:
    warm_cpu_math("cpu")
p = DetectorParams()
rng = np.random.default_rng(3)
levels = torch.from_numpy(rng.normal(size=(2, 48, 48, 48)).astype(np.float32))
coords = rng.integers(2, 46, (16, 3))
lvl = torch.from_numpy(rng.integers(0, 2, 16))
sd = torch.tensor([1.6, 2.0], dtype=torch.float32)[lvl]
fp = torch.cat([torch.from_numpy(coords).float(), sd[:, None]], 1)
rad = p.ori_sig_fctr * 2.0 * p.ori_rad_fctr
ext = tuple(window_extent(rad, 48) for _ in range(3))
args = (levels, lvl, fp, (1.0, 1.0, 1.0), p.ori_sig_fctr, p.ori_rad_fctr,
        ext)
seen = []
exp = torch.exp
def spy(x):
    out = exp(x)
    seen.append((x.clone(), out.clone()))
    return out
torch.exp = spy
ori_kernel._moments_chunk(*args)
ori_kernel._moments_chunk(*args)
(x0, w0), (_, w1) = seen[-2:]
ref = np.exp(x0.numpy().astype(np.float64))
err = float((np.abs(w0.numpy() - ref) / ref).max())
print(int(not torch.equal(w0, w1)), err)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=16)
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args(argv)
    code = _CHILD.format(repo=str(REPO), warm=args.warm, jax=args.jax)
    differ, worst = 0, 0.0
    for _ in range(args.procs):
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, check=True)
        d, e = r.stdout.split()
        differ += int(d)
        worst = max(worst, float(e))
    import torch
    print(f"torch {torch.__version__}, {torch.get_num_threads()} threads, "
          f"warm-up {'on' if args.warm else 'off'}, jax "
          f"{'imported' if args.jax else 'not imported'}: the first exp "
          f"differed from the second in {differ} of {args.procs} processes; "
          f"largest "
          f"relative error of a first call against f64 exp {worst:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line tools of the PyTorch port.

``kpsift3d-torch``: the reference CLI (kpSift3D.c). Same flags as
``kpsift3d``: ``--keys`` / ``--desc`` outputs (at least one required), one
input image, keypoints sorted by strength and truncated to the strongest
100 before saving (kpSift3D.c:122).

``regsift3d-torch``: registration (descriptor matching + RANSAC affine),
with the flags of ``regsift3d``.

Both take ``--device``, the torch device (default ``cuda``; the command
fails without a GPU).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

def _device(name: str):
    """The torch device `name`, or None (after a message) when it is a
    CUDA device and there is no GPU."""
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"Device {name} requested but no CUDA GPU is available "
              "(use --device cpu).", file=sys.stderr)
        return None
    return device


_HELP = """Detect 3D SIFT keypoints and extract their descriptors.

Supported input formats: NIfTI-1 (.nii, .nii.gz)
Supported output formats: .csv, .csv.gz
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kpsift3d-torch", description=_HELP)
    parser.add_argument("--keys", metavar="PATH",
                        help="keypoint output file (.csv/.csv.gz)")
    parser.add_argument("--desc", metavar="PATH",
                        help="descriptor output file (.csv/.csv.gz)")
    parser.add_argument("--limit", type=int, default=100,
                        help="keep the strongest N keypoints (0 = all; "
                             "default 100, as the reference CLI)")
    parser.add_argument("--peak-thresh", type=float, default=None)
    parser.add_argument("--corner-thresh", type=float, default=None)
    parser.add_argument("--num-kp-levels", type=int, default=None)
    parser.add_argument("--sigma-n", type=float, default=None)
    parser.add_argument("--sigma0", type=float, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("image", help="input volume (.nii/.nii.gz)")
    args = parser.parse_args(argv)

    if args.keys is None and args.desc is None:
        print("No outputs specified.", file=sys.stderr)
        return 1

    device = _device(args.device)
    if device is None:
        return 1

    from .io import read_volume
    from .params import DetectorParams
    from .pipeline import SIFT3D

    overrides = {}
    for name, val in [("peak_thresh", args.peak_thresh),
                      ("corner_thresh", args.corner_thresh),
                      ("num_kp_levels", args.num_kp_levels),
                      ("sigma_n", args.sigma_n),
                      ("sigma0", args.sigma0)]:
        if val is not None:
            overrides[name] = val
    params = DetectorParams(**overrides)

    try:
        vol = read_volume(args.image)
    except (OSError, ValueError) as e:
        print(f"Could not read image: {e}", file=sys.stderr)
        return 1

    det = SIFT3D(params, device)
    kp = det.detect_keypoints(vol).sort_by_strength(args.limit)
    if args.keys:
        kp.save(args.keys)
    if args.desc:
        det.extract_descriptors(kp).save(args.desc)
    return 0


def register_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="regsift3d-torch",
        description="Register a moving volume to a fixed volume with SIFT3D "
                    "keypoint matching + RANSAC affine estimation.")
    parser.add_argument("fixed", help="fixed (reference) volume")
    parser.add_argument("moving", help="moving volume")
    parser.add_argument("--matrix", metavar="PATH",
                        help="output affine matrix (.csv)")
    parser.add_argument("--warped", metavar="PATH",
                        help="output resampled moving volume (.nii/.nii.gz)")
    parser.add_argument("--nn-thresh", type=float, default=0.8,
                        help="matching nearest-neighbor ratio threshold")
    parser.add_argument("--err-thresh", type=float, default=5.0,
                        help="RANSAC inlier error threshold (voxels)")
    parser.add_argument("--num-iter", type=int, default=500,
                        help="RANSAC iterations")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    device = _device(args.device)
    if device is None:
        return 1

    from .io import read_volume, write_volume
    from .keypoints import write_csv
    from .registration import register, warp_volume

    fixed = read_volume(args.fixed)
    moving = read_volume(args.moving)
    result = register(fixed, moving, nn_thresh=args.nn_thresh,
                      err_thresh=args.err_thresh, num_iter=args.num_iter,
                      device=device)
    print(f"matches: {result.num_matches}  inliers: {result.num_inliers}")
    if result.affine is None:
        print(f"Registration failed: only {result.num_matches} "
              "descriptor matches (need at least 4 to fit an affine). "
              "Try raising --nn-thresh or using richer volumes.",
              file=sys.stderr)
        return 1
    np.set_printoptions(precision=6, suppress=True)
    print("affine (moving -> fixed):")
    print(result.affine)
    if args.matrix:
        write_csv(args.matrix, result.affine)
    if args.warped:
        write_volume(args.warped, warp_volume(moving, result.affine,
                                              fixed.shape, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())

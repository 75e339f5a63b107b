"""``kpsift3d-torch``: the reference CLI (kpSift3D.c) on the PyTorch port.

Same flags as ``kpsift3d``: ``--keys`` / ``--desc`` outputs (at least one
required), one input image, keypoints sorted by strength and truncated to
the strongest 100 before saving (kpSift3D.c:122). ``--device`` picks the
torch device (default ``cuda``; the command fails without a GPU).
"""

from __future__ import annotations

import argparse
import sys

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

    import torch

    from .io import read_volume
    from .params import DetectorParams
    from .pipeline import SIFT3D

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"Device {args.device} requested but no CUDA GPU is "
              "available (use --device cpu).", file=sys.stderr)
        return 1

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


if __name__ == "__main__":
    sys.exit(main())

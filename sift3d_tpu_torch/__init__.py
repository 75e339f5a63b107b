"""sift3d_tpu_torch: volumetric SIFT3D keypoints and descriptors in
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``sift3d_tpu`` (JAX/Pallas), which stays the reference. The
device is explicit: ``SIFT3D(params, device="cuda")`` runs the CUDA
kernels, ``device="cpu"`` their plain PyTorch versions. Importing this
package never imports jax.
"""

import torch

# Full float32 for every matmul and convolution: the descriptor prep's
# rotations are f32 products, and reduced-precision blurs were measured
# to break keypoint parity at 256^3 in the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .api import detect_and_extract, detect_keypoints  # noqa: E402
from .keypoints import Descriptors, Keypoints  # noqa: E402
from .params import DetectorParams, from_jax_params  # noqa: E402
from .pipeline import SIFT3D  # noqa: E402
from .volume import Volume, as_volume  # noqa: E402

__all__ = ["SIFT3D", "DetectorParams", "from_jax_params", "Keypoints",
           "Descriptors", "Volume", "as_volume", "detect_keypoints",
           "detect_and_extract"]

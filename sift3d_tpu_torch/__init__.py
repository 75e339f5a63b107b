"""sift3d_tpu_torch: volumetric SIFT3D keypoints and descriptors in
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``sift3d_tpu`` (JAX/Pallas), which stays the reference. The
device is explicit: ``SIFT3D(params, device="cuda")`` runs the CUDA
kernels, ``device="cpu"`` their plain PyTorch versions; ``register`` /
``register_sift3d``, ``register_batch``, ``warp_volume`` and
``io.BatchVolumeLoader`` take the same ``device=``. A batch of volumes
runs through ``SIFT3D.detect_keypoints_batch`` and
``extract_descriptors_batch``, over the devices of a mesh axis
(``parallel.make_mesh``) through ``parallel.MeshBatchSIFT3D`` or
``register_batch(mesh=...)``; one volume sharded along z through
``parallel.ShardedSIFT3D``. ``profiling`` times stages, traces them and
renders the detection funnel (``profiling.detect_stats``).
Importing this package never imports jax.
"""

import torch

# Full float32 for every matmul and convolution: the descriptor prep's
# rotations are f32 products, and reduced-precision blurs were measured
# to break keypoint parity at 256^3 in the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .api import detect_and_extract, detect_keypoints, \
    register_sift3d  # noqa: E402
from .keypoints import Descriptors, Keypoints  # noqa: E402
from .params import DESC_NUMEL, DetectorParams, from_jax_params  # noqa: E402
from .pipeline import SIFT3D  # noqa: E402
from .registration import RegistrationResult, register, \
    register_batch, warp_volume  # noqa: E402
from .volume import Volume, as_volume  # noqa: E402
from . import io, profiling  # noqa: E402

__all__ = ["SIFT3D", "DetectorParams", "from_jax_params", "Keypoints",
           "Descriptors", "Volume", "as_volume", "detect_keypoints",
           "detect_and_extract", "register", "register_batch",
           "register_sift3d",
           "warp_volume", "RegistrationResult", "DESC_NUMEL", "io",
           "profiling"]

__version__ = "0.1.0"

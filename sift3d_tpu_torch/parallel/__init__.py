"""Several devices from one process: a volume sharded along z
(spatial.ShardedSIFT3D), and a batch of volumes over a mesh axis
(batch.MeshBatchSIFT3D, and registration.register_batch with mesh= and
axis=).

Counterpart of sift3d_tpu/parallel/. Devices may repeat in a mesh (four
shards on one card, or on the CPU); the shards' tensors move between
devices by explicit copies (halo.py), without torch.distributed.
"""

from .batch import MeshBatchSIFT3D
from .halo import band_halo, sharded_blur_z, z_extend
from .mesh import Mesh, make_mesh
from .spatial import ShardedSIFT3D, max_blur_halo, octave_is_sharded

__all__ = ["Mesh", "MeshBatchSIFT3D", "ShardedSIFT3D", "band_halo",
           "make_mesh", "max_blur_halo", "octave_is_sharded",
           "sharded_blur_z", "z_extend"]

"""Image IO.

Format dispatch as the reference's (im_get_format, imutil.c:318-402):
.nii and .nii.gz are NIfTI; the Analyze extensions (.img/.img.gz/.hdr)
route to the NIfTI reader. Volumes are read onto the CPU; the detector
moves them to its device. Batches of volumes stream through
``BatchVolumeLoader`` (io/loader.py), which reads them with the native
threaded reader and uploads them to the card ahead of the consumer.
"""

from __future__ import annotations

import numpy as np

from ..volume import Volume
from .loader import BatchVolumeLoader, group_by_shape, \
    iter_volume_batches, peek_header
from .nifti import read_nifti, write_nifti

_NIFTI_EXTS = (".nii", ".nii.gz", ".img", ".img.gz", ".hdr", ".hdr.gz")


def read_volume(path) -> Volume:
    """Read a single-channel volume file into a CPU Volume."""
    p = str(path)
    if not any(p.endswith(e) for e in _NIFTI_EXTS):
        raise ValueError(f"unsupported image format: {p}")
    data, units = read_nifti(p)
    if data.ndim == 4:
        if data.shape[-1] != 1:
            raise ValueError(
                "only single-channel volumes are supported by the detector")
        data = data[..., 0]
    return Volume.from_array(data, units)


def write_volume(path, vol) -> None:
    if isinstance(vol, Volume):
        write_nifti(path, vol.data.cpu().numpy(), vol.units)
    else:
        write_nifti(path, np.asarray(vol))


__all__ = ["read_volume", "write_volume", "read_nifti", "write_nifti",
           "BatchVolumeLoader", "iter_volume_batches", "group_by_shape",
           "peek_header"]

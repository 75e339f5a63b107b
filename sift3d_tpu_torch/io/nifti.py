"""Pure-Python NIfTI-1 reader/writer (numpy only).

Replaces the reference's nifticlib dependency (nifti.c) with a
dependency-free implementation of the same semantics:

 - read .nii / .nii.gz / .img (Analyze extension routed to the NIfTI reader,
   im_get_format, imutil.c:318-331);
 - the same 10 scalar dtypes (read_nii switch, nifti.c:113-152);
 - scl_slope/scl_inter applied when slope != 0 (nifti.c:101-111);
 - dim[0] in {3, 4}: a 4th dimension is read as channels (nifti.c:75-97);
 - voxel units from pixdim (nifti.c:88-91);
 - write: float32, dims + units, slope 1 / inter 0 (write_nii,
   nifti.c:171-222).

The NIfTI-1 header is a fixed 348-byte C struct; we parse it with the struct
module. Data is x-fastest on disk (Fortran order), converted to [nx, ny, nz]
(+ channels) arrays.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes (the set the reference supports,
# nifti.c:113-152).
_DTYPES = {
    2: np.uint8,       # DT_UINT8
    4: np.int16,       # DT_INT16
    8: np.int32,       # DT_INT32
    16: np.float32,    # DT_FLOAT32
    64: np.float64,    # DT_FLOAT64
    256: np.int8,      # DT_INT8
    512: np.uint16,    # DT_UINT16
    768: np.uint32,    # DT_UINT32
    1024: np.int64,    # DT_INT64
    1280: np.uint64,   # DT_UINT64
}
_DT_FLOAT32 = 16

_HDR_SIZE = 348
_MAGIC_OFFSET = 344


def _open_maybe_gz(path, mode="rb"):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, mode)
    return open(p, mode)


def _resolve_pair(path):
    """Resolve a two-file .hdr/.img pair from EITHER member's name, the way
    nifticlib does (the reference routes Analyze extensions to the NIfTI
    reader, imutil.c:318-331, and nifticlib locates the sibling from the
    basename, nifti.c:52-62). Returns (header_path, img_path); img_path is
    None for single-file inputs (.nii/.nii.gz)."""
    p = str(path)
    lower = p.lower()
    for ext, mate in ((".hdr", ".img"), (".img", ".hdr")):
        for gz in (".gz", ""):
            if lower.endswith(ext + gz):
                stem = p[:len(p) - len(ext) - len(gz)]

                def find(base, preferred_gz=gz):
                    for g in (preferred_gz, "", ".gz"):
                        cand = base + g
                        if Path(cand).exists():
                            return cand
                    return base + preferred_gz

                if ext == ".hdr":
                    return p, find(stem + ".img")
                return find(stem + ".hdr"), p
    return p, None


def read_nifti(path):
    """Read a NIfTI-1 volume (.nii/.nii.gz, or either member of a
    .hdr/.img pair, optionally gzipped).

    Returns (data, units): data is float32 [nx, ny, nz] (or [nx, ny, nz, nc]
    when the file is 4-D), units is (ux, uy, uz) from pixdim.
    """
    hdr_path, img_path = _resolve_pair(path)
    with _open_maybe_gz(hdr_path) as f:
        hdr = f.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        endian = "<"
        if sizeof_hdr != _HDR_SIZE:
            sizeof_hdr = struct.unpack_from(">i", hdr, 0)[0]
            if sizeof_hdr != _HDR_SIZE:
                raise ValueError(f"{path}: not a NIfTI-1 file")
            endian = ">"
        magic = hdr[_MAGIC_OFFSET:_MAGIC_OFFSET + 4]
        analyze = magic[:3] not in (b"n+1", b"ni1")
        if analyze and img_path is None:
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

        dim = struct.unpack_from(endian + "8h", hdr, 40)
        datatype = struct.unpack_from(endian + "h", hdr, 70)[0]
        pixdim = struct.unpack_from(endian + "8f", hdr, 76)
        vox_offset = struct.unpack_from(endian + "f", hdr, 108)[0]
        scl_slope = struct.unpack_from(endian + "f", hdr, 112)[0]
        scl_inter = struct.unpack_from(endian + "f", hdr, 116)[0]
        if analyze:
            # ANALYZE 7.5 pair: the scl_slope/scl_inter offsets hold unused
            # fields (funused1/2); no intensity scaling.
            scl_slope, scl_inter = 0.0, 0.0

        ndim = dim[0]
        # Reference semantics: accept 3-D, or 4-D with the 4th dim as
        # channels; reject everything else (nifti.c:69-99).
        if ndim == 4 and dim[4] == 1:
            ndim = 3
        if ndim not in (3, 4):
            raise ValueError(
                f"{path}: unsupported dimensionality {ndim}")
        nx, ny, nz = dim[1], dim[2], dim[3]
        nc = dim[4] if ndim == 4 else 1

        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported datatype {datatype}")
        np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

        if img_path is not None:
            # two-file pair: data in the sibling .img (offset is into the
            # .img file; 0 for pairs written by us and by nifticlib)
            with _open_maybe_gz(img_path) as f2:
                if vox_offset > 0:
                    f2.seek(int(vox_offset))
                raw = f2.read()
        else:
            f.seek(int(vox_offset))
            raw = f.read()

    count = nx * ny * nz * nc
    # Typed copy + scaling (nifti.c:101-155); slope 0 means "no scaling".
    data = np.frombuffer(raw, dtype=np_dtype, count=count).astype(np.float32)
    if scl_slope != 0.0:
        data = data * np.float32(scl_slope) + np.float32(scl_inter)
    # x-fastest on disk.
    if nc > 1:
        data = data.reshape(nc, nz, ny, nx).transpose(3, 2, 1, 0)
    else:
        data = data.reshape(nz, ny, nx).transpose(2, 1, 0)
    units = (float(pixdim[1]), float(pixdim[2]), float(pixdim[3]))
    if not all(u > 0 for u in units):
        units = (1.0, 1.0, 1.0)
    return np.ascontiguousarray(data), units


def write_nifti(path, data, units=(1.0, 1.0, 1.0)) -> None:
    """Write a float32 NIfTI-1 volume (write_nii, nifti.c:171-222).

    A .hdr or .img target (optionally .gz) writes the two-file pair
    (magic "ni1", data at offset 0 of the .img)."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 3:
        nx, ny, nz = data.shape
        nc = 1
    elif data.ndim == 4:
        nx, ny, nz, nc = data.shape
    else:
        raise ValueError(f"expected 3-D or 4-D data, got {data.shape}")

    hdr_path, img_path = _resolve_pair(path)
    pair = img_path is not None

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    ndim = 3 if nc == 1 else 4
    struct.pack_into("<8h", hdr, 40, ndim, nx, ny, nz, nc, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, _DT_FLOAT32)   # datatype
    struct.pack_into("<h", hdr, 72, 32)            # bitpix
    struct.pack_into("<8f", hdr, 76, 0.0, units[0], units[1], units[2],
                     1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 0.0 if pair else 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)          # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)          # scl_inter
    hdr[_MAGIC_OFFSET:_MAGIC_OFFSET + 4] = (b"ni1\x00" if pair
                                            else b"n+1\x00")

    if nc > 1:
        payload = data.transpose(3, 2, 1, 0).tobytes()
    else:
        payload = data.transpose(2, 1, 0).tobytes()
    if pair:
        with _open_maybe_gz(hdr_path, "wb") as f:
            f.write(bytes(hdr))
            f.write(b"\x00" * 4)  # extension flag
        with _open_maybe_gz(img_path, "wb") as f:
            f.write(payload)
    else:
        with _open_maybe_gz(path, "wb") as f:
            f.write(bytes(hdr))
            f.write(b"\x00" * 4)  # extension flag
            f.write(payload)

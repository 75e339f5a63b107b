"""The native IO runtime: ctypes bindings of csrc/fastio.cc.

Counterpart of sift3d_tpu/native (the port's own copy of its C++ source):
the typed payload cast of the NIfTI reader, the reference-format CSV
writer, and the threaded batch reader of single-file NIfTI-1 volumes that
io.loader drives, one GIL-free call per batch.

At first use the source is compiled with g++ (-O3, linked against zlib)
into ``build/sift3d_tpu_torch/libs3d_fastio.so`` under the checkout root,
next to the CUDA kernels' library, and rebuilt when the source, the flags
or the compiler change (a hash of the three is stored beside it). A failed
build raises with the compiler's message: no entry point has another
implementation to fall back to. The batch reader routes by file instead:
a volume it returns a non-zero code for (.hdr/.img pairs, big-endian
files) is read by the numpy reader (io/nifti.py), as
sift3d_tpu/io/loader.py:83-103 does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "fastio.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "sift3d_tpu_torch"
LIB_NAME = "libs3d_fastio.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_C, _P, _I, _F = ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, \
    ctypes.c_float
_LL = ctypes.c_longlong
# (restype, argtypes) of every entry point.
_SIGNATURES = {
    "s3d_read_all": (_LL, (_C, _P, _LL)),
    "s3d_cast_to_f32": (_I, (_P, _P, _LL, _I, _F, _F, _I)),
    "s3d_csv_write": (_I, (_C, _P, _LL, _LL, _I)),
    "s3d_nifti_read_f32": (_I, (_C, _P, _LL, _P, _P)),
    "s3d_nifti_read_batch": (None, (ctypes.POINTER(_C), _I, _P, _LL, _P, _P,
                                    _P, _I)),
}

# Bytes per value of each NIfTI-1 datatype the cast takes.
ITEMSIZE = {2: 1, 4: 2, 8: 4, 16: 4, 64: 8, 256: 1, 512: 2, 768: 4,
            1024: 8, 1280: 8}

_lock = threading.Lock()
_lib = None


def _build(so: Path, stamp: Path, digest: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = str(Path(tmp) / LIB_NAME)
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", out, "-lz"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(out, so)
        Path(tmp, "stamp").write_text(digest)
        os.replace(Path(tmp, "stamp"), stamp)


def lib() -> ctypes.CDLL:
    """The loaded native library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / (LIB_NAME + ".sha256")
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(SOURCE.read_bytes())
        h.update(subprocess.run(["g++", "--version"], capture_output=True,
                                text=True).stdout.encode())
        digest = h.hexdigest()
        if not so.exists() or not stamp.exists() \
                or stamp.read_text() != digest:
            _build(so, stamp, digest)
        handle = ctypes.CDLL(str(so))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = handle
        return _lib


def cast_to_f32(raw: bytes, dtype_code: int, count: int, slope: float,
                inter: float, apply_scaling: bool) -> np.ndarray:
    """f32[count] from a little-endian NIfTI payload of datatype
    `dtype_code`, times slope plus inter where apply_scaling (read_nii,
    nifti.c:101-155)."""
    if dtype_code not in ITEMSIZE:
        raise ValueError(f"unsupported NIfTI datatype {dtype_code}")
    if len(raw) < count * ITEMSIZE[dtype_code]:
        raise ValueError(f"payload of {len(raw)} bytes for {count} values "
                         f"of datatype {dtype_code}")
    out = np.empty(count, np.float32)
    lib().s3d_cast_to_f32(raw, out.ctypes.data_as(_P), count, dtype_code,
                          slope, inter, 1 if apply_scaling else 0)
    return out


def csv_write(path, mat: np.ndarray) -> None:
    """Write mat f64[rows, cols] in the reference's CSV format ('%f',
    comma-delimited, a newline after each row; gzip for a .gz name)."""
    mat = np.ascontiguousarray(mat, np.float64)
    if mat.ndim != 2:
        raise ValueError(f"csv_write: expected a 2-D matrix, got {mat.shape}")
    rows, cols = mat.shape
    rc = lib().s3d_csv_write(str(path).encode(), mat.ctypes.data_as(_P),
                             rows, cols, 1 if str(path).endswith(".gz") else 0)
    if rc != 0:
        raise OSError(f"{path}: could not write the CSV file")


def nifti_read_batch(paths, count_per_vol: int, nthreads: int = 0,
                     out: np.ndarray | None = None):
    """Read a batch of single-file NIfTI-1 volumes (.nii/.nii.gz) into one
    f32[B, count_per_vol] buffer (`out`, where given: pinned host memory,
    say) with the threaded reader, one call for the whole batch.

    Returns (flat f32[B, count], dims i64[B, 4], units f32[B, 3],
    rc i32[B]); rc[i] != 0 marks a volume the native reader does not take
    (.hdr/.img pairs, big-endian files, read errors), for the numpy
    reader."""
    n = len(paths)
    if out is None:
        out = np.empty((n, count_per_vol), np.float32)
    if out.shape != (n, count_per_vol) or out.dtype != np.float32 \
            or not out.flags.c_contiguous:
        raise ValueError("nifti_read_batch: out must be a contiguous "
                         f"f32[{n}, {count_per_vol}]")
    dims = np.zeros((n, 4), np.int64)
    units = np.zeros((n, 3), np.float32)
    rc = np.zeros(n, np.int32)
    arr = (_C * n)(*[str(p).encode() for p in paths])
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 1)
    lib().s3d_nifti_read_batch(
        arr, n, out.ctypes.data_as(_P), count_per_vol,
        dims.ctypes.data_as(_P), units.ctypes.data_as(_P),
        rc.ctypes.data_as(_P), nthreads)
    return out, dims, units, rc

"""Build and load the package's CUDA kernels.

The sources under ``sift3d_tpu_torch/csrc/`` have a plain C interface.
At first use they are compiled with nvcc for sm_90a, one nvcc per
source, all started together, and linked into one shared library,
``build/sift3d_tpu_torch/libs3d_kernels.so`` under the checkout root,
and loaded with ctypes. The library is rebuilt when a source or a
flag changes (a hash of both is stored beside it).

Every entry point returns ``cudaGetLastError()`` after its launch;
``call`` raises on a non-zero code, so a launch that the device refuses
never passes silently, and counts each launch in the recorder
(``profiling.counter("launch.<symbol>")``). A build is a span
``sift3d.kernels.build`` and counts ``kernels.builds``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .. import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("blur.cu", "extrema.cu", "ori.cu", "desc.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sift3d_tpu_torch"
LIB_NAME = "libs3d_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64 = ctypes.c_int64
# argtypes of every entry point; each returns a cudaError_t as int.
_SIGNATURES = {
    "s3d_blur_x": (_P, _P, _P, _I, _I, _I, _I64, _I64, _I, _I, _I, _I, _I,
                   _P),
    "s3d_blur_yz_dog": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I,
                        _I64, _I64, _I64, _I64, _I64, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P),
    "s3d_extrema_candidates": (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _P),
    "s3d_orient": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P),
    "s3d_eigh3x3": (_P, _P, _P, _I64, _P),
    "s3d_desc_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                       _F, _P),
}
# The recorder's launch counter of each entry point.
LAUNCH_COUNTERS = {name: "launch." + name for name in _SIGNATURES}

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "sift3d_tpu_torch are built on a machine with "
                           "the CUDA toolkit")
    return found


def source_paths() -> list[Path]:
    return [CSRC / s for s in SOURCES]


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in source_paths():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _run(cmd) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")


def _build(so: Path, stamp: Path, digest: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with profiling.span("sift3d.kernels.build"):
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [str(Path(tmp) / (p.stem + ".o")) for p in source_paths()]
            compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                        for o, p in zip(objs, source_paths())]
            with ThreadPoolExecutor(len(compiles)) as pool:
                list(pool.map(_run, compiles))
            out = str(Path(tmp) / LIB_NAME)
            _run([nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs])
            os.replace(out, so)
        stamp.write_text(digest)
    profiling.count("kernels.builds")


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    so, stamp = BUILD_DIR / LIB_NAME, BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if not so.exists() or not stamp.exists() or stamp.read_text() != digest:
        _build(so, stamp, digest)
    handle = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.s3d_error_string.argtypes = (ctypes.c_int,)
    handle.s3d_error_string.restype = ctypes.c_char_p
    _lib = handle
    return _lib


def call(name: str, *args) -> None:
    """Launch entry point `name`; raise if the launch reported an error;
    count the launch."""
    handle = lib()
    rc = getattr(handle, name)(*args)
    if rc != 0:
        msg = handle.s3d_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    profiling.count(LAUNCH_COUNTERS[name])


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on the tensor's device, as an int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, t, dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, where given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")

"""The PyTorch port's package boundary: no jax, no toolchain at import."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import sift3d_tpu_torch
import sift3d_tpu_torch.cli, sift3d_tpu_torch.io
import sift3d_tpu_torch.profiling
import sift3d_tpu_torch.refinement, sift3d_tpu_torch.registration
import sift3d_tpu_torch.io.loader
import sift3d_tpu_torch.parallel
from sift3d_tpu_torch.parallel import batch, halo, mesh, spatial
from sift3d_tpu_torch import native
from sift3d_tpu_torch.ops import (_build, blur_kernel, desc_kernel,
                                  extrema_kernel, ori_kernel)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sift3d_tpu", "triton"))
print("BAD", bad)
print("LIB", _build._lib, native._lib)
"""


def test_import_loads_no_jax_and_builds_nothing(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    # Nothing is built or loaded at import: nvcc runs at the first launch,
    # g++ at the first native call.
    assert "LIB None None" in r.stdout, r.stdout


def test_kernel_sources_exist_and_export_entry_points():
    from sift3d_tpu_torch.ops import _build
    text = ""
    for p in _build.source_paths():
        assert p.is_file(), p
        text += p.read_text()
    for name in list(_build._SIGNATURES) + ["s3d_error_string"]:
        assert re.search(rf'extern "C" [^(]*\b{name}\(', text), name
    # sm_90a, the Hopper target with wgmma/setmaxnreg.
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_dir_is_git_ignored():
    from sift3d_tpu_torch import native
    from sift3d_tpu_torch.ops import _build
    rel = _build.BUILD_DIR.relative_to(REPO)
    assert rel.parts[0] == "build"
    assert native.BUILD_DIR == _build.BUILD_DIR
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored and "*.so" in ignored


def test_tf32_disabled_at_import():
    import torch
    import sift3d_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("mod, fn, args", [
    ("blur_kernel", "blur_x", 4),
    ("blur_kernel", "blur_yz_dog", 9),
    ("extrema_kernel", "extrema_candidates", 4),
    ("ori_kernel", "orient", 6),
    ("ori_kernel", "eigh3x3", 1),
    ("desc_kernel", "desc_fused", 8),
])
def test_wrappers_use_plain_version_only_on_cpu(mod, fn, args):
    """Each wrapper branches on the tensor's device, never on what is
    installed: a CPU tensor takes the plain version, anything else the
    kernel, through _build.call, which counts the launch in the
    recorder."""
    import importlib
    import inspect
    from sift3d_tpu_torch.ops import _build
    m = importlib.import_module(f"sift3d_tpu_torch.ops.{mod}")
    src = inspect.getsource(getattr(m, fn))
    assert '.device.type == "cpu"' in src
    assert "_build.call(" in src
    assert "profiling.count(LAUNCH_COUNTERS[name])" in \
        inspect.getsource(_build.call)
    assert "try:" not in src
    assert hasattr(m, f"{fn}_plain")


@pytest.mark.parametrize("mod", ["refinement", "registration", "pipeline",
                                 "io/loader", "native", "parallel/__init__",
                                 "parallel/batch", "parallel/mesh",
                                 "parallel/halo", "parallel/spatial",
                                 "profiling"])
def test_new_modules_import_torch_and_no_jax(mod):
    """refinement.py, registration.py, the batch pipeline, the loader, the
    native runtime's bindings, the parallel package and profiling.py name
    nothing of jax or of the JAX package in their imports (the bindings,
    and parallel/__init__ and parallel/batch, which import the package's
    modules only, name no torch)."""
    import ast
    tree = ast.parse((REPO / "sift3d_tpu_torch" / f"{mod}.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert ("torch" in names) == (mod not in ("native",
                                              "parallel/__init__",
                                              "parallel/batch"))
    assert not names & {"jax", "jaxlib", "sift3d_tpu"}, names

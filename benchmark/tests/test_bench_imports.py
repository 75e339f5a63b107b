"""No module a run loads has the top-level name of JAX or of the JAX
package, the reference included; the reference loads nothing of the
program."""

import os
import subprocess
import sys
from pathlib import Path

from benchmark import guard

ROOT = Path(__file__).resolve().parents[2]

_PROBE = """
import sys
from benchmark import harness, guard, control
from benchmark.reference import sift3d_plain
for folder in ("generators", "entries", "checks", "metrics"):
    for path in sorted((harness.HERE / folder).glob("[!_]*.py")):
        harness.load(folder, path.name[:-3])
from benchmark.metrics import _roofline
print("BAD", guard.forbidden_modules())
print("PORT", "sift3d_tpu_torch" in sys.modules)
"""

_REFERENCE = """
import sys
from benchmark.reference import sift3d_plain
from benchmark.checks import _sift3d, keypoints, registration
from benchmark.generators import blob_phantoms
print("PROGRAM", sorted(m for m in sys.modules
                        if m.split(".")[0] == "sift3d_tpu_torch"))
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_a_run_loads_no_jax():
    out = _run(_PROBE)
    assert "BAD []" in out
    assert "PORT True" in out          # the port is what is measured


def test_the_reference_loads_nothing_of_the_program():
    assert "PROGRAM []" in _run(_REFERENCE)


def test_guard_compares_whole_top_level_names():
    mods = ["sift3d_tpu_torch", "sift3d_tpu_torch.ops", "jaxtyping",
            "numpy", "flaxen"]
    assert guard.forbidden_modules(mods) == []
    assert guard.forbidden_modules(mods + ["jax.numpy", "sift3d_tpu.io",
                                           "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib", "sift3d_tpu.io"]

"""The import guard: no module of the JAX package or of JAX may be loaded.

The benchmark measures the PyTorch port alone. A module counts as loaded
from JAX when the part of its name before the first dot is one of
FORBIDDEN, compared whole: ``sift3d_tpu_torch`` is the port, not
``sift3d_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "sift3d_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Names in sys.modules (or `modules`) whose top-level name is
    forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)

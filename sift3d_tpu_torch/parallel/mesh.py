"""Device meshes for one process driving several devices.

Counterpart of sift3d_tpu/parallel/mesh.py:10-22. A Mesh is a grid of
torch devices with named axes; the same device may appear more than
once (four shards on one card: ``["cuda:0"] * 4``; the CPU tests:
``["cpu"] * 4``). One process drives every device of the mesh: the
shards' tensors live on their devices and move between them by explicit
copies (parallel/halo.py), not through torch.distributed.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """Axis names and a grid of torch.device, one grid axis per name."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names for a "
                             f"{devices.ndim}-D device grid")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} "
                             f"(axes {self.axis_names})")
        a = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[a] = slice(None)
        return list(self.devices[tuple(idx)])


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device: pass a mesh of CPU devices, "
                           "e.g. make_mesh({'z': 4}, ['cpu'] * 4)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """A Mesh. `axes` maps axis name -> size; sizes must multiply to the
    device count. Default devices: every visible CUDA device; default
    axes: all devices on one 'b' (batch) axis."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else cuda_devices())]
    n = len(devices)
    if axes is None:
        axes = {"b": n}
    sizes = list(axes.values())
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh axes {axes} do not multiply to {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(sizes), tuple(axes.keys()))

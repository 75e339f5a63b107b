"""Spatial ("context") parallelism: one volume sharded along z over the
devices of a mesh axis.

Counterpart of sift3d_tpu/parallel/spatial.py (ShardedSIFT3D :512, the
unhinted detection :674-720 and the descriptor stage :837-934). Shard s
holds rows [z0_s, z0_s + n_s) of every z-sharded octave, on its own
device; one process drives them all (parallel/mesh.py).

 - Pyramid (build_gpyr_sharded, the per-level halo form of
   spatial.py:113-157): per level, each shard runs the x blur kernel on its
   own rows, then halo.sharded_blur_z takes the x output's halo rows
   from its neighbours (the band's reach) and runs the y/z + DoG kernel
   on that slab, writing and counting in max |DoG| only its own rows. The
   octave's max |DoG| is the max over the shards (the pmax). Octaves that
   fail octave_is_sharded (a shard thinner than the widest band's reach,
   or a depth the shards do not divide) are gathered to the mesh's first
   device and built, and searched, by the single-device code (as the JAX
   package gathers them to replicated form, spatial.py:15-17). The
   composed per-octave form (spatial.py:59-111) is a TPU matmul
   formulation of the same levels and is not ported.
 - Extrema (spatial.py:160-248): a one-voxel z halo per shard, the
   threshold from the global max |DoG|, the interior bound on z global and
   the keys global, through the extrema kernel's z-slab arguments; the
   reference orders candidates by level, then z, y, x (immacros.h:78-82),
   and z is the sharded axis, so each level's candidates are the shards'
   lists in shard order, and the stale-strength column survives sharding.
 - Orientation, refinement and the edge test run shard-local on the
   shard's own candidates (the port of _ori_shard_map, spatial.py:392-447;
   JAX runs the extensions as the single-device program under GSPMD,
   spatial.py:816-835, for which torch has no counterpart): refinement's
   3x3x3 neighbourhood lies in the extrema slab's halo, and the
   orientation windows' halo holds the fractional centres' one-voxel
   shift.
 - Descriptors (the port of _desc_shard_fn, spatial.py:458-509): each
   keypoint goes to the shard that owns its window centre, which extends
   its levels by the descriptor windows' halo and runs the descriptor
   kernel with the slab's z origin.

Every kernel computes a shard's rows with the whole volume's operations
in the whole volume's order, so ShardedSIFT3D gives SIFT3D's keypoints
and descriptors bit for bit. Not ported (tunnel machinery, ROADMAP): the
hint envelope, the fused hinted program and the speculative descriptors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..descriptor import normalize, octave_histograms
from ..keypoints import Descriptors, Keypoints
from ..ops.blur_kernel import _diags, blur_x, chain_octave
from ..ops.desc_kernel import level_radius
from ..params import DESC_NUMEL, DetectorParams
from ..pipeline import COL_LEVEL, COLS_R, SIFT3D, SlabView
from ..profiling import to_host
from ..pyramid import PyramidPlan, make_plan, scale_to_unit
from ..volume import Volume, as_volume
from ..windows import window_extent
from .halo import diag_halo, sharded_blur_z, z_extend, z_extend_one, \
    z_rows
from .mesh import Mesh, cuda_devices, make_mesh


def max_blur_halo(plan: PyramidPlan, octave: int) -> int:
    """Largest z-halo any blur at this octave needs."""
    h = diag_halo(*plan.conv_diags(octave, plan.first_taps)[2])
    for i in range(1, plan.num_gpyr_levels):
        h = max(h, diag_halo(*plan.conv_diags(octave,
                                              plan.level_taps[i])[2]))
    return h


def octave_is_sharded(plan: PyramidPlan, octave: int, ndev: int) -> bool:
    nz = plan.octave_dims[octave][2]
    return nz % ndev == 0 and nz // ndev >= max_blur_halo(plan, octave)


class OctaveSlab:
    """One device's rows [z0, z0 + n) of an octave: gpyr f32[L, nx, ny,
    n], and while the octave is searched dog f32[L-1, nx, ny, n] and
    dogmax f32[L-1] (the max over these rows)."""

    def __init__(self, device, z0: int, n: int, gpyr, dog=None, dogmax=None):
        self.device, self.z0, self.n = device, z0, n
        self.gpyr, self.dog, self.dogmax = gpyr, dog, dogmax


def _blur_level_sharded(srcs, plan, octave: int, level: int, curs,
                        dogs=None, dmaxs=None) -> None:
    """curs[s] = the blur of srcs[s] (the shards' own rows of the previous
    level, or of the source) that makes `level` of `octave`; with dogs,
    also the DoG and each shard's max |DoG| (f32[1] views)."""
    tmps = []
    for src in srcs:
        (wx, lox), _, _ = _diags(plan, octave, level, src.device)
        tmps.append(blur_x(src, wx, lox, torch.empty_like(src)))
    sharded_blur_z(tmps, plan, octave, level, curs,
                   None if dogs is None else srcs, dogs, dmaxs)


def build_gpyr_sharded(vol_shards, plan: PyramidPlan, devices):
    """Gaussian pyramid and DoG of a volume whose [-1, 1]-scaled z-slabs
    vol_shards lie on `devices`, octave by octave: a list of OctaveSlab
    lists, one per octave (a replicated octave: one slab on devices[0]),
    and the sharded flags. Each octave's DoG and max |DoG| are kept for
    its extrema search, which frees them."""
    L = plan.num_gpyr_levels
    ndev = len(devices)
    octaves, flags = [], []
    for o in range(plan.num_octaves):
        nx, ny, nz = plan.octave_dims[o]
        sharded = octave_is_sharded(plan, o, ndev)
        if sharded:
            local = nz // ndev
            ranges = [(devices[s], s * local, local) for s in range(ndev)]
        else:
            ranges = [(devices[0], 0, nz)]
        if o == 0:
            srcs = ([x.contiguous() for x in vol_shards] if sharded else
                    [z_rows(vol_shards, 0, nz, devices[0])])
        else:
            # downsample_2x of level L-3 of the previous octave: every
            # second voxel, global z 2z of the new octave's row z.
            prev = [sl.gpyr[L - 3] for sl in octaves[-1]]
            srcs = []
            for dev, z0, n in ranges:
                rows = z_rows(prev, 2 * z0, 2 * (z0 + n) - 1, dev)
                srcs.append(rows[:2 * nx:2, :2 * ny:2, ::2].contiguous())
        if not sharded:     # the single-device chain on the first device
            gp, dog, dm = chain_octave(srcs[0], plan, o)
            octaves.append([OctaveSlab(devices[0], 0, nz, gp, dog, dm)])
            flags.append(False)
            continue
        slabs = [OctaveSlab(dev, z0, n,
                            torch.empty((L, nx, ny, n), dtype=torch.float32,
                                        device=dev),
                            torch.empty((L - 1, nx, ny, n),
                                        dtype=torch.float32, device=dev),
                            torch.zeros(L - 1, dtype=torch.float32,
                                        device=dev))
                 for dev, z0, n in ranges]
        if o == 0:
            _blur_level_sharded(srcs, plan, 0, 0, [sl.gpyr[0] for sl in slabs])
        else:
            for sl, src in zip(slabs, srcs):
                sl.gpyr[0].copy_(src)
        del srcs
        for i in range(1, L):
            _blur_level_sharded([sl.gpyr[i - 1] for sl in slabs], plan, o, i,
                                [sl.gpyr[i] for sl in slabs],
                                [sl.dog[i - 1] for sl in slabs],
                                [sl.dogmax[i - 1:i] for sl in slabs])
        octaves.append(slabs)
        flags.append(sharded)
    return octaves, flags


def _global_dogmax(slabs) -> torch.Tensor:
    """The octave's max |DoG| per level: the max over the shards' own
    (on the first shard's device)."""
    dev = slabs[0].device
    return torch.stack([sl.dogmax.to(dev) for sl in slabs]).amax(dim=0)


def ori_halo(plan: PyramidPlan, octave: int, params: DetectorParams) -> int:
    """z-halo of the orientation windows of an octave's keypoints: the
    extent of the plain version's windows (so every window of a centre in
    a shard's rows lies in its slab), with the fractional centres' margin
    and scale where an extension is on."""
    nl = params.num_kp_levels
    sd_max = plan.scales[octave][nl] * (2.0 ** (1.0 / nl)
                                        if params.extensions else 1.0)
    rad = params.ori_sig_fctr * sd_max * params.ori_rad_fctr
    return window_extent(rad / plan.level_units(octave)[2],
                         plan.octave_dims[octave][2],
                         4 if params.extensions else 0)


def desc_halo(plan: PyramidPlan, octave: int, params: DetectorParams,
              refined: bool) -> int:
    """z-halo of the descriptor windows of an octave's keypoints (as
    ori_halo; refined keypoints take the fractional margin and scale)."""
    nl = params.num_kp_levels
    sd_max = plan.scales[octave][nl] * (2.0 ** (1.0 / nl) if refined
                                        else 1.0)
    return window_extent(level_radius(sd_max, params)
                         / plan.level_units(octave)[2],
                         plan.octave_dims[octave][2], 4 if refined else 0)


class ShardedSIFT3D:
    """SIFT3D for a volume sharded along z over the devices of a mesh axis.

    Usage::

        mesh = make_mesh({"z": 4}, ["cuda:0"] * 4)   # default: every card
        det = ShardedSIFT3D(mesh=mesh)
        kp = det.detect_keypoints(vol)      # vol [nx, ny, nz]
        desc = det.extract_descriptors(kp)

    Keypoints and descriptors equal SIFT3D's on one device, bit for bit
    (the reference's candidate order and stale strength included); only
    the execution is distributed. A mesh of CUDA devices runs the kernels
    on every shard; a mesh of CPU devices the plain versions.
    """

    def __init__(self, params: DetectorParams = DetectorParams(),
                 mesh: Mesh | None = None, axis: str = "z",
                 stale_strength_compat: bool = True):
        self.params = params
        self.mesh = mesh if mesh is not None else make_mesh(
            {axis: len(cuda_devices())})
        self.axis = axis
        self.devices = self.mesh.axis_devices(axis)
        self.stale_strength_compat = stale_strength_compat
        # One single-device detector per shard device: its octave stage
        # and keypoint assembly run the shards' slabs.
        self._dets = {d: SIFT3D(params, d, stale_strength_compat)
                      for d in self.devices}
        self._plan: PyramidPlan | None = None
        self._octaves = None       # per octave, its OctaveSlab list
        self._shard_flags: list[bool] | None = None
        self._input_shape = None

    def _split(self, vol) -> list[torch.Tensor]:
        """The volume's z-slabs, scaled to [-1, 1] by the volume's max
        |value| (the max over the shards' own), one on each device (the
        whole volume on the first device where the depth does not split
        evenly)."""
        data = torch.as_tensor(vol.data, dtype=torch.float32)
        nz, ndev = data.shape[2], len(self.devices)
        if nz % ndev:
            parts = [data.to(self.devices[0])]
        else:
            n = nz // ndev
            parts = [data[:, :, s * n:(s + 1) * n].to(dev).contiguous()
                     for s, dev in enumerate(self.devices)]
        dev0 = parts[0].device
        m = torch.stack([p.abs().amax().to(dev0) for p in parts]).amax()
        return [scale_to_unit(p, m.to(p.device)) for p in parts]

    def detect_keypoints(self, vol) -> Keypoints:
        if not isinstance(vol, Volume):     # where it lies
            vol = as_volume(vol, vol.device if torch.is_tensor(vol)
                            else "cpu")
        plan = make_plan(vol.shape, vol.units, self.params)
        self._plan, self._octaves = None, None
        octaves, flags = build_gpyr_sharded(self._split(vol), plan,
                                            self.devices)
        nl = self.params.num_kp_levels
        parts = []
        for o, slabs in enumerate(octaves):
            dogmax = _global_dogmax(slabs)
            if not flags[o]:
                sl = slabs[0]
                rows = self._dets[sl.device]._octave(
                    plan, o, sl.gpyr[None], sl.dog[None], dogmax[None])
                blocks = [] if rows is None else [to_host(rows).numpy()]
            else:
                nz = plan.octave_dims[o][2]
                g = ori_halo(plan, o, self.params)
                dogs = z_extend([sl.dog for sl in slabs], 1)
                blocks = []
                for s, sl in enumerate(slabs):
                    levels = z_extend_one([x.gpyr[1:1 + nl] for x in slabs],
                                          s, g)
                    view = SlabView(sl.z0 - 1, (1, 1 + sl.n), levels,
                                    sl.z0 - g, nz)
                    rows = self._dets[sl.device]._octave(
                        plan, o, sl.gpyr[None], dogs[s][None],
                        dogmax.to(sl.device)[None], view)
                    if rows is not None:
                        rows = to_host(rows).numpy()
                        # R reads NaN only where the orientation kernel
                        # found a window outside the slab: a halo too
                        # thin.
                        if np.isnan(rows[:, COLS_R]).any():
                            raise ValueError(
                                f"octave {o}, shard {s}: an orientation "
                                f"window leaves the slab (halo {g})")
                        blocks.append(rows)
                    dogs[s] = None
                    del levels
            for sl in slabs:
                sl.dog = sl.dogmax = None
            if blocks:
                rows = np.concatenate(blocks)
                # Shard-major within each level: the global scan order.
                order = np.argsort(rows[:, COL_LEVEL], kind="stable")
                parts.append((o, 0, 1, rows[order]))
        self._plan, self._octaves, self._shard_flags = plan, octaves, flags
        self._input_shape = tuple(int(d) for d in vol.shape)
        det = self._dets[self.devices[0]]
        # JAX's ShardedSIFT3D keeps no funnel (sift3d_tpu/parallel/
        # spatial.py), nor does this one.
        return det._keypoints(plan, parts, 1)[0][0]

    def extract_descriptors(self, kp: Keypoints) -> Descriptors:
        """Descriptors of the keypoints of the last detect_keypoints: each
        keypoint on the shard that owns its window centre."""
        det = self._dets[self.devices[0]]
        det._input_shape = self._input_shape
        det._verify_keys(kp)
        plan, params = self._plan, self.params
        nl = params.num_kp_levels
        refined = (params.refine_subvoxel
                   or not np.all(kp.coords == np.rint(kp.coords)))
        sd_fctr = 2.0 ** (1.0 / nl) if refined else 1.0
        out = Descriptors(xyz=np.zeros((len(kp), 3), np.float32),
                          sd=np.asarray(kp.sd, np.float32),
                          data=np.zeros((len(kp), DESC_NUMEL), np.float32))
        dev0 = self.devices[0]
        rows, hists, xyzs = [], [], []
        for o in np.unique(kp.octave):
            o = int(o)
            slabs = self._octaves[o]
            nz = plan.octave_dims[o][2]
            idx = np.nonzero(kp.octave == o)[0]
            z = np.rint(kp.coords[idx, 2])
            starts = np.array([sl.z0 for sl in slabs])
            owner = np.clip(np.searchsorted(starts, z, side="right") - 1,
                            0, len(slabs) - 1)
            g = desc_halo(plan, o, params, refined) if len(slabs) > 1 else 0
            for s, sl in enumerate(slabs):
                mine = idx[owner == s]
                if not len(mine):
                    continue
                dev = sl.device
                levels = (z_extend_one([x.gpyr[1:1 + nl] for x in slabs], s,
                                       g) if g else sl.gpyr[1:1 + nl])

                def put(a, dtype):
                    return torch.as_tensor(a, dtype=dtype, device=dev)
                hist, xyz = octave_histograms(
                    levels, put(kp.level[mine], torch.int64),
                    put(kp.coords[mine], torch.float32),
                    put(kp.R[mine], torch.float32),
                    put(kp.sd[mine], torch.float32), o, plan.level_units(o),
                    params, sd_max=plan.scales[o][nl] * sd_fctr,
                    fractional=refined,
                    z_origin=sl.z0 - g if g else 0, global_nz=nz)
                rows.append(mine)
                hists.append(hist.to(dev0))
                xyzs.append(xyz.to(dev0))
                del levels
        if rows:
            # Every shard's histograms normalized at once, one host copy.
            host = torch.cat([normalize(torch.cat(hists), params),
                              torch.cat(xyzs)], dim=1).cpu().numpy()
            if np.isnan(host).any():
                raise ValueError("a descriptor window leaves its shard's "
                                 "slab, or its sums overflowed")
            mine = np.concatenate(rows)
            out.data[mine] = host[:, :DESC_NUMEL]
            out.xyz[mine] = host[:, DESC_NUMEL:]
        return out

"""End-to-end detector pipeline.

Mirrors the reference's public workflow (sift3d_detect_keypoints,
sift.c:1217-1249; sift3d_extract_descriptors, sift.c:1615-1635): a
detector object holds the configuration and, after detection, the
Gaussian pyramid from which descriptors are extracted.

Per octave: scale to [-1, 1] (once), pyramid + DoG (ops.blur_kernel),
extrema mask (ops.extrema_kernel) compacted in scan order, orientation of
every candidate (ops.ori_kernel); the survivors are kept in candidate
order, octave by octave. Descriptors group the keypoints by octave
(ops.desc_kernel). Everything runs eagerly on the detector's device, with
dynamic shapes; only the assembled keypoints go to the host.

Reference quirk replicated by default: the reference's compaction copies
every keypoint field EXCEPT strength (copy_Keypoint, sift.c:372-384), so
surviving keypoint j inherits the strength of the j-th candidate in scan
order. The CLI's top-100 selection sorts by these stale values. Pass
stale_strength_compat=False for the true strengths.
"""

from __future__ import annotations

import numpy as np
import torch

from .descriptor import extract_descriptors as _extract_octave
from .detect import detect_extrema_octave
from .keypoints import Descriptors, Keypoints
from .orientation import assign_orientations
from .params import DESC_NUMEL, DetectorParams
from .pyramid import PyramidPlan, build_gpyr_and_dog, make_plan, \
    scale_to_unit
from .volume import as_volume


class SIFT3D:
    """SIFT3D detector + descriptor extractor on one torch device.

    Counterpart of the reference's sift3d_detector
    (imtypes_private.h:208-223): holds parameters and, after
    detect_keypoints() or load_pyramid(), the Gaussian pyramid that
    extract_descriptors() reads.
    """

    def __init__(self, params: DetectorParams = DetectorParams(),
                 device: torch.device | str = "cuda",
                 stale_strength_compat: bool = True):
        self.params = params
        self.device = torch.device(device)
        self.stale_strength_compat = stale_strength_compat
        self._plan: PyramidPlan | None = None
        self._gpyr: list[torch.Tensor] | None = None
        self._input_shape: tuple[int, int, int] | None = None

    # -- detection ----------------------------------------------------------

    def detect_keypoints(self, vol) -> Keypoints:
        vol = as_volume(vol, self.device)
        plan = make_plan(vol.shape, vol.units, self.params)
        gpyr, dogs, dogmax = build_gpyr_and_dog(scale_to_unit(vol.data), plan)
        self._plan, self._gpyr, self._input_shape = plan, gpyr, vol.shape
        return self._assemble(plan, gpyr, dogs, dogmax)

    def load_pyramid(self, gpyr_octaves, input_shape, units) -> None:
        """Install a Gaussian pyramid computed elsewhere (one
        [num_gpyr_levels, nx, ny, nz] array per octave) for
        extract_descriptors."""
        plan = make_plan(input_shape, units, self.params)
        gpyr = [torch.as_tensor(np.asarray(g, np.float32),
                                device=self.device).contiguous()
                for g in gpyr_octaves]
        for o, g in enumerate(gpyr):
            want = (plan.num_gpyr_levels,) + plan.octave_dims[o]
            if tuple(g.shape) != want:
                raise ValueError(f"octave {o}: pyramid shape "
                                 f"{tuple(g.shape)} != {want}")
        self._plan, self._gpyr = plan, gpyr
        self._input_shape = tuple(int(d) for d in input_shape)

    def _assemble(self, plan, gpyr, dogs, dogmax) -> Keypoints:
        """Candidates of every octave (octave -> level -> z, y, x), their
        orientations, and the survivors in that order."""
        nl = self.params.num_kp_levels
        cols = {k: [] for k in ("coords", "strength", "accepted", "R",
                                "octave", "level", "sd")}
        for o in range(plan.num_octaves):
            cand = detect_extrema_octave(dogs[o], dogmax[o], self.params)
            if cand.level.numel() == 0:
                continue
            scales = torch.tensor(plan.scales[o][1:1 + nl],
                                  dtype=torch.float32, device=self.device)
            ori = assign_orientations(gpyr[o][1:1 + nl], cand.level,
                                      cand.coords, scales[cand.level],
                                      plan.level_units(o), self.params)
            lvl = cand.level.cpu().numpy().astype(np.int32)
            cols["coords"].append(cand.coords.cpu().numpy())
            cols["strength"].append(cand.strength.cpu().numpy())
            cols["accepted"].append(ori.accepted.cpu().numpy())
            cols["R"].append(ori.R.cpu().numpy())
            cols["octave"].append(np.full(len(lvl), o, np.int32))
            cols["level"].append(lvl)
            cols["sd"].append(np.asarray(plan.scales[o], np.float64)[lvl + 1])
        if not cols["coords"]:
            return Keypoints.empty()
        c = {k: np.concatenate(v) for k, v in cols.items()}
        idx = np.nonzero(c["accepted"])[0]
        strength = c["strength"].astype(np.float64)
        return Keypoints(
            coords=c["coords"][idx].astype(np.float64),
            octave=c["octave"][idx], level=c["level"][idx], sd=c["sd"][idx],
            strength=(strength[:len(idx)] if self.stale_strength_compat
                      else strength[idx]),
            R=c["R"][idx].astype(np.float32))

    # -- descriptors --------------------------------------------------------

    def _verify_keys(self, kp: Keypoints) -> None:
        """verify_keys (sift.c:1171-1212)."""
        if len(kp) < 1:
            raise ValueError("no keypoints")
        if self._input_shape is None:
            raise ValueError(
                "no Gaussian pyramid available; call detect_keypoints first")
        factor = 2.0 ** kp.octave
        dims = np.asarray(self._input_shape, np.float64)
        if (np.any(kp.coords < 0)
                or np.any(kp.coords * factor[:, None] >= dims)):
            raise ValueError("keypoint coordinates exceed image dimensions")
        if np.any(kp.sd <= 0):
            raise ValueError("keypoint has invalid scale")
        if not np.all(kp.coords == np.rint(kp.coords)):
            raise NotImplementedError(
                "fractional keypoint coordinates (subvoxel refinement) are "
                "not ported to sift3d_tpu_torch yet")

    def extract_descriptors(self, kp: Keypoints) -> Descriptors:
        self._verify_keys(kp)
        plan = self._plan
        nl = self.params.num_kp_levels
        n = len(kp)
        xyz = np.zeros((n, 3), np.float32)
        sd_out = np.zeros((n,), np.float32)
        data = np.zeros((n, DESC_NUMEL), np.float32)
        dev = self.device
        for o in np.unique(kp.octave):
            idx = np.nonzero(kp.octave == o)[0]
            o = int(o)

            def put(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a[idx]),
                                       dtype=dtype, device=dev)
            sd = put(kp.sd, torch.float32)
            desc, xyz_o = _extract_octave(
                self._gpyr[o][1:1 + nl], put(kp.level, torch.int64),
                put(kp.coords, torch.float32), put(kp.R, torch.float32), sd,
                o, plan.level_units(o), self.params,
                sd_max=plan.scales[o][nl])
            data[idx] = desc.cpu().numpy()
            xyz[idx] = xyz_o.cpu().numpy()
            sd_out[idx] = sd.cpu().numpy()
        return Descriptors(xyz=xyz, sd=sd_out, data=data)

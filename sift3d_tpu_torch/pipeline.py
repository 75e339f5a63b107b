"""End-to-end detector pipeline.

Mirrors the reference's public workflow (sift3d_detect_keypoints,
sift.c:1217-1249; sift3d_extract_descriptors, sift.c:1615-1635): a
detector object holds the configuration and, after detection, the
Gaussian pyramid from which descriptors are extracted.

Per octave: scale to [-1, 1] (once), pyramid + DoG (ops.blur_kernel),
extrema mask (ops.extrema_kernel) compacted in scan order, with either
extension on the refinement of every candidate (refinement.py: subvoxel
offsets, scale offsets, Hessian edge test), orientation of every candidate
(ops.ori_kernel); the survivors are kept in candidate order, octave by
octave. Descriptors group the keypoints by octave (ops.desc_kernel).
Everything runs eagerly on the detector's device, with
dynamic shapes; only the assembled keypoints go to the host.

A batch of same-shape volumes (detect_keypoints_batch,
extract_descriptors_batch) runs every stage for all volumes at once: each
kernel launches as often for the batch as for one volume, and the rows of
all octaves of a sub-batch go to the host in one copy. A single volume is
a batch of one whose octaves take the single-volume stacks (no volume
index to decode). The batch is split into sub-batches whose transient
buffers fit MEM_SHARE of the card's free memory beside the batch's
pyramid, which is kept for the descriptors (SUB_BATCH forces a size).

Each public call is a root span of the recorder (profiling.py:
sift3d.detect[_batch], sift3d.describe[_batch]) holding the stage spans
sift3d.detect.* and sift3d.describe.*, and every host-device crossing
goes through profiling.to_device, to_host or read_int, which count them.
Only the host's reads wait for the card: an octave's candidate count
(it sizes the octave's buffers), a sub-batch's rows and the
descriptors; the uploads are queued in stream order.

Detection also leaves a funnel in SIFT3D._funnel, as the JAX package's
SIFT3D does (sift3d_tpu/pipeline.py:1587-1600; profiling.detect_stats
reads it): per (octave, keypoint level), the candidates, the rejections
of the orientation stage in the reference's short-circuit order (weak
gradient, eigenvalue ratio, corner; sift.c:996-1102) and the survivors.
Candidates that the edge test drops count as candidates and survivors
of no stage. The predicates come home with the sub-batch's rows; the
counts are taken from those rows when _funnel is first read, not on the
detection's path. After a batch the funnel is the last volume's.

Reference quirk replicated by default: the reference's compaction copies
every keypoint field EXCEPT strength (copy_Keypoint, sift.c:372-384), so
surviving keypoint j inherits the strength of the j-th candidate in scan
order. The CLI's top-100 selection sorts by these stale values. Pass
stale_strength_compat=False for the true strengths; with either extension
on, the strengths are the true ones (sift3d_tpu/pipeline.py:1649-1652).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .descriptor import normalize, octave_histograms
from .detect import detect_extrema_octave
from .keypoints import Descriptors, Keypoints
from .orientation import assign_orientations
from .params import DESC_NUMEL, DetectorParams
from .profiling import span, to_device, to_host
from .pyramid import PyramidPlan, build_gpyr_and_dog, make_plan, \
    scale_to_unit
from .refinement import refine_candidates_octave
from .volume import as_volume

# Share of the card's free memory (torch.cuda.mem_get_info) that a batch's
# pyramids and one sub-batch's transient buffers may take.
MEM_SHARE = 0.5
# Volumes per sub-batch when set; None derives it from MEM_SHARE (on the
# CPU: the whole batch).
SUB_BATCH: int | None = None

# Columns of _octave's host rows: coordinates or refined centers (0-2),
# strength (3), accepted (4), the three reject predicates (5-7), R (8-16),
# the refined scale (17, with an extension on) and the level (last).
COL_ACCEPTED = 4
COLS_REJECT = slice(5, 8)
COLS_R = slice(8, 17)
COL_SD = 17
COL_LEVEL = -1
# The funnel's counts per (octave, level), in JAX's order.
FUNNEL_COUNTS = ("candidates", "reject_grad", "reject_ratio",
                 "reject_corner", "survivors")


def _as_batch(vols) -> torch.Tensor:
    """f32[B, nx, ny, nz] (where it lies) from an array, a tensor, or a
    sequence of same-shape arrays or tensors."""
    if isinstance(vols, (list, tuple)):
        vols = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                            for v in vols])
    vols = torch.as_tensor(vols, dtype=torch.float32)
    if vols.ndim != 4 or vols.shape[0] < 1:
        raise ValueError(f"expected a batch of 3-D volumes [B, nx, ny, nz], "
                         f"got shape {tuple(vols.shape)}")
    return vols


class SlabView(NamedTuple):
    """One shard's z-slab of an octave (parallel/spatial.py): the DoG
    stack handed to _octave holds the shard's own rows `rows` with a
    one-voxel halo, its row 0 at global z `dog_origin`; `levels` are the
    keypoint levels with the orientation windows' halo, row 0 at global z
    `levels_origin`; `nz` the octave's depth."""
    dog_origin: int
    rows: tuple[int, int]
    levels: torch.Tensor
    levels_origin: int
    nz: int


def _count_funnel(rows, octave, level) -> dict:
    """{(octave, level): counts} of one volume's candidate rows (_octave),
    counted as sift3d_tpu/pipeline.py:1589-1600 counts them: a ratio
    rejection is one the gradient test let through, a corner rejection
    one both let through. One bincount a count, whatever the levels."""
    g, r, c = (rows[:, COLS_REJECT] != 0).T
    span = int(level.max(initial=0)) + 1
    keys, inv = np.unique(octave.astype(np.int64) * span + level,
                          return_inverse=True)
    counts = np.stack([np.bincount(inv[m], minlength=len(keys)) for m in (
        slice(None), g, ~g & r, ~g & ~r & c, rows[:, COL_ACCEPTED] != 0)],
        axis=1).tolist()
    return {(k // span, k % span): dict(zip(FUNNEL_COUNTS, n))
            for k, n in zip(keys.tolist(), counts)}


class SIFT3D:
    """SIFT3D detector + descriptor extractor on one torch device.

    Counterpart of the reference's sift3d_detector
    (imtypes_private.h:208-223): holds parameters and, after
    detect_keypoints(), detect_keypoints_batch() or load_pyramid(), the
    Gaussian pyramid (one f32[B, L, nx, ny, nz] per octave, B = 1 for one
    volume) that extract_descriptors() and extract_descriptors_batch()
    read.
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
        # The last detection's funnel (the _funnel property), and the host
        # rows it is counted from until it is first read.
        self._funnel_counts: dict | None = None
        self._funnel_rows = None
        self.sub_batch = 0   # volumes per sub-batch of the last detection

    # -- detection ----------------------------------------------------------

    def detect_keypoints(self, vol) -> Keypoints:
        with span("sift3d.detect", root=True):
            vol = as_volume(vol, self.device)
            return self._detect(vol.data[None], vol.units)[0]

    def detect_keypoints_batch(self, vols, units=(1.0, 1.0, 1.0)
                               ) -> list[Keypoints]:
        """Keypoints of each of B same-shape volumes (f32[B, nx, ny, nz],
        or a sequence of volumes) at voxel `units`, each equal to what
        detect_keypoints gives for that volume alone. The detector then
        holds the batch's pyramid, for extract_descriptors_batch."""
        with span("sift3d.detect_batch", root=True):
            return self._detect(_as_batch(vols), units)

    def _sub_batch(self, plan: PyramidPlan, B: int) -> int:
        """Volumes per sub-batch: SUB_BATCH, or as many as fit MEM_SHARE of
        the card's free memory beside the whole batch's pyramids (kept for
        the descriptors), each taking its DoG, the x pass's output and its
        scaled input while its pyramid is built."""
        if SUB_BATCH is not None:
            return max(1, min(B, int(SUB_BATCH)))
        if self.device.type != "cuda" or B == 1:
            return B
        free, _ = torch.cuda.mem_get_info(self.device)
        L = plan.num_gpyr_levels
        vox = sum(int(np.prod(d)) for d in plan.octave_dims)
        kept = 4 * L * vox
        work = 4 * (L + 1) * vox + 4 * int(np.prod(plan.input_dims))
        return max(1, min(B, int((MEM_SHARE * free - B * kept) // work)))

    def _detect(self, data: torch.Tensor, units) -> list[Keypoints]:
        """Keypoints of each volume of data f32[B, nx, ny, nz] (on any
        device; moved to the detector's a sub-batch at a time)."""
        B = data.shape[0]
        with span("sift3d.detect.plan"):
            plan = make_plan(data.shape[1:], units, self.params)
            L = plan.num_gpyr_levels
            self._plan, self._gpyr = None, None  # the last batch's pyramid
            sub = self.sub_batch = self._sub_batch(plan, B)
            gpyr = [torch.empty((B, L) + tuple(d), dtype=torch.float32,
                                device=self.device)
                    for d in plan.octave_dims]
        parts = []   # (octave, first volume, sub-batch size, host rows)
        for s in range(0, B, sub):
            with span("sift3d.detect.upload_scale"):
                x = scale_to_unit(to_device(data[s:s + sub], torch.float32,
                                            self.device).contiguous())
            with span("sift3d.detect.pyramid"):
                _, dogs, dogmax = build_gpyr_and_dog(
                    x, plan, [g[s:s + sub] for g in gpyr])
            del x
            blocks = []   # (octave, its rows on the device)
            for o in range(plan.num_octaves):
                rows = self._octave(plan, o, gpyr[o][s:s + sub], dogs[o],
                                    dogmax[o])
                if rows is not None:
                    blocks.append((o, rows))
            del dogs, dogmax
            if blocks:
                # Every octave's rows in one copy, split by the candidate
                # counts the host already knows.
                with span("sift3d.detect.rows_home"):
                    host = to_host(torch.cat([b for _, b in blocks])).numpy()
                ends = np.cumsum([len(b) for _, b in blocks])[:-1]
                parts += [(o, s, min(sub, B - s), rows) for (o, _), rows
                          in zip(blocks, np.split(host, ends))]
        self._plan, self._gpyr = plan, gpyr
        self._input_shape = tuple(int(d) for d in data.shape[1:])
        with span("sift3d.detect.assembly"):
            kps, self._funnel_rows = self._keypoints(plan, parts, B)
        self._funnel_counts = {}
        return kps

    @property
    def _funnel(self) -> dict | None:
        """Per-(octave, level) rejection funnel of the last detection
        (profiling.detect_stats renders it): {(octave, level):
        {name: count for name in FUNNEL_COUNTS}}, None before one."""
        if self._funnel_rows is not None:
            rows, octave, level = self._funnel_rows
            self._funnel_counts = _count_funnel(rows, octave, level)
            self._funnel_rows = None
        return self._funnel_counts

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
        self._plan, self._gpyr = plan, [g[None] for g in gpyr]
        self._input_shape = tuple(int(d) for d in input_shape)

    def _octave(self, plan, o, gpyr_o, dog, dogmax,
                slab: SlabView | None = None) -> torch.Tensor | None:
        """Candidates of octave o of a (sub-)batch, volume-major and in
        each volume level -> z, y, x order, their refinement when an
        extension is on, their orientations: their rows, f32 on the
        detector's device (None without candidates). Columns (COL_*):
        coordinates or refined centers (3), strength, accepted, the
        orientation's weak-gradient, ratio and corner predicates (none
        set where the edge test rejects, as JAX masks them), R (9), the
        refined scale (with an extension on), and last the level: of one
        volume, its keypoint level; of a batch, the level in the
        sub-batch's stack.

        Refined (sift3d_tpu/pipeline.py:1549-1562): center = coords +
        offset, sd = scale[level + 1] * 2^(ds / nl), and the edge test's
        rejections drop out. With either extension on, orientation windows
        take the fractional-center margin and a largest scale 2^(1/nl)
        above the octave's top level (|ds| <= 1 level).

        slab: one shard's rows of one volume (dog its haloed DoG slab), in
        global coordinates."""
        params = self.params
        if gpyr_o.shape[0] == 1:   # one volume: no volume to decode
            dog, dogmax = dog[0], dogmax[0]
        zkw = {}
        with span("sift3d.detect.extrema"):
            if slab is not None:
                cand = detect_extrema_octave(dog, dogmax, params,
                                             slab.dog_origin, slab.nz,
                                             slab.rows)
                zkw = dict(z_origin=slab.levels_origin, global_nz=slab.nz)
            else:
                cand = detect_extrema_octave(dog, dogmax, params)
        if cand.level.numel() == 0:
            return None
        with span("sift3d.detect.orientation"):
            return torch.cat(self._orient(plan, o, gpyr_o, dog, cand, slab,
                                          zkw), dim=1)

    def _orient(self, plan, o, gpyr_o, dog, cand, slab, zkw) -> list:
        """_octave's refinement (with an extension on) and orientation of
        the octave's candidates: the columns of its host rows."""
        params = self.params
        nl = params.num_kp_levels
        ext = params.extensions
        S, L = gpyr_o.shape[:2]
        scales = to_device(plan.scales[o][1:1 + nl], torch.float32,
                           self.device)
        sd = scales[cand.level]
        sd_max = plan.scales[o][nl]
        centers = None
        if ext:
            local = cand.coords
            if slab is not None:    # the candidates' rows in the DoG slab
                local = local - to_device([0, 0, slab.dog_origin], None,
                                          local.device)
            ref = refine_candidates_octave(dog, local, cand.level,
                                           params, batch=cand.batch)
            centers = cand.coords.to(torch.float32) + ref.offset
            sd = sd * torch.exp2(ref.ds / nl)
            sd_max *= 2.0 ** (1.0 / nl)
        if slab is not None:
            levels, lvl = slab.levels, cand.level
        elif cand.batch is None:
            levels, lvl = gpyr_o[0, 1:1 + nl], cand.level
        else:
            # The sub-batch's levels as one stack [S * L, nx, ny, nz]:
            # keypoint level l of volume b is stack level b * L + 1 + l.
            levels = gpyr_o.reshape((S * L,) + tuple(gpyr_o.shape[2:]))
            lvl = cand.batch * L + 1 + cand.level
        ori = assign_orientations(levels, lvl, cand.coords, sd,
                                  plan.level_units(o), params,
                                  centers=centers, sd_max=sd_max,
                                  fractional=ext, **zkw)
        # accepted and the three predicates, masked by the edge test's
        # verdict as sift3d_tpu/orientation.py:286-289 masks them.
        flags = ori.flags & ref.edge_ok[:, None] if ext else ori.flags
        K = cand.level.numel()
        # Every column in f32 (exact for these values: coordinates and
        # stack levels are below 2^24), for one block.
        return ([centers if ext else cand.coords.to(torch.float32),
                 cand.strength[:, None], flags.to(torch.float32),
                 ori.R.reshape(K, 9)] + ([sd[:, None]] if ext else [])
                + [lvl.to(torch.float32)[:, None]])

    def _keypoints(self, plan, parts, B) -> tuple[list[Keypoints], tuple]:
        """Each volume's survivors, in candidate order, from the octaves'
        host rows (_octave), decoded at once, and the last volume's rows,
        octaves and levels for its funnel (None without candidates). The
        stale-strength column is the volume's own: survivor j takes the
        strength of the volume's j-th candidate."""
        if not parts:
            return [Keypoints.empty() for _ in range(B)], None
        L = plan.num_gpyr_levels
        ext = self.params.extensions
        rows = np.concatenate([p for *_, p in parts])
        n = [len(p) for *_, p in parts]
        octave = np.repeat(np.array([o for o, *_ in parts], np.int32), n)
        v = rows[:, COL_LEVEL].astype(np.int32)
        batched = np.repeat([S > 1 for _, _, S, _ in parts], n)
        vol = np.repeat([s for _, s, _, _ in parts], n) \
            + np.where(batched, v // L, 0)
        level = np.where(batched, v % L - 1, v)
        sd = (rows[:, COL_SD].astype(np.float64) if ext else
              np.asarray(plan.scales, np.float64)[octave, level + 1])
        stale = self.stale_strength_compat and not ext
        out = []
        for b in range(B):
            mine = np.nonzero(vol == b)[0]
            if not len(mine):
                out.append(Keypoints.empty())
                continue
            idx = mine[rows[mine, COL_ACCEPTED] != 0]
            strength = rows[mine if stale else idx, 3].astype(np.float64)
            out.append(Keypoints(
                coords=rows[idx, :3].astype(np.float64), octave=octave[idx],
                level=level[idx], sd=sd[idx],
                strength=strength[:len(idx)] if stale else strength,
                R=rows[idx, COLS_R].reshape(-1, 3, 3)))
        if B > 1:
            last = vol == B - 1
            rows, octave, level = rows[last], octave[last], level[last]
        return out, (rows, octave, level) if len(rows) else None

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

    def extract_descriptors(self, kp: Keypoints) -> Descriptors:
        with span("sift3d.describe", root=True):
            with span("sift3d.describe.check"):
                self._verify_keys(kp)
            if self._gpyr[0].shape[0] != 1:
                raise ValueError("the detector holds a batch's pyramid; use "
                                 "extract_descriptors_batch")
            return self._describe([kp])[0]

    def extract_descriptors_batch(self, kps) -> list[Descriptors]:
        """Descriptors of the keypoint lists of the last
        detect_keypoints_batch (one per volume, in order); an empty list
        gives empty descriptors."""
        with span("sift3d.describe_batch", root=True):
            if self._gpyr is None:
                raise ValueError(
                    "no Gaussian pyramid available; call "
                    "detect_keypoints_batch first")
            if len(kps) != self._gpyr[0].shape[0]:
                raise ValueError(f"{len(kps)} keypoint lists for a batch of "
                                 f"{self._gpyr[0].shape[0]} volumes")
            with span("sift3d.describe.check"):
                for kp in kps:
                    if len(kp):
                        self._verify_keys(kp)
            return self._describe(kps)

    def _describe(self, kps) -> list[Descriptors]:
        """Descriptors of volume b's keypoints kps[b], one kernel launch
        per octave for the whole batch and one host copy."""
        plan = self._plan
        nl = self.params.num_kp_levels
        B, L = self._gpyr[0].shape[:2]
        # Refined keypoints carry fractional coordinates and scales up to
        # 2^(1/nl) above the octave's top level: their windows take the
        # fractional-center margin (sift3d_tpu/pipeline.py:1700-1703,
        # 227-229).
        refined = (self.params.refine_subvoxel
                   or any(not np.all(kp.coords == np.rint(kp.coords))
                          for kp in kps))
        sd_fctr = 2.0 ** (1.0 / nl) if refined else 1.0
        dev = self.device
        octaves = np.unique(np.concatenate([kp.octave for kp in kps]))
        sels, hists, xyzs = [], [], []
        for o in octaves:
            o = int(o)
            with span("sift3d.describe.gather"):
                sel = [np.nonzero(kp.octave == o)[0] for kp in kps]

                def put(field, dtype):
                    a = np.concatenate([getattr(kp, field)[i]
                                        for kp, i in zip(kps, sel)])
                    return to_device(a, dtype, dev)
                # The level in the batch's stack: volume b's level l is
                # b * L + 1 + l.
                stack = np.repeat(np.arange(B) * L + 1,
                                  [len(i) for i in sel])
                lvl = to_device(stack + np.concatenate(
                    [kp.level[i] for kp, i in zip(kps, sel)]), torch.int64,
                    dev)
                args = (lvl, put("coords", torch.float32),
                        put("R", torch.float32), put("sd", torch.float32))
            with span("sift3d.describe.histograms"):
                g = self._gpyr[o]
                hist, xyz_o = octave_histograms(
                    g.reshape((B * L,) + tuple(g.shape[2:])), *args, o,
                    plan.level_units(o), self.params,
                    sd_max=plan.scales[o][nl] * sd_fctr, fractional=refined)
            sels.append(sel)
            hists.append(hist)
            xyzs.append(xyz_o)
        host = None
        if sels:
            with span("sift3d.describe.normalize"):
                # Every octave's histograms normalized at once, one host
                # copy.
                host = to_host(torch.cat(
                    [normalize(torch.cat(hists), self.params),
                     torch.cat(xyzs)], dim=1)).numpy()
        with span("sift3d.describe.scatter"):
            out = [Descriptors(xyz=np.zeros((len(kp), 3), np.float32),
                               sd=np.asarray(kp.sd, np.float32),
                               data=np.zeros((len(kp), DESC_NUMEL),
                                             np.float32))
                   for kp in kps]
            start = 0
            for sel in sels:
                for d, i in zip(out, sel):
                    rows = host[start:start + len(i)]
                    start += len(i)
                    d.data[i] = rows[:, :DESC_NUMEL]
                    d.xyz[i] = rows[:, DESC_NUMEL:]
        return out

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (sift3d_tpu_torch) on one GPU.

Builds the port's CUDA kernels from the checkout (nvcc, sm_90a), holds each
kernel against its plain PyTorch version at the 256^3 octave-0 shapes of
the main path (the blur bit for bit on all six levels of octave 0, the
extrema candidates identical, the orientation and descriptor kernels at the
candidates' integer centers and again at seeded fractional centers, as
subvoxel refinement makes them, the eigensolver bit for bit, alone, on
moments and on the candidates' DoG Hessians), then runs the main path —
SIFT3D(device="cuda"), detect_keypoints + extract_descriptors — on four
bench phantoms: 256^3 sparse and dense, 192^3 sparse, 128^3 sparse at 1 x
1 x 2.5 mm voxels, and with refinement and edge rejection on 128^3 sparse
(BASELINE config 2). It checks that every kernel of the path launched in
each run, and holds each result against its JAX golden file
(tests/data/torch_golden_*.npz) to the reference bars (identical keypoint
rows, stale strength within 1.2e-7 relative, R within 1e-5, every
descriptor within 1% relative L2; refined, coordinates within 1e-5, scales
1e-6 relative, strengths exact). Last it registers the rotated and
translated 192^3 pair of tools/bench_registration.py (BASELINE config 4),
built on the card, with default and with refined parameters, against the
JAX golden: the warped volume, the matches and inliers, and the affine's
corner error against the truth and against JAX's, by register (timed) and
by register_batch of one pair.

The batch path: the blur, extrema, orientation and descriptor kernels over
a batch of eight distinct 256^3 bench phantoms (four sparse, four dense;
eight volumes, as batch256x4 gives them) at octave-0 shapes against their
per-volume plain versions (the blur bit for bit with each volume's max
|DoG|, the extrema keys each volume's offset by its index, the
orientation and descriptor kernels on the batch's flattened level stack,
past 2^31 bytes, to the single-volume bars); then **batch256x4**
(BASELINE config 5): the four 256^3 pairs of tools/bench_registration.py,
built on the card, registered by register_batch, each volume's rows and
descriptors against its own detect_keypoints + extract_descriptors, each
pair against the JAX golden (tests/data/torch_golden_batch256x4.npz: the
matches, the inliers with RANSAC fed JAX's own hypothesis indices, the
corner error with the port's), with the launches per batch against one
volume's, pairs/s, ms per volume and peak memory;
the same batch with its eight volumes over a 'b' mesh axis of four
entries of the card (register_batch(mesh=...), MeshBatchSIFT3D), equal to the unsharded
run; last the batch loader: the eight volumes written as NIfTI (one
.nii.gz) and read back by BatchVolumeLoader(device="cuda") into
detect_keypoints_batch, identical to the in-memory batch.

The descriptor kernel sums in exact integers: its three runs, the batch
against each volume's own launch (the dense256 octave 0 among them) and
the batch256x4 descriptors against each volume's own run are held bit for
bit. The parallel path (sift3d_tpu_torch.parallel): each of the four
kernels on the four haloed z-slabs of sparse256 octave 0 that
ShardedSIFT3D gives it, against one whole-volume launch, bit for bit
(rows *_shard, timed as the four slab launches back to back); then
ShardedSIFT3D on four shards of the card ("cuda:0" four times) on
sparse256 and refine128, against their goldens and bit for bit against the
single-device port, every shard launching the blur kernels once per level
and the extrema kernel at least once, and on the sparse bench phantom at
512^3 bit for bit against the single-device port, with walls, peak memory
and the pyramid each shard holds.

Profiling and the funnel (sift3d_tpu_torch.profiling): sparse256 and
dense256 run detect_keypoints + extract_descriptors again inside
StageTimes stages ("detect", "describe") and a profiling.trace; the trace
must hold both spans and every launch of the five CUDA kernels inside
them, the rows and descriptors must equal the same detector's run outside
the spans bit for bit, with the same launches. Each main-path cell's
detection funnel (SIFT3D._funnel) must equal JAX's count for count
(tests/data/torch_golden_funnel.json), its survivors summing to the
keypoint count; and sparse256 with every execution knob of DetectorParams
at a value other than its default must give the default run's bits and
launches.

Prints the card (nvidia-smi name, power limit), versions and build time,
one line per phase, a JSON line of per-kernel results (time, plain time,
the bound from the H100's peak rates, and a PyTorch library call's time
where one computes the same function), and as the last line
{"ok": true, "device": {...}}. Exits non-zero, without that line,
when there is no CUDA device or any phase fails. Imports no JAX.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# BASELINE config 2: subvoxel refinement and Hessian edge rejection.
REFINED = {"refine_subvoxel": True, "edge_thresh": 10.0}
# Main-path cells: (phantom, size, voxel units, runs timed, extensions).
CELLS = {"sparse256": ("sparse", 256, (1.0, 1.0, 1.0), 7, {}),
         "dense256": ("dense", 256, (1.0, 1.0, 1.0), 3, {}),
         "sparse192": ("sparse", 192, (1.0, 1.0, 1.0), 3, {}),
         "aniso128": ("sparse", 128, (1.0, 1.0, 2.5), 3, {}),
         "refine128": ("sparse", 128, (1.0, 1.0, 1.0), 3, REFINED)}
GOLDENS = {cell: ROOT / "tests" / "data" / f"torch_golden_{cell}.npz"
           for cell in CELLS}
# JAX's detection funnel of each main-path cell.
FUNNEL_GOLDEN = ROOT / "tests" / "data" / "torch_golden_funnel.json"
# The cells run inside StageTimes spans and a trace.
TRACED_CELLS = ("sparse256", "dense256")
# The five CUDA kernels of the main path: entry point -> device function.
PATH_KERNELS = {"s3d_blur_x": "blur_x_kernel",
                "s3d_blur_yz_dog": "blur_yz_dog_kernel",
                "s3d_extrema_candidates": "extrema_kernel",
                "s3d_orient": "ori_kernel",
                "s3d_desc_fused": "desc_kernel"}
# Every execution knob of DetectorParams at a valid value other than its
# default: the port computes one exact f32 path at every value.
ALL_KNOBS = dict(kp_per_level=1, conv_precision="default",
                 desc_precision="highest", conv_tail_precision="default",
                 conv_exact_from_octave=9, gpyr_impl="composed",
                 dense_octave_acc=1, dense_octave_cand=1,
                 sparse_desc_groups=False, split_desc_chunks=0,
                 min_chunk_cost=0, hint_history=1, desc_vbins="packed",
                 extrema_impl="xla")
# BASELINE config 4: registration of the 192^3 pair, two configurations.
REG_GOLDEN = ROOT / "tests" / "data" / "torch_golden_register192.npz"
REG_CONFIGS = {"default": {}, "refined": {"refine_subvoxel": True}}
# BASELINE config 5: the batch of four 256^3 pairs.
BATCH_GOLDEN = ROOT / "tests" / "data" / "torch_golden_batch256x4.npz"
# The batched kernels' volumes: (phantom, seed; None = bench.py's own);
# eight, the volumes of batch256x4's one batch.
BATCH_PHANTOMS = (("sparse", None), ("dense", None), ("sparse", 3),
                  ("dense", 5), ("sparse", 11), ("dense", 13),
                  ("sparse", 17), ("dense", 19))
REPS = 7
KERNEL_INNER = 20
# Shards of ShardedSIFT3D and entries of the batch's mesh axis, all on the
# one card; the cells run sharded too.
SHARDS = 4
SHARDED_CELLS = ("sparse256", "refine128")
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations a voxel of the descriptor's sphere-and-cube takes: the
# gradient, weight, two 3x3 rotations, the 20-face test (~15 operations a
# face) and 24 weighted adds.
DESC_OPS_PER_VOXEL = 400
# f32 operations of one 3x3 eigendecomposition: 18 Jacobi rotations of
# ~68 operations (angle ~14, row, column and vector updates 54), the sort.
EIGH_OPS = 1230


def corner_error(A_est, A_true, n: int) -> float:
    """Mean displacement in voxels between two affines over the corners of
    an n^3 volume (tools/bench_registration.py affine_corner_error)."""
    import numpy as np
    if A_est is None:
        return float("inf")
    corners = np.array([[x, y, z, 1.0] for x in (0, n - 1)
                        for y in (0, n - 1) for z in (0, n - 1)])
    d = corners @ (np.asarray(A_est, np.float64)
                   - np.asarray(A_true, np.float64)).T
    return float(np.linalg.norm(d, axis=1).mean())


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms the card could take, and what sets it."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def cuda_ms(torch, fn, reps: int = REPS, inner: int = 1) -> float:
    """Median device time of fn in ms (CUDA events), after a warm-up. With
    inner > 1 the events enclose that many calls back to back and the time
    is their mean, so the host's launch cost of one call overlaps the
    device work of the one before (a kernel's time: KERNEL_INNER)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


class Smoke:
    def __init__(self):
        self.failures: list[str] = []
        self.kernels: dict[str, dict] = {}

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            print(f"[ok]   {name} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:   # report every phase, then fail the run
            self.failures.append(name)
            print(f"[FAIL] {name}\n{traceback.format_exc()}", flush=True)

    def record(self, name, source, replaces, err, ms, plain_ms, counter,
               bound_ms_by, library_ms=None):
        """Keep a kernel's phase result; `counter` is its launch counter
        so far (the main path resets it before its own run)."""
        bound_ms, bound_by = bound_ms_by
        self.kernels[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=float(err), ms=float(ms),
            plain_ms=float(plain_ms), bound_ms=float(bound_ms),
            bound_by=bound_by,
            library_ms=None if library_ms is None else float(library_ms))
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"       {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), library {lib}, "
              f"max |kernel - plain| {float(err):.3g}, "
              f"launch counter {counter}", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        die("PyTorch is not installed")
    if not torch.cuda.is_available():
        die("no CUDA device: this smoke test runs the port on a GPU")
    needed = [ROOT / "sift3d_tpu_torch", ROOT / "bench.py",
              *GOLDENS.values(), FUNNEL_GOLDEN, REG_GOLDEN, BATCH_GOLDEN]
    missing = [str(p.relative_to(ROOT)) for p in needed if not p.exists()]
    if missing:
        die(f"run from a checkout of the repository (missing {missing})")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    import sift3d_tpu_torch as st
    import torch.nn.functional as F

    import bench
    from sift3d_tpu_torch import native, profiling, registration
    from sift3d_tpu_torch.detect import detect_extrema_octave
    from sift3d_tpu_torch.io import BatchVolumeLoader, write_volume
    from sift3d_tpu_torch.io.loader import _read_batch
    from sift3d_tpu_torch.ops import _build
    from sift3d_tpu_torch.ops import blur_kernel as bk
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    from sift3d_tpu_torch.ops import ori_kernel as ok
    from sift3d_tpu_torch.parallel import MeshBatchSIFT3D, ShardedSIFT3D, \
        make_mesh, z_extend
    from sift3d_tpu_torch.parallel.halo import diag_halo
    from sift3d_tpu_torch.parallel.spatial import (build_gpyr_sharded,
                                                   desc_halo, ori_halo)
    from sift3d_tpu_torch.phantoms import bench_volume
    from sift3d_tpu_torch.pyramid import (build_gpyr_and_dog, make_plan,
                                          scale_to_unit)
    from sift3d_tpu_torch.refinement import (derivatives,
                                             gather_neighbourhoods)
    assert "jax" not in sys.modules
    torch.backends.cudnn.allow_tf32 = False   # the conv3d yardstick

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.lib()
    def n_launches(kernel):
        """Launches of s3d_<kernel> so far (the recorder's counter)."""
        return profiling.counter("launch.s3d_" + kernel)

    nvcc_ns = profiling.read()["spans"].get("sift3d.kernels.build", [0, 0])[1]
    print(f"kernel build {time.perf_counter() - t0:.1f} s "
          f"(nvcc {nvcc_ns * 1e-9:.1f} s, "
          f"{profiling.counter('kernels.builds')} build(s)) -> "
          f"{_build.BUILD_DIR}", flush=True)
    t0 = time.perf_counter()
    native.lib()
    print(f"native IO runtime {time.perf_counter() - t0:.1f} s -> "
          f"{native.BUILD_DIR / native.LIB_NAME}", flush=True)

    dev = torch.device("cuda")
    params = st.DetectorParams()
    # The bench phantoms, made on the card; bit-identical to bench.py's
    # (checked here at a small size).
    for cell, make in (("sparse", bench.make_bench_volume),
                       ("dense", bench.make_dense_volume)):
        small = bench_volume(cell, 40, dev).cpu().numpy()
        if not np.array_equal(small, make(40)):
            die(f"bench_volume({cell!r}) differs from bench.py")
    vols = {cell: bench_volume(kind, size, dev).cpu().numpy()
            for cell, (kind, size, *_) in CELLS.items()}
    vol_np = vols["sparse256"]
    plan = make_plan(vol_np.shape, (1.0, 1.0, 1.0), params)
    x = scale_to_unit(torch.from_numpy(vol_np).to(dev))
    s = Smoke()
    nl = params.num_kp_levels
    st_ = {}   # octave-0 state shared by the kernel phases

    def blur_phase():
        gpyr, dogs, dmax = build_gpyr_and_dog(x, plan)
        st_.update(gpyr=gpyr[0], dog=dogs[0], dogmax=dmax[0],
                   pyr=(gpyr, dogs, dmax))
        N = x.numel()
        tmp, cur, dog = (torch.empty_like(x) for _ in range(3))
        dm = torch.zeros(1, device=dev)
        # Per kernel, means over the levels: bytes, ops, ms, plain ms.
        sums = {k: [0.0] * 4 for k in ("blur_x", "blur_yz_dog")}
        lib_ms, lib_err, err = 0.0, 0.0, 0.0
        for i in range(plan.num_gpyr_levels):
            src = x if i == 0 else gpyr[0][i - 1]
            diags = bk._diags(plan, 0, i, dev)
            (wx, lox), (wy, loy), (wz, loz) = diags
            bx, by, bz = (wd.shape[1] for wd, _ in diags)
            # The first level of octave 0 has no DoG.
            prev, dg, m = (None, None, None) if i == 0 else (src, dog, dm)
            bk.blur_x(src, wx, lox, tmp)
            xr = bk.blur_x_plain(src, wx, lox)
            assert torch.equal(tmp, xr), f"level {i}: x pass not bit-exact"
            dm.zero_()
            bk.blur_yz_dog(tmp, wy, loy, wz, loz, cur, prev, dg, m)
            cr, dr, mr = bk.blur_yz_dog_plain(xr, wy, loy, wz, loz, prev)
            assert torch.equal(cur, cr), f"level {i}: y/z pass not bit-exact"
            assert torch.equal(cur, gpyr[0][i]), f"level {i} of the chain"
            if i:
                assert torch.equal(dog, dr) and torch.equal(dm[0], mr), i
                assert torch.equal(dog, dogs[0][i - 1]), i
            err = max(err, float((tmp - xr).abs().max()),
                      float((cur - cr).abs().max()))
            # The x pass's library yardstick: F.conv3d with the band as a
            # (B,1,1) filter. It computes the same function on the rows
            # whose band is the interior one (conv_diagonals changes the
            # weights near the clipped edges); padding is symmetric, so
            # the row past the end is dropped.
            n = x.shape[0]
            w = wx[n // 2].reshape(1, 1, bx, 1, 1).contiguous()

            def library():
                return F.conv3d(src[None, None], w,
                                padding=(-lox, 0, 0))[0, 0].narrow(0, 0, n)
            rows = torch.nonzero((wx == wx[n // 2]).all(dim=1))[:, 0]
            lib_err = max(lib_err, float((library() - xr).abs()
                                         .index_select(0, rows).max()))
            xms = cuda_ms(torch, lambda: bk.blur_x(src, wx, lox, tmp),
                          inner=KERNEL_INNER)
            yzms = cuda_ms(torch, lambda: bk.blur_yz_dog(
                tmp, wy, loy, wz, loz, cur, prev, dg, m), inner=KERNEL_INNER)
            lvms = cuda_ms(torch, lambda: bk.blur_level(src, diags, tmp, cur,
                                                        dg, m),
                           inner=KERNEL_INNER)
            pxms = cuda_ms(torch, lambda: bk.blur_x_plain(src, wx, lox))
            pyzms = cuda_ms(torch, lambda: bk.blur_yz_dog_plain(
                xr, wy, loy, wz, loz, prev))
            lms = cuda_ms(torch, library, inner=KERNEL_INNER)
            lib_ms += lms / plan.num_gpyr_levels
            # Bytes: each input read once, each output written once; the
            # level as one function reads src and writes the level and
            # the DoG. Ops: a multiply and an add per tap, the DoG's
            # subtract, absolute value and max.
            dogv = 1 if i else 0
            bxb = (8 * N, 2 * bx * N)
            yzb = ((8 + 8 * dogv) * N, (2 * (by + bz) + 3 * dogv) * N)
            lvb = bound((8 + 4 * dogv) * N,
                        (2 * (bx + by + bz) + 3 * dogv) * N)
            for key, b, ms, pms in (("blur_x", bxb, xms, pxms),
                                    ("blur_yz_dog", yzb, yzms, pyzms)):
                for j, v in enumerate((b[0], b[1], ms, pms)):
                    sums[key][j] += v / plan.num_gpyr_levels
            print(f"       level {i} (bands {bx}/{by}/{bz}): x {xms:.4f} ms "
                  f"(bound {bound(*bxb)[0]:.4f}), y/z{'+DoG' * dogv} "
                  f"{yzms:.4f} ms (bound {bound(*yzb)[0]:.4f}), level "
                  f"{lvms:.4f} ms (bound as one function {lvb[0]:.4f}); "
                  f"plain x {pxms:.4f}, plain y/z {pyzms:.4f}, conv3d x "
                  f"{lms:.4f} ms", flush=True)
        print(f"       conv3d vs x pass away from the clipped edges: max abs "
              f"diff {lib_err:.3g}", flush=True)
        assert lib_err <= 1e-6
        # Per kernel: the mean over the six levels of octave 0.
        for key, counter, lib in (("blur_x", n_launches("blur_x"), lib_ms),
                                  ("blur_yz_dog", n_launches("blur_yz_dog"),
                                   None)):
            nbytes, ops, ms, pms = sums[key]
            s.record(key, "sift3d_tpu_torch/csrc/blur.cu",
                     "sift3d_tpu/ops/blur_kernel.py:337", err, ms, pms,
                     counter, bound(nbytes, ops), lib)

    def extrema_phase():
        dog = st_["dog"]
        thr = (torch.tensor(params.peak_thresh, device=dev)
               * st_["dogmax"][1:1 + nl]).contiguous()
        found = {}
        for cuboid in (False, True):
            rk, rc = ek.extrema_candidates_plain(dog, thr, cuboid)
            rk = torch.sort(rk).values
            found[cuboid] = rk.numel()
            for cap in (None, 1):   # 1: too small, so the kernel runs again
                n0 = n_launches("extrema_candidates")
                keys, counts = ek.extrema_candidates(dog, thr, cuboid, cap)
                runs = n_launches("extrema_candidates") - n0
                assert runs == (2 if cap == 1 and rk.numel() > 1 else 1)
                assert torch.equal(torch.sort(keys).values, rk), (cuboid, cap)
                assert torch.equal(counts, rc), (cuboid, cap)
        print(f"       candidates identical to the plain route: "
              f"{found[False]} (face), {found[True]} (cuboid); also at "
              f"capacity 1, through the second launch", flush=True)
        # The kernel alone, launched into fixed buffers (its count is not
        # read); then the wrapper, which reads the count (a host sync); then
        # the whole stage as detect.py runs it.
        _, nx, ny, nz = dog.shape
        keys = torch.empty(ek.default_capacity(dog.shape), dtype=torch.int64,
                           device=dev)
        counts = torch.zeros(1 + nl, dtype=torch.int64, device=dev)

        def kernel():
            _build.call("s3d_extrema_candidates", dog.data_ptr(),
                        thr.data_ptr(), keys.data_ptr(), counts.data_ptr(),
                        keys.numel(), 1, nl, nx, ny, nz, 1, nz - 2, 0, nz, 0,
                        _build.stream_ptr(dog))
        ms = cuda_ms(torch, kernel, inner=KERNEL_INNER)
        wms = cuda_ms(torch, lambda: ek.extrema_candidates(dog, thr))
        pms = cuda_ms(torch, lambda: ek.extrema_candidates_plain(dog, thr))
        stage = cuda_ms(torch, lambda: detect_extrema_octave(
            dog, st_["dogmax"], params))
        print(f"       extrema_candidates with the count read {wms:.4f} ms; "
              f"detect_extrema_octave (threshold, kernel, count, sort, "
              f"decode, strength) {stage:.4f} ms", flush=True)
        cen = dog[1:1 + nl]
        t = thr.reshape(nl, 1, 1, 1)
        past = ((cen > t) | (cen < -t)).reshape(nl, -1).sum(dim=1)
        passing = int(past.sum())
        # Bytes, for this run's data: the keypoint levels' DoG read once;
        # for a voxel past the threshold of the first (last) keypoint
        # level, the centre of DoG level 0 (nl + 1), which no keypoint
        # level holds; the keys and counts written. Ops: two threshold
        # compares per voxel of a keypoint level, two compares per
        # neighbour where the threshold passes.
        outer = int(past[0]) + int(past[-1])
        print(f"       {passing} of {cen.numel()} keypoint-level voxels past "
              f"the threshold", flush=True)
        s.record("extrema_candidates", "sift3d_tpu_torch/csrc/extrema.cu",
                 "sift3d_tpu/ops/extrema_kernel.py:384", 0.0, ms, pms,
                 n_launches("extrema_candidates"),
                 bound(4 * cen.numel() + 4 * outer + 8 * found[False]
                       + 8 * (1 + nl), 2 * cen.numel() + 16 * passing))

    def box_voxels(coords, sd, sig_fctr, rad_fctr, units, dims):
        """Per keypoint, the voxels of its loop-bound box and of its
        sphere (f32 arithmetic of the kernels, on the host)."""
        c = coords.cpu().numpy().astype(np.float32)
        rad = (sd.cpu().numpy().astype(np.float32) * np.float32(sig_fctr)
               * np.float32(rad_fctr))
        box = np.ones(len(c))
        for a in range(3):
            ra = rad / np.float32(units[a])
            lo = np.maximum(np.floor(c[:, a] - ra), 1)
            hi = np.minimum(np.ceil(c[:, a] + ra), dims[a] - 2)
            box *= np.maximum(hi - lo + 1, 0)
        sphere = 4.0 / 3.0 * np.pi * (rad / np.prod(units) ** (1 / 3)) ** 3
        return float(box.sum()), float(np.minimum(sphere, box).sum())

    def orient_check(name, cand, sd, centers, sd_max, fractional,
                     levels=None, lvl=None):
        """s3d_orient vs orient_plain on one octave's candidates, at their
        integer or at fractional centers; timed. levels, lvl: a batch's
        flattened level stack and the candidates' levels in it (default
        octave 0's keypoint levels and cand.level)."""
        if levels is None:
            levels, lvl = st_["gpyr"][1:1 + nl], cand.level
        args = (levels, lvl, cand.coords, sd, plan.units, params)
        kw = dict(centers=centers, sd_max=sd_max, fractional=fractional)
        got = ok.orient(*args, **kw)
        ref = ok.orient_plain(*args, **kw)
        K = ref.A.shape[0]
        for a, b in ((got.A, ref.A), (got.vd, ref.vd)):
            err = (a - b).abs().reshape(K, -1).amax(1)
            scale = b.abs().reshape(K, -1).amax(1)
            assert bool((err <= 1e-5 * scale).all()), \
                float((err / scale).max())
        for flag in ("accepted", "reject_grad", "reject_ratio",
                     "reject_corner"):
            assert torch.equal(getattr(got, flag), getattr(ref, flag)), flag
        acc = ref.accepted
        rerr = float((got.R[acc] - ref.R[acc]).abs().max())
        assert rerr <= 1e-5, rerr
        print(f"       {name}: K={K} candidates, {int(acc.sum())} accepted "
              f"(predicates identical), R max err {rerr:.3g}", flush=True)
        ms = cuda_ms(torch, lambda: ok.orient(*args, **kw), inner=KERNEL_INNER)
        pms = cuda_ms(torch, lambda: ok.orient_plain(*args, **kw))
        box, sphere = box_voxels(centers, sd, params.ori_sig_fctr,
                                 params.ori_rad_fctr, plan.units,
                                 plan.octave_dims[0])
        # reads: each box voxel once (4 B); ops: the sphere test on every
        # box voxel, gradient + weight + 9 sums on the sphere's.
        s.record(name, "sift3d_tpu_torch/csrc/ori.cu",
                 "sift3d_tpu/ops/ori_kernel.py:167",
                 max(float((got.A - ref.A).abs().max()),
                     float((got.vd - ref.vd).abs().max()), rerr), ms, pms,
                 n_launches("orient"),
                 bound(4 * box + 76 * K, 11 * box + 40 * sphere))
        return got, acc

    def ori_phase():
        cand = detect_extrema_octave(st_["dog"], st_["dogmax"], params)
        scales = torch.tensor(plan.scales[0][1:1 + nl], device=dev)
        sd = scales[cand.level].contiguous()
        centers = cand.coords.float()
        got, acc = orient_check("orient", cand, sd, centers,
                                plan.scales[0][nl], False)
        st_.update(cand=cand, lvl=cand.level[acc], centers=centers[acc],
                   R=got.R[acc].contiguous(), sd=sd[acc].contiguous(),
                   A=got.A.contiguous())

    def ori_frac_phase():
        # The same candidates at fractional centers and scales as
        # refinement makes them: offsets in [-1, 1] voxel, scales times
        # 2^(ds / nl) for ds in [-1, 1] (seeded).
        cand = st_["cand"]
        K = cand.level.numel()
        g = np.random.default_rng(11)
        off = torch.from_numpy(g.uniform(-1, 1, (K, 3)).astype(np.float32))
        ds = torch.from_numpy(g.uniform(-1, 1, K).astype(np.float32))
        scales = torch.tensor(plan.scales[0][1:1 + nl], device=dev)
        sd = (scales[cand.level] * torch.exp2(ds.to(dev) / nl)).contiguous()
        centers = (cand.coords.float() + off.to(dev)).contiguous()
        sd_max = plan.scales[0][nl] * 2.0 ** (1.0 / nl)
        got, acc = orient_check("orient_fractional", cand, sd, centers,
                                sd_max, True)
        st_["frac"] = dict(lvl=cand.level[acc],
                           centers=centers[acc].contiguous(),
                           R=got.R[acc].contiguous(),
                           sd=sd[acc].contiguous(), sd_max=sd_max)

    def eigh_phase():
        g = np.random.default_rng(8)
        M = g.normal(size=(4096, 3, 3)).astype(np.float32)
        special = np.stack([np.eye(3), np.diag([1.0, 1.0, 2.0]),
                            np.zeros((3, 3)), np.full((3, 3), np.nan),
                            np.diag([np.inf, 1.0, 2.0])]).astype(np.float32)
        # The octave's candidates' DoG Hessians: what the edge test of
        # refinement.py hands the kernel on the refined path.
        cand = st_["cand"]
        _, H = derivatives(gather_neighbourhoods(st_["dog"], cand.coords,
                                                 cand.level)[:, 1])
        H = H.contiguous()
        A = torch.cat([st_["A"], H, torch.from_numpy(np.concatenate(
            [np.einsum("kij,klj->kil", M, M), special])).to(dev)])
        n0 = n_launches("eigh3x3")
        w, V = ok.eigh3x3(A)
        assert n_launches("eigh3x3") == n0 + 1
        wr, Vr = ok.eigh3x3_plain(A)

        def bits_equal(a, b):
            same = a.view(torch.int32) == b.view(torch.int32)
            return bool((same | (torch.isnan(a) & torch.isnan(b))).all())
        assert bits_equal(w, wr) and bits_equal(V, Vr)
        print(f"       s3d_eigh3x3 bit-identical to eigh3x3_plain on "
              f"{A.shape[0]} matrices ({st_['A'].shape[0]} of the octave's "
              f"moments, {H.shape[0]} DoG Hessians, degenerate, zero, NaN "
              f"and inf included)", flush=True)
        # Timed on the Hessians, the shape the refined path gives it;
        # torch.linalg.eigh (cuSOLVER) as the library call.
        K = H.shape[0]
        ms = cuda_ms(torch, lambda: ok.eigh3x3(H), inner=KERNEL_INNER)
        pms = cuda_ms(torch, lambda: ok.eigh3x3_plain(H))
        lms = cuda_ms(torch, lambda: torch.linalg.eigh(H), inner=KERNEL_INNER)
        wl = torch.linalg.eigh(H).eigenvalues
        wk = ok.eigh3x3(H)[0]
        print(f"       torch.linalg.eigh vs s3d_eigh3x3 eigenvalues on the "
              f"Hessians: max abs diff {float((wl - wk).abs().max()):.3g}",
              flush=True)
        s.record("eigh3x3", "sift3d_tpu_torch/csrc/ori.cu",
                 "sift3d_tpu/orientation.py:110", 0.0, ms, pms,
                 n_launches("eigh3x3"), bound(84 * K, EIGH_OPS * K), lms)

    def desc_check(name, lvl, centers, R, sd, sd_max, fractional,
                   levels=None):
        """s3d_desc_fused vs prep_windows + desc_hist_plain, 3 runs;
        timed. levels: a batch's flattened level stack, which lvl indexes
        (default octave 0's keypoint levels)."""
        if levels is None:
            levels = st_["gpyr"][1:1 + nl]
        args = (levels, lvl, centers, R, sd, plan.units, params, sd_max,
                fractional)
        ref = dk.desc_fused_plain(*args)
        runs = [dk.desc_fused(*args) for _ in range(3)]
        K = ref.shape[0]
        rn = ref.reshape(K, -1).norm(dim=1)
        rel = [((h - ref).reshape(K, -1).norm(dim=1) / rn) for h in runs]
        # Exact integer sums: every run gives the same bits.
        assert all(torch.equal(runs[0], h) for h in runs[1:])
        extents = dk.window_extents(sd_max, plan.units, plan.octave_dims[0],
                                    params, 4 if fractional else 0)
        grot, _ = dk.prep_windows(levels, lvl, centers.round().long(),
                                  centers, R, sd, plan.units, extents, params)
        work = float((grot.abs().sum(dim=1) > 0).sum())
        del grot
        box, _ = box_voxels(centers, sd, params.desc_sig_fctr,
                            params.desc_rad_fctr, plan.units,
                            plan.octave_dims[0])
        print(f"       {name}: K={K} keypoints, {box:.0f} box voxels, "
              f"{work:.0f} in sphere and cube; rel-L2 vs plain per run "
              f"{[float(r.max()) for r in rel]}; 3 runs bit-identical",
              flush=True)
        assert all(bool((r <= 1e-5).all()) for r in rel)
        ms = cuda_ms(torch, lambda: dk.desc_fused(*args), inner=KERNEL_INNER)
        pms = cuda_ms(torch, lambda: dk.desc_fused_plain(*args), reps=5)
        s.record(name, "sift3d_tpu_torch/csrc/desc.cu",
                 "sift3d_tpu/ops/desc_kernel.py:304",
                 max(float((h - ref).abs().max()) for h in runs), ms, pms,
                 n_launches("desc_fused"),
                 bound(4 * box + 4 * ref.numel(), DESC_OPS_PER_VOXEL * work))

    def desc_phase():
        desc_check("desc_fused", st_["lvl"], st_["centers"], st_["R"],
                   st_["sd"], plan.scales[0][nl], False)

    def desc_frac_phase():
        f = st_["frac"]
        desc_check("desc_fused_fractional", f["lvl"], f["centers"], f["R"],
                   f["sd"], f["sd_max"], True)

    def batch_kernel_phase():
        """The four kernels over a batch of BATCH_PHANTOMS at 256^3, octave
        0, against their per-volume plain versions. Eight volumes' level
        stack is 805 M floats: the orientation and descriptor kernels'
        offsets into it pass 2^31 bytes."""
        B = len(BATCH_PHANTOMS)
        xb = scale_to_unit(torch.stack([bench_volume(kind, 256, dev, seed)
                                        for kind, seed in BATCH_PHANTOMS]))
        assert torch.equal(xb[0], x)      # the sparse256 bench phantom
        L = plan.num_gpyr_levels
        dims = tuple(plan.octave_dims[0])
        N = xb[0].numel()
        gpyr = torch.empty((B, L) + dims, device=dev)
        dog = torch.empty((B, L - 1) + dims, device=dev)
        dmax = torch.zeros((B, L - 1), device=dev)
        tmp = torch.empty((B,) + dims, device=dev)
        sums = {k: [0.0] * 5 for k in ("blur_x", "blur_yz_dog")}
        for i in range(L):
            src = xb if i == 0 else gpyr[:, i - 1]
            diags = bk._diags(plan, 0, i, dev)
            (wx, lox), (wy, loy), (wz, loz) = diags
            bx, by, bz = (wd.shape[1] for wd, _ in diags)
            prev, dg, m = ((None, None, None) if i == 0 else
                           (src, dog[:, i - 1], dmax[:, i - 1]))
            n0 = (n_launches("blur_x"), n_launches("blur_yz_dog"))
            bk.blur_x(src, wx, lox, tmp)
            bk.blur_yz_dog(tmp, wy, loy, wz, loz, gpyr[:, i], prev, dg, m)
            assert (n_launches("blur_x") - n0[0],
                    n_launches("blur_yz_dog") - n0[1]) == (1, 1)
            for b in range(B):
                xr = bk.blur_x_plain(src[b], wx, lox)
                assert torch.equal(tmp[b], xr), (i, b)
                cr, dr, mr = bk.blur_yz_dog_plain(
                    xr, wy, loy, wz, loz, None if i == 0 else src[b])
                assert torch.equal(gpyr[b, i], cr), (i, b)
                if i:
                    assert torch.equal(dog[b, i - 1], dr), (i, b)
                    assert torch.equal(dmax[b, i - 1], mr), (i, b)
            srcc = src.contiguous()
            w = wx[dims[0] // 2].reshape(1, 1, bx, 1, 1).contiguous()
            xms = cuda_ms(torch, lambda: bk.blur_x(src, wx, lox, tmp),
                          inner=KERNEL_INNER)
            yzms = cuda_ms(torch, lambda: bk.blur_yz_dog(
                tmp, wy, loy, wz, loz, gpyr[:, i], prev, dg, m),
                inner=KERNEL_INNER)
            pxms = cuda_ms(torch, lambda: [bk.blur_x_plain(src[b], wx, lox)
                                           for b in range(B)], reps=3)
            pyzms = cuda_ms(torch, lambda: [bk.blur_yz_dog_plain(
                tmp[b], wy, loy, wz, loz, None if i == 0 else src[b])
                for b in range(B)], reps=3)
            lms = cuda_ms(torch, lambda: F.conv3d(
                srcc[:, None], w, padding=(-lox, 0, 0)), inner=KERNEL_INNER)
            dogv = 1 if i else 0
            bxb = (8 * B * N, 2 * bx * B * N)
            yzb = ((8 + 8 * dogv) * B * N, (2 * (by + bz) + 3 * dogv) * B * N)
            for key, bb, ms, pms, lm in (("blur_x", bxb, xms, pxms, lms),
                                         ("blur_yz_dog", yzb, yzms, pyzms,
                                          0.0)):
                for j, v in enumerate((bb[0], bb[1], ms, pms, lm)):
                    sums[key][j] += v / L
            print(f"       batch of {B}, level {i}: x {xms:.4f} ms, y/z"
                  f"{'+DoG' * dogv} {yzms:.4f} ms; per-volume plain x "
                  f"{pxms:.4f}, y/z {pyzms:.4f} ms; conv3d x (N={B}) "
                  f"{lms:.4f} ms", flush=True)
        print(f"       blur and DoG of the batch bit-exact to each volume's "
              f"plain version, max |DoG| per volume {dmax[:, 0].tolist()} "
              f"(level 0)", flush=True)
        for key, lib in (("blur_x", True), ("blur_yz_dog", False)):
            nbytes, ops, ms, pms, lm = sums[key]
            s.record(f"{key}_batch{B}", "sift3d_tpu_torch/csrc/blur.cu",
                     "sift3d_tpu/ops/blur_kernel.py:337", 0.0, ms, pms,
                     n_launches(key), bound(nbytes, ops),
                     lm if lib else None)

        # Extrema: one launch for the batch, keys offset by the volume.
        thr = (torch.tensor(params.peak_thresh, device=dev)
               * dmax[:, 1:1 + nl]).contiguous()
        per = nl * N
        found = 0
        for cap in (None, 1):
            n0 = n_launches("extrema_candidates")
            keys, counts = ek.extrema_candidates(dog, thr, False, cap)
            assert n_launches("extrema_candidates") - n0 == \
                (1 if cap is None else 2)
            keys = torch.sort(keys).values
            for b in range(B):
                rk, rc = ek.extrema_candidates_plain(dog[b], thr[b])
                mine = keys[(keys >= b * per) & (keys < (b + 1) * per)]
                assert torch.equal(mine - b * per, torch.sort(rk).values), b
                assert torch.equal(counts[b], rc), b
            found = keys.numel()
        print(f"       extrema of the batch: {found} candidates "
              f"({counts.sum(dim=1).tolist()} per volume), each volume's "
              f"keys offset by b; also at capacity 1", flush=True)
        kbuf = torch.empty(ek.default_capacity(dog.shape), dtype=torch.int64,
                           device=dev)
        cbuf = torch.zeros(1 + B * nl, dtype=torch.int64, device=dev)

        def kernel():
            _build.call("s3d_extrema_candidates", dog.data_ptr(),
                        thr.data_ptr(), kbuf.data_ptr(), cbuf.data_ptr(),
                        kbuf.numel(), B, nl, *dims, 1, dims[2] - 2, 0,
                        dims[2], 0, _build.stream_ptr(dog))
        ms = cuda_ms(torch, kernel, inner=KERNEL_INNER)
        pms = cuda_ms(torch, lambda: [ek.extrema_candidates_plain(
            dog[b], thr[b]) for b in range(B)], reps=3)
        cen = dog[:, 1:1 + nl]
        t = thr.reshape(B, nl, 1, 1, 1)
        past = ((cen > t) | (cen < -t)).reshape(B, nl, -1).sum(dim=2)
        passing = int(past.sum())
        outer = int(past[:, 0].sum()) + int(past[:, -1].sum())
        s.record(f"extrema_candidates_batch{B}",
                 "sift3d_tpu_torch/csrc/extrema.cu",
                 "sift3d_tpu/ops/extrema_kernel.py:384", 0.0, ms, pms,
                 n_launches("extrema_candidates"),
                 bound(4 * cen.numel() + 4 * outer + 8 * found
                       + 8 * (1 + B * nl), 2 * cen.numel() + 16 * passing))

        # Orientation and descriptors on the flattened [B * L] stack,
        # keypoint level l of volume b at stack level b * L + 1 + l.
        cand = detect_extrema_octave(dog, dmax, params)
        scales = torch.tensor(plan.scales[0][1:1 + nl], device=dev)
        sd = scales[cand.level].contiguous()
        centers = cand.coords.float()
        levels = gpyr.reshape((B * L,) + dims)
        lvl = cand.batch * L + 1 + cand.level
        got, acc = orient_check(f"orient_batch{B}", cand, sd, centers,
                                plan.scales[0][nl], False, levels, lvl)
        for b in range(B):   # each volume's own launch gives the same bits
            sel = cand.batch == b
            one = ok.orient(gpyr[b, 1:1 + nl], cand.level[sel],
                            cand.coords[sel], sd[sel].contiguous(),
                            plan.units, params, centers=centers[sel])
            assert torch.equal(one.A, got.A[sel]) and \
                torch.equal(one.R, got.R[sel]), b
        desc_check(f"desc_fused_batch{B}", lvl[acc],
                   centers[acc].contiguous(), got.R[acc].contiguous(),
                   sd[acc].contiguous(), plan.scales[0][nl], False, levels)
        # Each volume's own launch gives the batch's bits; the dense bench
        # phantom (volume 1: dense256 octave 0) twice, and timed alone.
        Rb = got.R.contiguous()
        hist = dk.desc_fused(levels, lvl[acc], centers[acc].contiguous(),
                             Rb[acc], sd[acc].contiguous(), plan.units,
                             params, plan.scales[0][nl])
        for b in range(B):
            sel = (cand.batch == b) & acc
            dargs = (gpyr[b, 1:1 + nl], cand.level[sel],
                     centers[sel].contiguous(), Rb[sel], sd[sel].contiguous(),
                     plan.units, params, plan.scales[0][nl])
            one = dk.desc_fused(*dargs)
            assert torch.equal(one, hist[sel[acc]]), b
            if b == 1:
                assert torch.equal(one, dk.desc_fused(*dargs))
                dms = cuda_ms(torch, lambda: dk.desc_fused(*dargs),
                              inner=KERNEL_INNER)
                print(f"       desc_fused on dense256 octave 0 alone "
                      f"({int(sel.sum())} keypoints): {dms:.4f} ms on "
                      f"{card}", flush=True)
        print(f"       desc_fused: each of the {B} volumes' own launch gives "
              f"the batch's bits; dense256 octave 0 twice, the same bits",
              flush=True)
        del gpyr, dog, tmp, xb

    def make_pair_on_card(n, rng, fixed):
        """tools/bench_registration.py make_pair's draws from rng (the
        angle, then the shift) and the moving volume, warped on the card:
        (moving Volume, A_true f32[3, 4])."""
        th = np.deg2rad(rng.uniform(6, 10))
        Rz = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        c = np.array([(n - 1) / 2.0] * 3)
        t = rng.uniform(-4, 4, 3)
        A = np.zeros((3, 4), np.float32)
        A[:, :3] = Rz
        A[:, 3] = c - Rz @ c + t
        M = np.eye(4)
        M[:3] = A
        moving = st.warp_volume(fixed, np.linalg.inv(M)[:3].astype(np.float32),
                                (n, n, n), device=dev)
        return moving, A

    def check_moving(moving, sample, stride, what):
        samp = moving.data[::stride, ::stride, ::stride].cpu().numpy()
        vmax = float(moving.data.abs().max())
        err = float(np.abs(samp - sample).max())
        print(f"       {what}: every {stride}th voxel ({samp.size}) vs the "
              f"JAX golden's: max abs diff {err:.3g} (max |vol| {vmax:.3g})",
              flush=True)
        assert err <= 1e-5 * vmax

    def batch_pairs_phase():
        """The pairs of BASELINE config 5: after the 192^3 pair's draws,
        make_pair(256) four times from default_rng(3), on the card."""
        g = np.load(BATCH_GOLDEN)
        n, P = int(g["size"]), int(g["pairs"])
        rng = np.random.default_rng(3)
        rng.uniform(6, 10)          # the 192^3 pair's angle and shift
        rng.uniform(-4, 4, 3)
        fixed = st.Volume.from_array(bench_volume("sparse", n, dev),
                                     device=dev)
        movs, As = [], []
        for b in range(P):
            moving, A = make_pair_on_card(n, rng, fixed)
            assert np.array_equal(A, g[f"A_true{b}"]), b
            check_moving(moving, g[f"moving_sample{b}"],
                         int(g["moving_stride"]), f"pair {b} moving volume")
            movs.append(moving.data)
            As.append(A)
        st_["batch"] = (fixed.data[None].expand(P, -1, -1, -1).contiguous(),
                        torch.stack(movs), As, g)

    def batch_register_phase():
        fixed_b, moving_b, As, g = st_["batch"]
        n, P = int(g["size"]), len(As)
        p = st.DetectorParams()
        det = st.SIFT3D(p, device="cuda")
        vols = torch.cat([fixed_b, moving_b])
        # Each volume's rows and descriptors against its own run.
        kps = det.detect_keypoints_batch(vols)
        dss = det.extract_descriptors_batch(kps)
        st_["batch_kps"] = kps
        one = st.SIFT3D(p, device="cuda")
        bit_equal, worst = 0, 0.0
        for b in range(2 * P):
            kp = one.detect_keypoints(vols[b])
            ds = one.extract_descriptors(kp)
            for f in ("coords", "octave", "level", "sd", "strength", "R"):
                assert np.array_equal(getattr(kp, f), getattr(kps[b], f)), \
                    (b, f)
            assert np.array_equal(ds.xyz, dss[b].xyz), b
            rel = (np.linalg.norm(ds.data - dss[b].data, axis=1)
                   / np.linalg.norm(ds.data, axis=1))
            worst = max(worst, float(rel.max()))
            bit_equal += int(np.sum(np.all(ds.data == dss[b].data, axis=1)))
        total = sum(len(k) for k in kps)
        print(f"       batch of {2 * P} volumes: keypoint rows identical to "
              f"each volume's own detect_keypoints "
              f"({[len(k) for k in kps]}); descriptors: {bit_equal} of "
              f"{total} bit-equal, max rel-L2 {worst:.3g}", flush=True)
        assert bit_equal == total
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counters()
        res = st.register_batch(fixed_b, moving_b, num_iter=500, det=det)
        launches = read_counters(p, "batch256x4 register_batch")
        peak = torch.cuda.max_memory_allocated() - base
        assert 2 * P == len(BATCH_PHANTOMS)   # the batched kernels' rows
        for name, k in launches.items():
            row = f"{name}_batch{2 * P}"
            s.kernels.setdefault(row, {"name": row})["launches"] = k
        single = st_["sparse256_launches"]
        sub = det.sub_batch
        subs = -(-2 * P // sub)
        print(f"       launches per batch of {2 * P} volumes ({subs} "
              f"sub-batch(es) of {sub}): {launches}; one 256^3 volume: "
              f"{single}", flush=True)
        for name in ("blur_x", "blur_yz_dog", "extrema_candidates"):
            assert launches[name] == subs * single[name], name
        for name in ("orient", "desc_fused"):
            assert launches[name] <= subs * plan.num_octaves, name
        # The same matching and RANSAC on JAX's own hypotheses (the
        # golden's idx{b}, drawn by JAX's PRNG) give JAX's inliers; the
        # port's own hypotheses (a seeded CPU generator) are held to the
        # corner-error bar.
        jax_idx = {int(g[f"matches{b}"]): g[f"idx{b}"].astype(np.int64)
                   for b in range(P)}
        fed = registration._register_pairs(
            dss[P:], kps[P:], dss[:P], kps[:P], 0.8, 5.0, 500, 0, dev,
            sample=lambda gen, num_iter, m: torch.from_numpy(jax_idx[m]))
        for b, (r, f) in enumerate(zip(res, fed)):
            err = corner_error(r.affine, As[b], n)
            jerr = float(g[f"err{b}"])
            vs_jax = corner_error(r.affine, g[f"affine{b}"], n)
            fed_vs_jax = corner_error(f.affine, g[f"affine{b}"], n)
            print(f"       pair {b}: matches {r.num_matches} (JAX "
                  f"{int(g[f'matches{b}'])}); on JAX's hypotheses inliers "
                  f"{f.num_inliers} (JAX {int(g[f'inliers{b}'])}), corner "
                  f"error vs JAX's affine {fed_vs_jax:.4f} vox; on the "
                  f"port's own, inliers {r.num_inliers}, corner error vs "
                  f"truth {err:.4f} vox (JAX {jerr:.4f}), vs JAX's affine "
                  f"{vs_jax:.4f} vox", flush=True)
            assert r.num_matches == f.num_matches == int(g[f"matches{b}"])
            assert f.num_inliers == int(g[f"inliers{b}"])
            assert fed_vs_jax <= 0.25
            assert np.all(np.isfinite(r.affine)) and err <= jerr + 0.25
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.register_batch(fixed_b, moving_b, num_iter=500, det=det)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(walls)
        print(f"       batch256x4 register_batch: median {med:.2f} ms wall "
              f"over 3 runs (min {min(walls):.2f}, max {max(walls):.2f}): "
              f"{P / med * 1e3:.3f} pairs/s, {med / (2 * P):.2f} ms per "
              f"volume; peak memory {peak / 2 ** 20:.1f} MiB above the "
              f"{base / 2 ** 20:.1f} MiB held before; on {card}", flush=True)

    def loader_phase():
        """The batch's eight volumes written as NIfTI (the last .nii.gz),
        read back by BatchVolumeLoader onto the card, into
        detect_keypoints_batch."""
        fixed_b, moving_b, _, _ = st_["batch"]
        vols = torch.cat([fixed_b, moving_b])
        ref = st_["batch_kps"]
        det = st.SIFT3D(params, device="cuda")
        with tempfile.TemporaryDirectory() as tmp:
            paths = []
            for i, v in enumerate(vols.cpu().numpy()):
                paths.append(Path(tmp) / (f"v{i}.nii.gz" if i == len(vols) - 1
                                          else f"v{i}.nii"))
                write_volume(paths[-1], v)
            for bsz in (len(paths), len(paths) // 2):
                t0 = time.perf_counter()
                arrivals, got = [], []
                for bv, units in BatchVolumeLoader(paths, batch_size=bsz,
                                                   device="cuda"):
                    torch.cuda.current_stream().synchronize()
                    arrivals.append((time.perf_counter() - t0) * 1e3)
                    assert bv.is_cuda and units == (1.0, 1.0, 1.0)
                    got.append(bv)
                    if bsz == len(paths):
                        kps = det.detect_keypoints_batch(bv, units)
                assert torch.equal(torch.cat(got), vols)
                print(f"       loader, batches of {bsz}: ready at "
                      f"{[round(a, 2) for a in arrivals]} ms", flush=True)
            for a, b in zip(kps, ref):
                for f in ("coords", "octave", "level", "sd", "strength",
                          "R"):
                    assert np.array_equal(getattr(a, f), getattr(b, f)), f
            # The read and the upload of one batch of eight, apart.
            pinned = torch.empty(tuple(vols.shape), pin_memory=True)
            rms = []
            for _ in range(3):
                t0 = time.perf_counter()
                _read_batch([str(p) for p in paths], tuple(vols.shape[1:]),
                            0, pinned.numpy())
                rms.append((time.perf_counter() - t0) * 1e3)
            ums = cuda_ms(torch, lambda: pinned.to(dev, non_blocking=True),
                          reps=3)
        print(f"       loader: {len(paths)} x 256^3 volumes (7 .nii, 1 "
              f".nii.gz) read into detect_keypoints_batch, keypoints "
              f"identical to the in-memory batch's; native read of the "
              f"batch median {statistics.median(rms):.2f} ms, pinned "
              f"upload {ums:.3f} ms ({vols.numel() * 4 / ums / 1e6:.2f} "
              f"GB/s) on {card}", flush=True)

    counters = ("blur_x", "blur_yz_dog", "extrema_candidates", "orient",
                "desc_fused", "eigh3x3")
    base = {}

    def reset_counters():
        base.update((name, n_launches(name)) for name in counters)

    def read_counters(p, where):
        """Launches since reset_counters; every kernel of the path must
        have run, s3d_eigh3x3 exactly where the edge test is on (without
        it the eigensolver runs inside s3d_orient only)."""
        torch.cuda.synchronize()
        runs = {name: n_launches(name) - base[name] for name in counters}
        print(f"       launches ({where}): {runs}", flush=True)
        if p.edge_thresh is None:
            assert runs.pop("eigh3x3") == 0, runs
        missing = [name for name, n in runs.items() if n == 0]
        assert not missing, f"not launched on the path: {missing}"
        return runs

    def main_path(cell):
        _, size, units, reps, ext = CELLS[cell]
        p = st.DetectorParams(**ext)
        vol = st.Volume.from_array(vols[cell], units)
        det = st.SIFT3D(p, device="cuda")
        reset_counters()
        kp = det.detect_keypoints(vol)
        desc = det.extract_descriptors(kp)
        launches = read_counters(p, f"main path, {cell}")
        if cell == "sparse256":
            st_["sparse256_launches"] = launches
            for name, n in launches.items():
                s.kernels.setdefault(name, {"name": name})["launches"] = n
            # Two blur launches per blurred level (6 + 5 x 5), one extrema
            # launch per octave.
            assert (launches["blur_x"], launches["blur_yz_dog"],
                    launches["extrema_candidates"]) == (31, 31, 6), launches
        if cell == "refine128":
            # The refined path's own kernel rows: fractional centers, and
            # the eigensolver of the edge test.
            for name, key in (("orient_fractional", "orient"),
                              ("desc_fused_fractional", "desc_fused"),
                              ("eigh3x3", "eigh3x3")):
                s.kernels.setdefault(name, {"name": name})["launches"] = \
                    launches[key]
        st_[f"{cell}_result"] = (kp, desc)
        check_golden(cell, p, kp, desc)

        walls = []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k = det.detect_keypoints(vol)
            det.extract_descriptors(k)
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
        st_[f"{cell}_wall"] = statistics.median(walls)
        print(f"       detect + describe {cell} (units {units}"
              f"{', ' + str(ext) if ext else ''}), {len(kp)} keypoints: "
              f"median {statistics.median(walls):.2f} ms wall over {reps} "
              f"runs (min {min(walls):.2f}, max {max(walls):.2f}) on {card}",
              flush=True)

    def check_golden(cell, p, kp, desc):
        """A cell's keypoints and descriptors against its JAX golden, to
        the reference bars."""
        _, size, units, _, ext = CELLS[cell]
        g = np.load(GOLDENS[cell])
        assert int(g["size"]) == size
        if "units" in g.files:
            assert tuple(g["units"]) == units, g["units"]
        if ext:
            assert bool(g["refine_subvoxel"]) == p.refine_subvoxel
            assert float(g["edge_thresh"]) == p.edge_thresh
        assert len(kp) == len(g["coords"]), (len(kp), len(g["coords"]))
        for f in ("octave", "level"):
            assert np.array_equal(getattr(kp, f), g[f]), f
        if ext:
            # Refined: fractional coordinates from batched 3x3 solves and
            # scales through exp2, on the card against JAX's CPU LAPACK;
            # the true strengths.
            cerr = float(np.abs(kp.coords - g["coords"]).max())
            sderr = float(np.max(np.abs(kp.sd - g["sd"]) / g["sd"]))
            assert cerr <= 1e-5 and sderr <= 1e-6, (cerr, sderr)
            assert np.array_equal(kp.strength, g["strength"])
            srel = 0.0
            print(f"       refined rows: coords max abs err {cerr:.3g}, sd "
                  f"max rel err {sderr:.3g}, strength exact; "
                  f"{int(np.sum(kp.coords != np.rint(kp.coords)))} of "
                  f"{kp.coords.size} coordinates fractional", flush=True)
        else:
            for f in ("coords", "sd"):
                assert np.array_equal(getattr(kp, f), g[f]), f
            srel = float(np.max(np.abs(kp.strength - g["strength"])
                                / np.abs(g["strength"])))
        rows = np.abs(kp.R - g["R"]).reshape(len(kp), -1).max(axis=1)
        rows64 = np.abs(kp.R - g["R64"]).reshape(len(kp), -1).max(axis=1)
        off = np.nonzero(rows > 1e-5)[0]
        rerr = float(np.delete(rows, off).max(initial=0.0))
        # R is an eigenvector basis: where two eigenvalues are close, f32
        # moment sums in two orders move it past 1e-5. Such a row is held
        # to the golden's R64, the JAX orientation with f64 sums as the C
        # reference accumulates (sift.c:978-983): the port must be within
        # 1e-5 of it, and the golden's f32 R must be what misses the bar.
        for i in off:
            gold64 = float(np.abs(g["R"][i] - g["R64"][i]).max())
            print(f"       row {i} (octave {kp.octave[i]}): R vs golden "
                  f"{rows[i]:.3g}; vs the golden's f64-sum R64: port "
                  f"{rows64[i]:.3g}, golden {gold64:.3g}", flush=True)
            assert rows64[i] <= 1e-5 < gold64, i
        # Relative L2; an all-zero golden descriptor (a window with no
        # gradient above bary_eps) must be matched by zeros.
        gn = np.linalg.norm(g["desc"], axis=1)
        derr = (np.linalg.norm(desc.data - g["desc"], axis=1)
                / np.where(gn > 0, gn, 1.0))
        within = float(np.mean(derr <= 0.01))
        print(f"       vs JAX golden ({cell}): {len(kp)} keypoint rows "
              f"in order, strength max rel {srel:.3g}, R max err "
              f"{rerr:.3g} ({len(off)} rows held to R64 instead; port vs "
              f"R64 on all rows {float(rows64.max()):.3g}), "
              f"descriptors within 1%: {within:.1%} (max rel-L2 "
              f"{float(derr.max()):.3g})", flush=True)
        assert srel <= 1.2e-7 and rerr <= 1e-5 and within == 1.0
        if ext:
            scale = 2.0 ** kp.octave[:, None]
            assert np.all(np.abs(desc.xyz - g["desc_xyz"]) <= 1e-5 * scale)
        else:
            assert np.array_equal(desc.xyz, g["desc_xyz"])
        assert np.all(np.isfinite(desc.data))

    def slab_phase():
        """The four kernels on the four z-slabs of sparse256 octave 0 that
        ShardedSIFT3D gives them (each slab with its halo of the
        neighbours' rows), against one whole-volume launch: bits equal;
        each row timed as the four slab launches back to back."""
        S, nz = SHARDS, plan.octave_dims[0][2]
        n = nz // S
        L = plan.num_gpyr_levels
        slabs = [c.contiguous() for c in x.chunk(S, dim=-1)]
        octs, flags = build_gpyr_sharded(slabs, plan, [dev] * S)
        for o, sl in enumerate(octs):
            assert torch.equal(torch.cat([t.gpyr for t in sl], -1),
                               st_["pyr"][0][o]), o
            assert torch.equal(torch.cat([t.dog for t in sl], -1),
                               st_["pyr"][1][o]), o
            assert torch.equal(torch.stack([t.dogmax for t in sl]).amax(0),
                               st_["pyr"][2][o]), o
        print(f"       pyramid of {S} slabs (octaves sharded {flags}) "
              f"bit-equal to the whole volume's: levels, DoG, max |DoG|",
              flush=True)
        N = x.numel()
        sums = {k: [0.0] * 5 for k in ("blur_x", "blur_yz_dog")}
        g0 = st_["gpyr"]
        for i in range(L):
            srcs = slabs if i == 0 else [t.gpyr[i - 1] for t in octs[0]]
            diags = bk._diags(plan, 0, i, dev)
            (wx, lox), (wy, loy), (wz, loz) = diags
            h = diag_halo(*plan.conv_diags(0, plan.first_taps if i == 0
                                           else plan.level_taps[i])[2])
            tmps = [torch.empty_like(t) for t in srcs]
            for t, tm in zip(srcs, tmps):
                bk.blur_x(t, wx, lox, tm)
            exts = z_extend(tmps, h)
            curs = [torch.empty_like(t) for t in srcs]
            dogs = [torch.empty_like(t) for t in srcs] if i else None
            dms = [torch.zeros(1, device=dev) for _ in srcs] if i else None

            def yz():
                for s_ in range(S):
                    bk.blur_yz_dog(exts[s_], wy, loy, wz[s_ * n:(s_ + 1) * n],
                                   loz, curs[s_], srcs[s_] if i else None,
                                   dogs[s_] if i else None,
                                   dms[s_] if i else None, z_off=h)
            yz()
            assert torch.equal(torch.cat(curs, -1), g0[i]), i
            xms = cuda_ms(torch, lambda: [bk.blur_x(t, wx, lox, tm) for t, tm
                                          in zip(srcs, tmps)],
                          inner=KERNEL_INNER)
            yzms = cuda_ms(torch, yz, inner=KERNEL_INNER)
            hms = cuda_ms(torch, lambda: z_extend(tmps, h))
            pxms = cuda_ms(torch, lambda: [bk.blur_x_plain(t, wx, lox)
                                           for t in srcs], reps=3)
            pyzms = cuda_ms(torch, lambda: [bk.blur_yz_dog_plain(
                exts[s_], wy, loy, wz[s_ * n:(s_ + 1) * n], loz,
                srcs[s_] if i else None, h) for s_ in range(S)], reps=3)
            dogv = 1 if i else 0
            Ne = sum(e.numel() for e in exts)
            bxb = (8 * N, 2 * wx.shape[1] * N)
            yzb = (4 * Ne + (4 + 8 * dogv) * N,
                   2 * (wy.shape[1] * Ne + wz.shape[1] * N) + 3 * dogv * N)
            for key, bb, ms, pms in (("blur_x", bxb, xms, pxms),
                                     ("blur_yz_dog", yzb, yzms, pyzms)):
                for j, v in enumerate((bb[0], bb[1], ms, pms)):
                    sums[key][j] += v / L
            print(f"       {S} slabs, level {i} (z halo {h}): x {xms:.4f} ms, "
                  f"y/z{'+DoG' * dogv} {yzms:.4f} ms, halo exchange "
                  f"{hms:.4f} ms; plain x {pxms:.4f}, y/z {pyzms:.4f} ms",
                  flush=True)
        for key in ("blur_x", "blur_yz_dog"):
            nbytes, ops, ms, pms, _ = sums[key]
            s.record(f"{key}_shard", "sift3d_tpu_torch/csrc/blur.cu",
                     "sift3d_tpu/ops/blur_kernel.py:337", 0.0, ms, pms,
                     n_launches(key), bound(nbytes, ops))

        # Extrema: four DoG slabs with a one-voxel halo, global keys.
        dog, dmax = st_["dog"], st_["dogmax"]
        thr = (torch.tensor(params.peak_thresh, device=dev)
               * dmax[1:1 + nl]).contiguous()
        keys, counts = ek.extrema_candidates(dog, thr)
        dexts = z_extend([c.contiguous() for c in dog.chunk(S, dim=-1)], 1)
        parts = [ek.extrema_candidates(e, thr, z_origin=n * s_ - 1,
                                       global_nz=nz, z_rows=(1, n + 1))
                 for s_, e in enumerate(dexts)]
        assert torch.equal(torch.sort(torch.cat([k for k, _ in parts]))
                           .values, torch.sort(keys).values)
        assert torch.equal(sum(c for _, c in parts), counts)
        kbuf = torch.empty(ek.default_capacity(dog.shape), dtype=torch.int64,
                           device=dev)
        cbuf = torch.zeros(1 + nl, dtype=torch.int64, device=dev)
        _, nx, ny, _ = dog.shape

        def kernels():
            for s_, e in enumerate(dexts):
                zmin, zmax = ek.z_test_rows(n + 2, n * s_ - 1, nz, (1, n + 1))
                _build.call("s3d_extrema_candidates", e.data_ptr(),
                            thr.data_ptr(), kbuf.data_ptr(), cbuf.data_ptr(),
                            kbuf.numel(), 1, nl, nx, ny, n + 2, zmin, zmax,
                            n * s_ - 1, nz, 0, _build.stream_ptr(e))
        ms = cuda_ms(torch, kernels, inner=KERNEL_INNER)
        pms = cuda_ms(torch, lambda: [ek.extrema_candidates_plain(
            e, thr, False, n * s_ - 1, nz, (1, n + 1))
            for s_, e in enumerate(dexts)], reps=3)
        cen = dog[1:1 + nl]
        t = thr.reshape(nl, 1, 1, 1)
        past = ((cen > t) | (cen < -t)).reshape(nl, -1).sum(dim=1)
        outer = int(past[0]) + int(past[-1])
        print(f"       extrema on {S} haloed DoG slabs: keys identical to the "
              f"whole volume's ({keys.numel()}); slab kernels {ms:.4f} ms",
              flush=True)
        s.record("extrema_candidates_shard", "sift3d_tpu_torch/csrc/extrema.cu",
                 "sift3d_tpu/ops/extrema_kernel.py:384", 0.0, ms, pms,
                 n_launches("extrema_candidates"),
                 bound(4 * cen.numel() + 4 * outer + 8 * keys.numel()
                       + 8 * S * (1 + nl),
                       2 * cen.numel() + 16 * int(past.sum())))

        # Orientation and descriptors: each slab's candidates (those whose
        # window centre it owns) on its levels extended by the windows'
        # halo, with the slab's z origin.
        cand = st_["cand"]
        levels = st_["gpyr"][1:1 + nl]
        lslabs = [c.contiguous() for c in levels.chunk(S, dim=-1)]
        scales = torch.tensor(plan.scales[0][1:1 + nl], device=dev)
        sd = scales[cand.level].contiguous()
        centers = cand.coords.float().contiguous()
        args = (levels, cand.level, cand.coords, sd, plan.units, params)
        ref = ok.orient(*args, centers=centers)
        h = ori_halo(plan, 0, params)
        oext = z_extend(lslabs, h)
        sels = [(cand.coords[:, 2] >= n * s_)
                & (cand.coords[:, 2] < n * (s_ + 1)) for s_ in range(S)]
        oargs = [(oext[s_], cand.level[m], cand.coords[m],
                  sd[m].contiguous(), plan.units, params)
                 for s_, m in enumerate(sels)]
        okw = [dict(centers=centers[m].contiguous(), z_origin=n * s_ - h,
                    global_nz=nz) for s_, m in enumerate(sels)]
        for a, kw, m in zip(oargs, okw, sels):
            got = ok.orient(*a, **kw)
            for f in got._fields:
                assert torch.equal(getattr(got, f), getattr(ref, f)[m]), f
        ms = cuda_ms(torch, lambda: [ok.orient(*a, **kw)
                                     for a, kw in zip(oargs, okw)],
                     inner=KERNEL_INNER)
        pms = cuda_ms(torch, lambda: [ok.orient_plain(*a, **kw)
                                      for a, kw in zip(oargs, okw)], reps=3)
        box, sphere = box_voxels(centers, sd, params.ori_sig_fctr,
                                 params.ori_rad_fctr, plan.units,
                                 plan.octave_dims[0])
        K = cand.level.numel()
        print(f"       orientation on {S} slabs (halo {h}): A, vd, R and "
              f"flags of all {K} candidates bit-equal to the whole launch",
              flush=True)
        s.record("orient_shard", "sift3d_tpu_torch/csrc/ori.cu",
                 "sift3d_tpu/ops/ori_kernel.py:167", 0.0, ms, pms,
                 n_launches("orient"),
                 bound(4 * box + 76 * K, 11 * box + 40 * sphere))
        acc = ref.accepted
        R = ref.R[acc].contiguous()
        dl, dc, dsd = cand.level[acc], centers[acc].contiguous(), \
            sd[acc].contiguous()
        dref = dk.desc_fused(levels, dl, dc, R, dsd, plan.units, params,
                             plan.scales[0][nl])
        hd = desc_halo(plan, 0, params, False)
        dext = z_extend(lslabs, hd)
        owner = torch.clamp(torch.round(dc[:, 2]).long() // n, 0, S - 1)
        dargs = [(dext[s_], dl[owner == s_], dc[owner == s_],
                  R[owner == s_], dsd[owner == s_], plan.units, params,
                  plan.scales[0][nl], False, n * s_ - hd, nz)
                 for s_ in range(S)]
        for s_, a in enumerate(dargs):
            assert torch.equal(dk.desc_fused(*a), dref[owner == s_]), s_
        ms = cuda_ms(torch, lambda: [dk.desc_fused(*a) for a in dargs],
                     inner=KERNEL_INNER)
        pms = cuda_ms(torch, lambda: [dk.desc_fused_plain(*a)
                                      for a in dargs], reps=3)
        extents = dk.window_extents(plan.scales[0][nl], plan.units,
                                    plan.octave_dims[0], params)
        grot, _ = dk.prep_windows(levels, dl, dc.round().long(), dc, R, dsd,
                                  plan.units, extents, params)
        work = float((grot.abs().sum(dim=1) > 0).sum())
        del grot
        dbox, _ = box_voxels(dc, dsd, params.desc_sig_fctr,
                             params.desc_rad_fctr, plan.units,
                             plan.octave_dims[0])
        print(f"       descriptors on {S} slabs (halo {hd}): all "
              f"{dl.numel()} histograms bit-equal to the whole launch",
              flush=True)
        s.record("desc_fused_shard", "sift3d_tpu_torch/csrc/desc.cu",
                 "sift3d_tpu/ops/desc_kernel.py:304", 0.0, ms, pms,
                 n_launches("desc_fused"), bound(4 * dbox + 4 * dref.numel(),
                                    DESC_OPS_PER_VOXEL * work))

        # Slab 1's own rows without the windows' halo: the kernels read
        # nothing outside a slab; the keypoints whose windows leave it read
        # NaN (orientation: A, vd, R, and no flag set), the others keep
        # their bits.
        o1 = ok.orient(lslabs[1], *oargs[1][1:], **dict(okw[1], z_origin=n))
        out = torch.isnan(o1.R).reshape(-1, 9).any(dim=1)
        keep = ~out
        assert bool(out.any()) and not bool(o1.accepted[out].any())
        assert torch.equal(o1.R[keep], ref.R[sels[1]][keep])
        d1 = dk.desc_fused(lslabs[1], *dargs[1][1:9], n, nz)
        dout = torch.isnan(d1).reshape(d1.shape[0], -1)
        assert bool(dout.all(dim=1).any())
        assert torch.equal(d1[~dout.any(dim=1)],
                           dref[owner == 1][~dout.any(dim=1)])
        print(f"       slab 1 without the windows' halo: {int(out.sum())} of "
              f"{out.numel()} orientations and {int(dout.all(dim=1).sum())} "
              f"of {d1.shape[0]} descriptors read NaN, the rest bit-equal",
              flush=True)

    def same_bits(a, b):
        """Two runs' (keypoints, descriptors, funnel) equal bit for bit."""
        (ka, da, fa), (kb, db, fb) = a, b
        for f in ("coords", "octave", "level", "sd", "strength", "R"):
            assert np.array_equal(getattr(ka, f), getattr(kb, f)), f
        for f in ("data", "xyz", "sd"):
            assert np.array_equal(getattr(da, f), getattr(db, f)), f
        assert fa == fb

    def check_funnel(cell, det, kp, gold):
        """The detector's funnel against JAX's, count for count and in
        JAX's order; survivors sum to the keypoint count."""
        ref = gold[cell]
        _, size, units, _, ext = CELLS[cell]
        assert (ref["size"], tuple(ref["units"]), ref["extensions"]) == \
            (size, units, ext), ref
        want = {(o, lv): f for o, lv, f in ref["funnel"]}
        assert list(det._funnel) == list(want), (det._funnel, want)
        assert det._funnel == want, (det._funnel, want)
        surv = sum(f["survivors"] for f in det._funnel.values())
        assert surv == len(kp) == ref["num_keypoints"], \
            (surv, len(kp), ref["num_keypoints"])
        tot = {k: sum(f[k] for f in det._funnel.values())
               for k in next(iter(want.values()))}
        print(f"       funnel {cell}: {len(want)} (octave, level) rows equal "
              f"to JAX's; totals {tot}", flush=True)

    def spans_hold_kernels(trace_dir):
        """Both spans are in the trace, and every launch of the five
        kernels lies inside one of them (the host span, or its image on
        the card's timeline)."""
        import re
        files = list(Path(trace_dir).glob("*.pt.trace.json"))
        assert len(files) == 1, files
        events = json.loads(files[0].read_text())["traceEvents"]
        spans = [e for e in events if e.get("name") in ("detect", "describe")
                 and e.get("ph") == "X"]
        names = {e["name"] for e in spans
                 if e.get("cat") == "user_annotation"}
        assert names == {"detect", "describe"}, names
        kernels = [e for e in events if e.get("cat") == "kernel"]
        counts = {}
        for entry, fn in PATH_KERNELS.items():
            pat = re.compile(rf"(?<!\w){fn}(?!\w)")
            mine = [k for k in kernels if pat.search(k["name"])]
            inside = [k for k in mine if any(
                s_["ts"] <= k["ts"]
                and k["ts"] + k["dur"] <= s_["ts"] + s_["dur"]
                for s_ in spans)]
            counts[entry] = (len(inside), len(mine))
            assert mine and len(inside) == len(mine), (entry, counts[entry])
        return counts, files[0].stat().st_size

    def profiling_phase():
        gold = json.loads(FUNNEL_GOLDEN.read_text())
        times = profiling.StageTimes()
        runs = {}
        for cell, (_, _, units, _, ext) in CELLS.items():
            det = st.SIFT3D(st.DetectorParams(**ext), device="cuda")
            vol = st.Volume.from_array(vols[cell], units)
            reset_counters()
            kp = det.detect_keypoints(vol)
            desc = det.extract_descriptors(kp)
            launches = read_counters(det.params, f"outside spans, {cell}")
            check_funnel(cell, det, kp, gold)
            runs[cell] = (kp, desc, dict(det._funnel)), launches
            if cell not in TRACED_CELLS:
                continue
            with tempfile.TemporaryDirectory() as tmp:
                reset_counters()
                res = {}
                with profiling.trace(tmp, det.device):
                    with times.stage("detect", sync=res):
                        res["kp"] = det.detect_keypoints(vol)
                    with times.stage("describe", sync=res):
                        res["desc"] = det.extract_descriptors(res["kp"])
                traced = read_counters(det.params, f"inside spans, {cell}")
                counts, nbytes = spans_hold_kernels(tmp)
            same_bits(runs[cell][0], (res["kp"], res["desc"], det._funnel))
            assert traced == launches, (traced, launches)
            print(f"       {cell} inside spans and a trace ({nbytes} bytes): "
                  f"rows, descriptors and funnel bit-equal to the run "
                  f"outside, launches equal; kernel launches inside a span "
                  f"/ in the trace: {counts}", flush=True)
        print("\n".join("       " + line
                        for line in times.report().splitlines()), flush=True)
        # Every execution knob at a value other than its default.
        cell = "sparse256"
        det = st.SIFT3D(st.DetectorParams(**ALL_KNOBS), device="cuda")
        reset_counters()
        kp = det.detect_keypoints(st.Volume.from_array(vols[cell],
                                                       CELLS[cell][2]))
        desc = det.extract_descriptors(kp)
        launches = read_counters(det.params, f"every knob, {cell}")
        same_bits(runs[cell][0], (kp, desc, det._funnel))
        assert launches == runs[cell][1], (launches, runs[cell][1])
        print(f"       {cell} with every knob off its default ({ALL_KNOBS}): "
              f"bit-equal to the default run, same launches", flush=True)

    def sharded_path(cell):
        """ShardedSIFT3D on SHARDS shards of the card: the cell's golden at
        its bars (check_golden) and the single-device port's rows and
        descriptors bit for bit, every shard launching the kernels."""
        _, size, units, reps, ext = CELLS[cell]
        p = st.DetectorParams(**ext)
        vol = st.Volume.from_array(vols[cell], units)
        det = ShardedSIFT3D(p, mesh=make_mesh({"z": SHARDS},
                                              [dev] * SHARDS))
        reset_counters()
        kp = det.detect_keypoints(vol)
        desc = det.extract_descriptors(kp)
        launches = read_counters(p, f"ShardedSIFT3D, {cell}")
        check_launches(det, launches)
        if cell == "sparse256":
            for name, k in launches.items():
                row = f"{name}_shard"
                s.kernels.setdefault(row, {"name": row})["launches"] = k
        kp1, desc1 = st_[f"{cell}_result"]
        for f in ("coords", "octave", "level", "sd", "strength", "R"):
            assert np.array_equal(getattr(kp, f), getattr(kp1, f)), f
        assert np.array_equal(desc.data, desc1.data)
        assert np.array_equal(desc.xyz, desc1.xyz)
        print(f"       {cell} on {SHARDS} shards (octaves sharded "
              f"{det._shard_flags}): {len(kp)} keypoint rows and "
              f"descriptors bit-equal to the single-device port", flush=True)
        check_golden(cell, p, kp, desc)
        walls = []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k = det.detect_keypoints(vol)
            det.extract_descriptors(k)
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
        print(f"       ShardedSIFT3D detect + describe {cell} on {SHARDS} "
              f"shards of one card: median {statistics.median(walls):.2f} ms "
              f"wall over {reps} runs (min {min(walls):.2f}, max "
              f"{max(walls):.2f}); single-device "
              f"{st_[f'{cell}_wall']:.2f} ms; on {card}", flush=True)

    def check_launches(det, launches):
        """Every shard of a sharded octave launched the blur kernels once
        per level and the extrema kernel at least once."""
        L = plan.num_gpyr_levels
        levels = sum((L if o == 0 else L - 1) * len(sl)
                     for o, sl in enumerate(det._octaves))
        assert launches["blur_x"] == launches["blur_yz_dog"] == levels, \
            (launches, levels)
        assert launches["extrema_candidates"] >= sum(
            len(sl) for sl in det._octaves)

    def sharded512_phase():
        """The full-width case the sharding serves: the sparse bench
        phantom at 512^3 through ShardedSIFT3D (SHARDS shards on one card)
        and SIFT3D, bit for bit; walls and memory."""
        vol = st.Volume.from_array(bench_volume("sparse", 512, dev),
                                   device=dev)
        p = st.DetectorParams()
        one = st.SIFT3D(p, device=dev)
        det = ShardedSIFT3D(p, mesh=make_mesh({"z": SHARDS},
                                              [dev] * SHARDS))
        res, walls, peaks = {}, {}, {}
        for name, d in (("single", one), ("sharded", det)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counters()
            t0 = time.perf_counter()
            kp = d.detect_keypoints(vol)
            ds = d.extract_descriptors(kp)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            launches = read_counters(p, f"512^3 sparse, {name}")
            if name == "sharded":
                check_launches(det, launches)
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            res[name] = (kp, ds)
            w = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                d.extract_descriptors(d.detect_keypoints(vol))
                torch.cuda.synchronize()
                w.append((time.perf_counter() - t0) * 1e3)
            walls[name] = (first, w)
        (k1, d1), (k2, d2) = res["single"], res["sharded"]
        for f in ("coords", "octave", "level", "sd", "strength", "R"):
            assert np.array_equal(getattr(k1, f), getattr(k2, f)), f
        assert np.array_equal(d1.data, d2.data)
        assert np.array_equal(d1.xyz, d2.xyz)
        assert len(k1) > 0 and np.all(np.isfinite(d1.data))
        held = []
        for s_ in range(SHARDS):
            b = 0
            for sl in det._octaves:
                if len(sl) > 1:
                    b += sl[s_].gpyr.numel() * 4
                elif s_ == 0:
                    b += sl[0].gpyr.numel() * 4
            held.append(b / 2 ** 20)
        print(f"       512^3 sparse: {len(k1)} keypoints, rows and "
              f"descriptors of {SHARDS} shards bit-equal to one device "
              f"(octaves sharded {det._shard_flags})", flush=True)
        for name in ("single", "sharded"):
            first, w = walls[name]
            print(f"       512^3 {name}: first call {first:.2f} ms, then "
                  f"{[round(v, 2) for v in w]} ms wall; peak memory "
                  f"{peaks[name]:.1f} MiB above what was held", flush=True)
        print(f"       512^3 sharded: pyramid held per shard after detection "
              f"{[round(v, 1) for v in held]} MiB; on {card}", flush=True)
        del res, one, det

    def mesh_batch_phase():
        """batch256x4 with its eight volumes over a 'b' mesh axis of SHARDS
        entries on one card: the unsharded run's keypoints, descriptors,
        matches, inliers and affines; JAX's inliers on JAX's hypotheses."""
        fixed_b, moving_b, As, g = st_["batch"]
        P = len(As)
        p = st.DetectorParams()
        mesh = make_mesh({"b": SHARDS}, [dev] * SHARDS)
        ref = st.register_batch(fixed_b, moving_b, num_iter=500,
                                det=st.SIFT3D(p, device="cuda"))
        reset_counters()
        got = st.register_batch(fixed_b, moving_b, num_iter=500, mesh=mesh)
        read_counters(p, "batch256x4 register_batch over a b mesh")
        for r, m in zip(ref, got):
            assert r.num_matches == m.num_matches
            assert r.num_inliers == m.num_inliers
            assert np.array_equal(r.affine, m.affine)
            assert np.array_equal(r.inlier_mask, m.inlier_mask)
        det = MeshBatchSIFT3D(p, mesh)
        vols_b = torch.cat([fixed_b, moving_b])
        kps = det.detect_keypoints_batch(vols_b)
        dss = det.extract_descriptors_batch(kps)
        for a, b_ in zip(kps, st_["batch_kps"]):
            for f in ("coords", "octave", "level", "sd", "strength", "R"):
                assert np.array_equal(getattr(a, f), getattr(b_, f)), f
        jax_idx = {int(g[f"matches{b}"]): g[f"idx{b}"].astype(np.int64)
                   for b in range(P)}
        fed = registration._register_pairs(
            dss[P:], kps[P:], dss[:P], kps[:P], 0.8, 5.0, 500, 0, dev,
            sample=lambda gen, num_iter, m: torch.from_numpy(jax_idx[m]))
        for b, f in enumerate(fed):
            assert f.num_matches == int(g[f"matches{b}"])
            assert f.num_inliers == int(g[f"inliers{b}"])
            assert corner_error(f.affine, g[f"affine{b}"], int(g["size"])) \
                <= 0.25
        walls = {}
        for name, kw in (("unsharded", dict(det=st.SIFT3D(p, device="cuda"))),
                         ("mesh", dict(mesh=mesh))):
            w = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st.register_batch(fixed_b, moving_b, num_iter=500, **kw)
                torch.cuda.synchronize()
                w.append((time.perf_counter() - t0) * 1e3)
            walls[name] = statistics.median(w)
        print(f"       batch256x4 over a b mesh of {SHARDS} on one card: "
              f"matches, inliers and affines equal to the unsharded run; "
              f"on JAX's hypotheses JAX's inliers "
              f"{[f.num_inliers for f in fed]}; median wall unsharded "
              f"{walls['unsharded']:.2f} ms ({P / walls['unsharded'] * 1e3:.3f}"
              f" pairs/s), mesh {walls['mesh']:.2f} ms "
              f"({P / walls['mesh'] * 1e3:.3f} pairs/s) on {card}",
              flush=True)

    def pair_phase():
        """The 192^3 pair of tools/bench_registration.py make_pair, built on
        the card: the sparse bench phantom and its copy warped by the
        inverse of a rotation about z and a shift (default_rng(3))."""
        g = np.load(REG_GOLDEN)
        n = int(g["size"])
        fixed = st.Volume.from_array(bench_volume("sparse", n, dev),
                                     device=dev)
        moving, A = make_pair_on_card(n, np.random.default_rng(3), fixed)
        assert np.array_equal(A, g["A_true"])
        check_moving(moving, g["moving_sample"], int(g["moving_stride"]),
                     f"warped {n}^3 moving volume")
        st_["pair"] = (fixed, moving, A, g)

    def register_phase(cfg):
        """register of the pair (its wall the register yardstick), then
        register_batch of the pair as a batch of one; both against the
        JAX golden."""
        fixed, moving, A_true, g = st_["pair"]
        n = int(g["size"])
        p = st.DetectorParams(**REG_CONFIGS[cfg])
        det = st.SIFT3D(p, device="cuda")

        def run_register():
            return st.register(fixed, moving, num_iter=500, detectors=det,
                               device="cuda")

        def run_batch():
            return st.register_batch(fixed.data[None], moving.data[None],
                                     num_iter=500, det=det)[0]
        for what, run in (("register", run_register),
                          ("register_batch of one pair", run_batch)):
            reset_counters()
            res = run()
            read_counters(p, f"{what}, {cfg}")
            err = corner_error(res.affine, A_true, n)
            jerr = float(g[f"{cfg}_err"])
            vs_jax = corner_error(res.affine, g[f"{cfg}_affine"], n)
            print(f"       {what}, {n}^3 {cfg}: matches {res.num_matches} "
                  f"(JAX {int(g[f'{cfg}_matches'])}), inliers "
                  f"{res.num_inliers} (JAX {int(g[f'{cfg}_inliers'])}); "
                  f"corner error vs truth {err:.4f} vox (JAX {jerr:.4f}), "
                  f"vs JAX's affine {vs_jax:.4f} vox", flush=True)
            assert np.all(np.isfinite(res.affine))
            assert res.inlier_mask.shape == (res.num_matches,)
            if cfg == "default":
                assert err <= jerr + 0.25
            else:
                assert err < 1.0 and vs_jax <= 0.25
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            print(f"       {what}, {n}^3 pair ({cfg}): median "
                  f"{statistics.median(walls):.2f} ms wall over 3 runs (min "
                  f"{min(walls):.2f}, max {max(walls):.2f}) on {card}",
                  flush=True)

    t_start = time.perf_counter()
    s.phase("blur x and y/z + DoG kernels vs plain, six levels "
            "(bit-exact)", blur_phase)
    s.phase("extrema candidates vs plain route (identical)", extrema_phase)
    s.phase("orientation kernel vs plain (predicates identical, rel 1e-5)",
            ori_phase)
    s.phase("orientation kernel at fractional centers vs plain "
            "(predicates identical, rel 1e-5)", ori_frac_phase)
    s.phase("eigh3x3 kernel vs plain (bit-identical)", eigh_phase)
    s.phase("descriptor kernel vs plain (rel-L2 1e-5)", desc_phase)
    s.phase("descriptor kernel at fractional centers vs plain "
            "(rel-L2 1e-5)", desc_frac_phase)
    s.phase(f"the four kernels on {SHARDS} haloed z-slabs of octave 0 vs one "
            f"whole-volume launch (bit-equal)", slab_phase)
    for cell in CELLS:
        s.phase(f"main path: detect + describe, {cell}, vs JAX golden",
                lambda cell=cell: main_path(cell))
    s.phase("profiling and funnel on the main path: spans around the five "
            "kernels, funnels vs JAX golden, every knob bit-equal",
            profiling_phase)
    for cell in SHARDED_CELLS:
        s.phase(f"ShardedSIFT3D on {SHARDS} shards, {cell}, vs JAX golden "
                f"and the single-device port (bit-equal)",
                lambda cell=cell: sharded_path(cell))
    s.phase(f"ShardedSIFT3D on {SHARDS} shards, 512^3 sparse, vs the "
            f"single-device port (bit-equal)", sharded512_phase)
    torch.cuda.empty_cache()
    s.phase("registration pair, 192^3, warped on the card vs JAX golden",
            pair_phase)
    for cfg in REG_CONFIGS:
        s.phase(f"registration, 192^3, register and register_batch of one "
                f"pair, {cfg} params, vs JAX golden",
                lambda cfg=cfg: register_phase(cfg))
    # The batch phases last: their multi-GiB buffers stay in the caching
    # allocator and would change the single-volume phases' walls.
    s.phase(f"batched kernels, {len(BATCH_PHANTOMS)} 256^3 phantoms, vs "
            f"per-volume plain versions", batch_kernel_phase)
    torch.cuda.empty_cache()
    s.phase("batch256x4 pairs, warped on the card vs JAX golden",
            batch_pairs_phase)
    s.phase("batch256x4: register_batch of four 256^3 pairs vs per-volume "
            "runs and JAX golden", batch_register_phase)
    s.phase(f"batch256x4 over a b mesh of {SHARDS} on one card vs the "
            f"unsharded run and JAX golden", mesh_batch_phase)
    s.phase("batch loader on the card: NIfTI -> detect_keypoints_batch",
            loader_phase)
    print(f"all phases {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": list(s.kernels.values())}), flush=True)
    if s.failures:
        die(f"failed phases: {s.failures}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (sift3d_tpu_torch) on one GPU.

Builds the port's CUDA kernels from the checkout (nvcc, sm_90a), holds each
kernel against its plain PyTorch version at the 256^3 octave-0 shapes of
the main path (the orientation kernel's eigensolver bit for bit, alone),
then runs the main path — SIFT3D(device="cuda"), detect_keypoints +
extract_descriptors — on the 256^3 sparse and dense bench phantoms, checks
that every kernel of the path launched in each run, and holds each result
against its JAX golden file (tests/data/torch_golden_{sparse,dense}256.npz)
to the reference bars (identical keypoint rows, stale strength within
1.2e-7 relative, R within 1e-5, every descriptor within 1% relative L2).

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
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDENS = {cell: ROOT / "tests" / "data" / f"torch_golden_{cell}256.npz"
           for cell in ("sparse", "dense")}
SIZE = 256
REPS = 7
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations a voxel of the descriptor's sphere-and-cube takes: the
# gradient, weight, two 3x3 rotations, the 20-face test (~15 operations a
# face) and 24 weighted adds.
DESC_OPS_PER_VOXEL = 400


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


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median device time of fn in ms (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    needed = [ROOT / "sift3d_tpu_torch", *GOLDENS.values()]
    missing = [str(p.relative_to(ROOT)) for p in needed if not p.exists()]
    if missing:
        die(f"run from a checkout of the repository (missing {missing})")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    import sift3d_tpu_torch as st
    import torch.nn.functional as F

    import bench
    from sift3d_tpu_torch.detect import detect_extrema_octave
    from sift3d_tpu_torch.ops import _build
    from sift3d_tpu_torch.ops import blur_kernel as bk
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    from sift3d_tpu_torch.ops import ori_kernel as ok
    from sift3d_tpu_torch.phantoms import bench_volume
    from sift3d_tpu_torch.pyramid import (build_gpyr_and_dog, make_plan,
                                          scale_to_unit)
    assert "jax" not in sys.modules
    torch.backends.cudnn.allow_tf32 = False   # the conv3d yardstick

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.lib()
    print(f"kernel build {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s) -> {_build.BUILD_DIR}",
          flush=True)

    dev = torch.device("cuda")
    params = st.DetectorParams()
    # The bench phantoms, made on the card; bit-identical to bench.py's
    # (checked here at a small size).
    for cell, make in (("sparse", bench.make_bench_volume),
                       ("dense", bench.make_dense_volume)):
        small = bench_volume(cell, 40, dev).cpu().numpy()
        if not np.array_equal(small, make(40)):
            die(f"bench_volume({cell!r}) differs from bench.py")
    vols = {cell: bench_volume(cell, SIZE, dev).cpu().numpy()
            for cell in GOLDENS}
    vol_np = vols["sparse"]
    plan = make_plan(vol_np.shape, (1.0, 1.0, 1.0), params)
    x = scale_to_unit(torch.from_numpy(vol_np).to(dev))
    s = Smoke()
    nl = params.num_kp_levels
    st_ = {}   # octave-0 state shared by the kernel phases

    def blur_phase():
        diags = bk._diags(plan, 0, 1, dev)
        outs = [torch.empty_like(x) for _ in range(3)]
        err, lib_err = 0.0, 0.0
        convs = []
        for axis, (wd, lo) in enumerate(diags):
            got = bk.axis_pass(x, wd, lo, axis, outs[axis])
            ref = bk.axis_pass_plain(x, wd, lo, axis)
            assert torch.equal(got, ref), f"axis {axis} not bit-exact"
            err = max(err, float((got - ref).abs().max()))
            # The library yardstick: F.conv3d with the band as a (B,1,1)
            # filter along the axis. It computes the same function on the
            # rows whose band is the interior one (conv_diagonals changes
            # the weights near the clipped edges).
            n, band = x.shape[axis], wd.shape[1]
            ksize, pad = [1, 1, 1], [0, 0, 0]
            ksize[axis], pad[axis] = band, -lo
            w = wd[n // 2].reshape(1, 1, *ksize).contiguous()
            convs.append((w, tuple(pad)))
            # (padding is symmetric: the row past the end is dropped)
            lib = F.conv3d(x[None, None], w, padding=tuple(pad))[0, 0] \
                .narrow(axis, 0, n)
            rows = torch.nonzero((wd == wd[n // 2]).all(dim=1))[:, 0]
            diff = (lib - got).abs().index_select(axis, rows)
            lib_err = max(lib_err, float(diff.max()))
        print(f"       conv3d vs axis pass away from the clipped edges: "
              f"max abs diff {lib_err:.3g}", flush=True)
        assert lib_err <= 1e-6
        tmp = (torch.empty_like(x), torch.empty_like(x))
        out = torch.empty_like(x)

        def plain_blur():
            v = x
            for axis, (wd, lo) in enumerate(diags):
                v = bk.axis_pass_plain(v, wd, lo, axis)
            return v

        def library_blur():
            v = x[None, None]
            for axis, (w, pad) in enumerate(convs):
                v = F.conv3d(v, w, padding=pad).narrow(2 + axis, 0,
                                                       x.shape[axis])
            return v
        # Per pass: the mean of the x, y and z passes of one level.
        ms = cuda_ms(torch, lambda: bk.blur(x, diags, out, tmp)) / 3
        pms = cuda_ms(torch, plain_blur) / 3
        lms = cuda_ms(torch, library_blur) / 3
        taps = sum(wd.shape[1] for wd, _ in diags) / 3
        s.record("blur_axis_pass", "sift3d_tpu_torch/csrc/blur.cu",
                 "sift3d_tpu/ops/blur_kernel.py:337", err, ms, pms,
                 bk.axis_pass_launches,
                 bound(8 * x.numel(), 2 * taps * x.numel()), lms)

    def dog_phase():
        gpyr, dogs, dmax = build_gpyr_and_dog(x, plan)
        st_.update(gpyr=gpyr[0], dog=dogs[0], dogmax=dmax[0])
        prev, cur = gpyr[0][0], gpyr[0][1]
        dog = torch.empty_like(prev)
        dm = torch.zeros(1, device=dev)
        bk.dog_max(prev, cur, dog, dm)
        ref, rm = bk.dog_max_plain(prev, cur)
        assert torch.equal(dog, ref) and torch.equal(dm[0], rm)

        def run():
            dm.zero_()
            bk.dog_max(prev, cur, dog, dm)
        ms = cuda_ms(torch, run)
        pms = cuda_ms(torch, lambda: bk.dog_max_plain(prev, cur))
        s.record("blur_dog_max", "sift3d_tpu_torch/csrc/blur.cu",
                 "sift3d_tpu/ops/blur_kernel.py:337",
                 float((dog - ref).abs().max()), ms, pms, bk.dog_launches,
                 bound(12 * prev.numel(), 2 * prev.numel()))

    def extrema_phase():
        dog = st_["dog"]
        thr = (torch.tensor(params.peak_thresh, device=dev)
               * st_["dogmax"][1:1 + nl]).contiguous()
        for cuboid in (False, True):
            got = ek.extrema_mask(dog, thr, cuboid)
            ref = ek.extrema_mask_plain(dog, thr, cuboid)
            assert torch.equal(got, ref), f"cuboid={cuboid} mask differs"
        ms = cuda_ms(torch, lambda: ek.extrema_mask(dog, thr))
        pms = cuda_ms(torch, lambda: ek.extrema_mask_plain(dog, thr))
        vox = dog[0].numel()
        s.record("extrema_mask", "sift3d_tpu_torch/csrc/extrema.cu",
                 "sift3d_tpu/ops/extrema_kernel.py:384", 0.0, ms, pms,
                 ek.launches, bound(4 * dog.numel() + nl * vox,
                                    18 * nl * vox))

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

    def ori_phase():
        cand = detect_extrema_octave(st_["dog"], st_["dogmax"], params)
        scales = torch.tensor(plan.scales[0][1:1 + nl], device=dev)
        levels = st_["gpyr"][1:1 + nl]
        sd = scales[cand.level].contiguous()
        args = (levels, cand.level, cand.coords, sd, plan.units, params)
        got = ok.orient(*args)
        ref = ok.orient_plain(*args)
        K = ref.A.shape[0]
        for a, b in ((got.A, ref.A), (got.vd, ref.vd)):
            err = (a - b).abs().reshape(K, -1).amax(1)
            scale = b.abs().reshape(K, -1).amax(1)
            assert bool((err <= 1e-5 * scale).all()), \
                float((err / scale).max())
        for name in ("accepted", "reject_grad", "reject_ratio",
                     "reject_corner"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        acc = ref.accepted
        rerr = float((got.R[acc] - ref.R[acc]).abs().max())
        assert rerr <= 1e-5, rerr
        print(f"       orient: K={K} candidates, {int(acc.sum())} accepted "
              f"(predicates identical), R max err {rerr:.3g}", flush=True)
        ms = cuda_ms(torch, lambda: ok.orient(*args))
        pms = cuda_ms(torch, lambda: ok.orient_plain(*args))
        box, sphere = box_voxels(cand.coords, sd, params.ori_sig_fctr,
                                 params.ori_rad_fctr, plan.units,
                                 plan.octave_dims[0])
        # reads: each box voxel once (4 B); ops: the sphere test on every
        # box voxel, gradient + weight + 9 sums on the sphere's.
        s.record("orient", "sift3d_tpu_torch/csrc/ori.cu",
                 "sift3d_tpu/ops/ori_kernel.py:167",
                 max(float((got.A - ref.A).abs().max()),
                     float((got.vd - ref.vd).abs().max()), rerr), ms, pms,
                 ok.launches, bound(4 * box + 76 * K, 11 * box + 40 * sphere))
        st_.update(lvl=cand.level[acc], coords=cand.coords[acc],
                   R=got.R[acc].contiguous(), sd=sd[acc].contiguous(),
                   A=got.A.contiguous())

    def eigh_phase():
        g = np.random.default_rng(8)
        M = g.normal(size=(4096, 3, 3)).astype(np.float32)
        special = np.stack([np.eye(3), np.diag([1.0, 1.0, 2.0]),
                            np.zeros((3, 3)), np.full((3, 3), np.nan),
                            np.diag([np.inf, 1.0, 2.0])]).astype(np.float32)
        A = torch.cat([st_["A"], torch.from_numpy(np.concatenate(
            [np.einsum("kij,klj->kil", M, M), special])).to(dev)])
        n0 = ok.eigh_launches
        w, V = ok.eigh3x3(A)
        assert ok.eigh_launches == n0 + 1
        wr, Vr = ok.eigh3x3_plain(A)

        def bits_equal(a, b):
            same = a.view(torch.int32) == b.view(torch.int32)
            return bool((same | (torch.isnan(a) & torch.isnan(b))).all())
        assert bits_equal(w, wr) and bits_equal(V, Vr)
        print(f"       s3d_eigh3x3 bit-identical to eigh3x3_plain on "
              f"{A.shape[0]} matrices ({st_['A'].shape[0]} of the octave's "
              f"moments, degenerate, zero, NaN and inf included)",
              flush=True)

    def desc_phase():
        levels = st_["gpyr"][1:1 + nl]
        centers = st_["coords"].float()
        args = (levels, st_["lvl"], centers, st_["R"], st_["sd"],
                plan.units, params, plan.scales[0][nl])
        ref = dk.desc_fused_plain(*args)
        runs = [dk.desc_fused(*args) for _ in range(3)]
        K = ref.shape[0]
        rn = ref.reshape(K, -1).norm(dim=1)
        rel = [((h - ref).reshape(K, -1).norm(dim=1) / rn) for h in runs]
        spread = max(float(((a - b).reshape(K, -1).norm(dim=1) / rn).max())
                     for a in runs for b in runs)
        extents = dk.window_extents(plan.scales[0][nl], plan.units,
                                    plan.octave_dims[0], params)
        grot, _ = dk.prep_windows(levels, st_["lvl"], st_["coords"],
                                  centers, st_["R"], st_["sd"], plan.units,
                                  extents, params)
        work = float((grot.abs().sum(dim=1) > 0).sum())
        del grot
        box, _ = box_voxels(st_["coords"], st_["sd"], params.desc_sig_fctr,
                            params.desc_rad_fctr, plan.units,
                            plan.octave_dims[0])
        print(f"       desc_fused: K={K} keypoints, {box:.0f} box voxels, "
              f"{work:.0f} in sphere and cube; rel-L2 vs plain per run "
              f"{[float(r.max()) for r in rel]}, spread over 3 runs "
              f"{spread:.3g}", flush=True)
        assert all(bool((r <= 1e-5).all()) for r in rel)
        ms = cuda_ms(torch, lambda: dk.desc_fused(*args))
        pms = cuda_ms(torch, lambda: dk.desc_fused_plain(*args), reps=5)
        s.record("desc_fused", "sift3d_tpu_torch/csrc/desc.cu",
                 "sift3d_tpu/ops/desc_kernel.py:304",
                 max(float((h - ref).abs().max()) for h in runs), ms, pms,
                 dk.launches,
                 bound(4 * box + 4 * ref.numel(), DESC_OPS_PER_VOXEL * work))

    counters = [(bk, "axis_pass_launches", "blur_axis_pass"),
                (bk, "dog_launches", "blur_dog_max"),
                (ek, "launches", "extrema_mask"),
                (ok, "launches", "orient"),
                (dk, "launches", "desc_fused")]

    def main_path(cell, reps):
        g = np.load(GOLDENS[cell])
        assert int(g["size"]) == SIZE
        vol = vols[cell]
        det = st.SIFT3D(params, device="cuda")
        for mod, attr, _ in counters:
            setattr(mod, attr, 0)
        ok.eigh_launches = 0
        kp = det.detect_keypoints(vol)
        desc = det.extract_descriptors(kp)
        torch.cuda.synchronize()
        launches = {name: getattr(mod, attr) for mod, attr, name in counters}
        # The eigensolver runs inside s3d_orient, never on its own.
        assert ok.eigh_launches == 0, ok.eigh_launches
        if cell == "sparse":
            for name, n in launches.items():
                s.kernels.setdefault(name, {"name": name})["launches"] = n
        print(f"       launches on the main path ({cell}): {launches}",
              flush=True)
        missing = [name for name, n in launches.items() if n == 0]
        assert not missing, f"not launched on the main path: {missing}"

        assert len(kp) == len(g["coords"]), (len(kp), len(g["coords"]))
        for f in ("coords", "octave", "level", "sd"):
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
              f"identical, strength max rel {srel:.3g}, R max err "
              f"{rerr:.3g} ({len(off)} rows held to R64 instead; port vs "
              f"R64 on all rows {float(rows64.max()):.3g}), "
              f"descriptors within 1%: {within:.1%} (max rel-L2 "
              f"{float(derr.max()):.3g})", flush=True)
        assert srel <= 1.2e-7 and rerr <= 1e-5 and within == 1.0
        assert np.array_equal(desc.xyz, g["desc_xyz"])
        assert np.all(np.isfinite(desc.data))

        walls = []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k = det.detect_keypoints(vol)
            det.extract_descriptors(k)
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
        print(f"       detect + describe {SIZE}^3 {cell}, {len(kp)} "
              f"keypoints: median {statistics.median(walls):.2f} ms wall "
              f"over {reps} runs (min {min(walls):.2f}, max "
              f"{max(walls):.2f}) on {card}", flush=True)

    s.phase("blur axis pass vs plain (bit-exact)", blur_phase)
    s.phase("blur dog + max|DoG| vs plain (bit-exact)", dog_phase)
    s.phase("extrema mask vs plain (identical)", extrema_phase)
    s.phase("orientation kernel vs plain (predicates identical, rel 1e-5)",
            ori_phase)
    s.phase("eigh3x3 kernel vs plain (bit-identical)", eigh_phase)
    s.phase("descriptor kernel vs plain (rel-L2 1e-5)", desc_phase)
    s.phase("main path: detect + describe, sparse, vs JAX golden",
            lambda: main_path("sparse", REPS))
    s.phase("main path: detect + describe, dense, vs JAX golden",
            lambda: main_path("dense", 3))

    print(json.dumps({"kernels": list(s.kernels.values())}), flush=True)
    if s.failures:
        die(f"failed phases: {s.failures}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (sift3d_tpu_torch) on one GPU.

Builds the port's CUDA kernels from the checkout (nvcc, sm_90a), holds each
kernel against its plain PyTorch version at the 256^3 octave-0 shapes of
the main path, then runs the main path — SIFT3D(device="cuda"),
detect_keypoints + extract_descriptors on the 256^3 sparse bench phantom —
checks that every kernel of the path launched, and holds the result
against the JAX golden file tests/data/torch_golden_sparse256.npz to the
reference bars (identical keypoint rows, stale strength within 1.2e-7
relative, R within 1e-5, every descriptor within 1% relative L2).

Prints the card (nvidia-smi name, power limit), versions and build time,
one line per phase, a JSON line of per-kernel results, and as the last
line {"ok": true, "device": {...}}. Exits non-zero, without that line,
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
GOLDEN = ROOT / "tests" / "data" / "torch_golden_sparse256.npz"
SIZE = 256
REPS = 7


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

    def record(self, name, source, replaces, err, ms, plain_ms, counter):
        """Keep a kernel's phase result; `counter` is its launch counter
        so far (the main path resets it before its own run)."""
        self.kernels[name] = dict(name=name, route="cuda", source=source,
                                  replaces=replaces, launches=0,
                                  max_abs_err=float(err), ms=float(ms),
                                  plain_ms=float(plain_ms))
        print(f"       {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"max |kernel - plain| {float(err):.3g}, "
              f"launch counter {counter}", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        die("PyTorch is not installed")
    if not torch.cuda.is_available():
        die("no CUDA device: this smoke test runs the port on a GPU")
    if not (ROOT / "sift3d_tpu_torch").is_dir() or not GOLDEN.is_file():
        die(f"run from a checkout of the repository (missing "
            f"sift3d_tpu_torch/ or {GOLDEN.relative_to(ROOT)})")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    import sift3d_tpu_torch as st
    from bench import make_bench_volume
    from sift3d_tpu_torch.descriptor import level_radius, prep_windows
    from sift3d_tpu_torch.detect import detect_extrema_octave
    from sift3d_tpu_torch.ops import _build
    from sift3d_tpu_torch.ops import blur_kernel as bk
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    from sift3d_tpu_torch.ops import ori_kernel as ok
    from sift3d_tpu_torch.orientation import assign_orientations
    from sift3d_tpu_torch.pyramid import (build_gpyr_and_dog, make_plan,
                                          scale_to_unit)
    from sift3d_tpu_torch.windows import window_extent
    assert "jax" not in sys.modules

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
    vol_np = make_bench_volume(SIZE)
    plan = make_plan(vol_np.shape, (1.0, 1.0, 1.0), params)
    x = scale_to_unit(torch.from_numpy(vol_np).to(dev))
    s = Smoke()
    nl = params.num_kp_levels
    st_ = {}   # octave-0 state shared by the kernel phases

    def blur_phase():
        diags = bk._diags(plan, 0, 1, dev)
        outs = [torch.empty_like(x) for _ in range(3)]
        err = 0.0
        for axis, (wd, lo) in enumerate(diags):
            got = bk.axis_pass(x, wd, lo, axis, outs[axis])
            ref = bk.axis_pass_plain(x, wd, lo, axis)
            assert torch.equal(got, ref), f"axis {axis} not bit-exact"
            err = max(err, float((got - ref).abs().max()))
        tmp = (torch.empty_like(x), torch.empty_like(x))
        out = torch.empty_like(x)

        def plain_blur():
            v = x
            for axis, (wd, lo) in enumerate(diags):
                v = bk.axis_pass_plain(v, wd, lo, axis)
            return v
        ms = cuda_ms(torch, lambda: bk.blur(x, diags, out, tmp))
        pms = cuda_ms(torch, plain_blur)
        s.record("blur_axis_pass", "sift3d_tpu_torch/csrc/blur.cu",
                 "sift3d_tpu/ops/blur_kernel.py:337", err, ms, pms,
                 bk.axis_pass_launches)

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
                 float((dog - ref).abs().max()), ms, pms, bk.dog_launches)

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
        s.record("extrema_mask", "sift3d_tpu_torch/csrc/extrema.cu",
                 "sift3d_tpu/ops/extrema_kernel.py:384", 0.0, ms, pms,
                 ek.launches)

    def ori_phase():
        cand = detect_extrema_octave(st_["dog"], st_["dogmax"], params)
        scales = torch.tensor(plan.scales[0][1:1 + nl], device=dev)
        levels = st_["gpyr"][1:1 + nl]
        fp = torch.cat([cand.coords.float(), scales[cand.level][:, None]],
                       dim=1).contiguous()
        args = (levels, cand.level, fp, plan.units, params.ori_sig_fctr,
                params.ori_rad_fctr)
        A, vd = ok.ori_moments(*args)
        Ar, vr = ok.ori_moments_plain(*args)
        for got, ref in ((A, Ar), (vd, vr)):
            K = ref.shape[0]
            err = (got - ref).abs().reshape(K, -1).amax(1)
            scale = ref.abs().reshape(K, -1).amax(1)
            assert bool((err <= 1e-5 * scale).all()), \
                float((err / scale).max())
        print(f"       ori_moments: K={fp.shape[0]} candidates", flush=True)
        ms = cuda_ms(torch, lambda: ok.ori_moments(*args))
        pms = cuda_ms(torch, lambda: ok.ori_moments_plain(*args))
        s.record("ori_moments", "sift3d_tpu_torch/csrc/ori.cu",
                 "sift3d_tpu/ops/ori_kernel.py:167",
                 max(float((A - Ar).abs().max()),
                     float((vd - vr).abs().max())), ms, pms, ok.launches)
        ori = assign_orientations(levels, cand.level, cand.coords,
                                  scales[cand.level], plan.units, params)
        keep = ori.accepted
        st_.update(lvl=cand.level[keep], coords=cand.coords[keep],
                   R=ori.R[keep].contiguous(),
                   sd=scales[cand.level[keep]].contiguous())

    def desc_phase():
        levels = st_["gpyr"][1:1 + nl]
        rad = level_radius(plan.scales[0][nl], params)
        extents = tuple(window_extent(rad, plan.octave_dims[0][a])
                        for a in range(3))
        grot, vbins = prep_windows(levels, st_["lvl"], st_["coords"],
                                   st_["coords"].float(), st_["R"],
                                   st_["sd"], plan.units, extents, params)
        ref = dk.desc_hist_plain(grot, vbins, params.bary_eps)
        runs = [dk.desc_hist(grot, vbins, params.bary_eps) for _ in range(3)]
        K = ref.shape[0]
        rn = ref.reshape(K, -1).norm(dim=1)
        rel = [((h - ref).reshape(K, -1).norm(dim=1) / rn) for h in runs]
        spread = max(float(((a - b).reshape(K, -1).norm(dim=1) / rn).max())
                     for a in runs for b in runs)
        print(f"       desc_hist: K={K} keypoints, N={grot.shape[2]} "
              f"voxels each; rel-L2 vs plain per run "
              f"{[float(r.max()) for r in rel]}, spread over 3 runs "
              f"{spread:.3g}", flush=True)
        assert all(bool((r <= 1e-5).all()) for r in rel)
        ms = cuda_ms(torch, lambda: dk.desc_hist(grot, vbins,
                                                 params.bary_eps))
        pms = cuda_ms(torch, lambda: dk.desc_hist_plain(grot, vbins,
                                                        params.bary_eps),
                      reps=5)
        s.record("desc_hist", "sift3d_tpu_torch/csrc/desc.cu",
                 "sift3d_tpu/ops/desc_kernel.py:304",
                 max(float((h - ref).abs().max()) for h in runs), ms, pms,
                 dk.launches)

    def main_path():
        g = np.load(GOLDEN)
        assert int(g["size"]) == SIZE
        counters = [(bk, "axis_pass_launches", "blur_axis_pass"),
                    (bk, "dog_launches", "blur_dog_max"),
                    (ek, "launches", "extrema_mask"),
                    (ok, "launches", "ori_moments"),
                    (dk, "launches", "desc_hist")]
        for mod, attr, _ in counters:
            setattr(mod, attr, 0)
        det = st.SIFT3D(params, device="cuda")
        kp = det.detect_keypoints(vol_np)
        desc = det.extract_descriptors(kp)
        torch.cuda.synchronize()
        launches = {name: getattr(mod, attr) for mod, attr, name in counters}
        for name, n in launches.items():
            s.kernels.setdefault(name, {"name": name})["launches"] = n
        print(f"       launches on the main path: {launches}", flush=True)
        missing = [name for name, n in launches.items() if n == 0]
        assert not missing, f"not launched on the main path: {missing}"

        assert len(kp) == len(g["coords"]), (len(kp), len(g["coords"]))
        for f in ("coords", "octave", "level", "sd"):
            assert np.array_equal(getattr(kp, f), g[f]), f
        srel = float(np.max(np.abs(kp.strength - g["strength"])
                            / np.abs(g["strength"])))
        rerr = float(np.abs(kp.R - g["R"]).max())
        derr = (np.linalg.norm(desc.data - g["desc"], axis=1)
                / np.linalg.norm(g["desc"], axis=1))
        within = float(np.mean(derr <= 0.01))
        print(f"       vs JAX golden: {len(kp)} keypoint rows identical, "
              f"strength max rel {srel:.3g}, R max err {rerr:.3g}, "
              f"descriptors within 1%: {within:.1%} (max rel-L2 "
              f"{float(derr.max()):.3g})", flush=True)
        assert srel <= 1.2e-7 and rerr <= 1e-5 and within == 1.0
        assert np.array_equal(desc.xyz, g["desc_xyz"])
        assert np.all(np.isfinite(desc.data))

        walls = []
        for i in range(REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k = det.detect_keypoints(vol_np)
            det.extract_descriptors(k)
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
        print(f"       detect + describe {SIZE}^3 sparse, {len(kp)} "
              f"keypoints: median {statistics.median(walls):.2f} ms wall "
              f"over {REPS} runs (min {min(walls):.2f}, max "
              f"{max(walls):.2f}) on {card}", flush=True)

    s.phase("blur axis pass vs plain (bit-exact)", blur_phase)
    s.phase("blur dog + max|DoG| vs plain (bit-exact)", dog_phase)
    s.phase("extrema mask vs plain (identical)", extrema_phase)
    s.phase("orientation moments vs plain (rel 1e-5)", ori_phase)
    s.phase("descriptor histogram vs plain (rel-L2 1e-5)", desc_phase)
    s.phase("main path: detect + describe vs JAX golden", main_path)

    print(json.dumps({"kernels": list(s.kernels.values())}), flush=True)
    if s.failures:
        die(f"failed phases: {s.failures}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time variants of the blur and extrema kernels side by side on one GPU.

A variant is either a tile size the wrappers' pickers could choose (the
x pass's tx, the y/z pass's ty and planes per block xs) or a copy of a
kernel source with one line substituted, built with nvcc into its own
library under build/variants/. Each runs on one volume (a batch of one)
at the 256^3 sparse phantom's
octave-0 shapes (bench.make_bench_volume, built on the card), is checked
against the plain version (the blur bit for bit, the extrema candidates
identical), and is timed with CUDA events over 20 back-to-back launches
(median of 5). The substituted variants:
 - blur_4byte: every cp.async copy moves 4 bytes (the path for rows whose
   length is not a multiple of 4 words);
 - extrema_unroll1 / extrema_unroll8: 1 or 8 values a thread reads before
   testing them, against 4;
 - extrema_chunk1k / extrema_chunk8k: 1024 or 8192 voxels of a plane a
   block, against 2048;
 - desc_hists1 / 2 / 8: 1, 2 or 8 shared-memory histograms a block of the
   descriptor kernel (warp w adds into w mod the count), against 4; timed
   on the dense phantom's octave-0 keypoints, each variant's bits equal
   to the package's kernel (exact integer sums).

Usage: python tools/torch_kernel_variants.py
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OUT = REPO / "build" / "variants"

VEC_X = ("      plane % 4 == 0 && src_bs % 4 == 0 &&\n"
         "          reinterpret_cast<uintptr_t>(src) % 16 == 0);",
         "      false);")
VEC_YZ = ("      nzs % 4 == 0 && src_bs % 4 == 0 &&\n"
          "          reinterpret_cast<uintptr_t>(src) % 16 == 0);",
          "      false);")
UNROLL = "constexpr int kUnroll = 4;"
CHUNK = "constexpr int kChunk = 2048;"
HISTS = "constexpr int kHists = 4;"
VARIANTS = {   # name: (source, substitutions)
    "blur": ("blur.cu", ()),
    "blur_4byte": ("blur.cu", (VEC_X, VEC_YZ)),
    "extrema": ("extrema.cu", ()),
    "extrema_unroll1": ("extrema.cu",
                        ((UNROLL, "constexpr int kUnroll = 1;"),)),
    "extrema_unroll8": ("extrema.cu",
                        ((UNROLL, "constexpr int kUnroll = 8;"),)),
    "extrema_chunk1k": ("extrema.cu",
                        ((CHUNK, "constexpr int kChunk = 1024;"),)),
    "extrema_chunk8k": ("extrema.cu",
                        ((CHUNK, "constexpr int kChunk = 8192;"),)),
    "desc": ("desc.cu", ()),
    "desc_hists1": ("desc.cu", ((HISTS, "constexpr int kHists = 1;"),)),
    "desc_hists2": ("desc.cu", ((HISTS, "constexpr int kHists = 2;"),)),
    "desc_hists8": ("desc.cu", ((HISTS, "constexpr int kHists = 8;"),)),
}


def build(name: str, nvcc_flags) -> ctypes.CDLL:
    from sift3d_tpu_torch.ops import _build
    source, subs = VARIANTS[name]
    text = (_build.CSRC / source).read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in {source}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    subprocess.run([_build._nvcc(), *nvcc_flags, "-shared", "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
    return lib


def cuda_ms(torch, fn, inner: int = 20, reps: int = 5) -> float:
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    import sift3d_tpu_torch as st
    from sift3d_tpu_torch.ops import _build
    from sift3d_tpu_torch.ops import blur_kernel as bk
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    from sift3d_tpu_torch.phantoms import bench_volume
    from sift3d_tpu_torch.pyramid import build_gpyr_and_dog, make_plan, \
        scale_to_unit

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda n: build(n, _build.NVCC_FLAGS), VARIANTS)))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    params = st.DetectorParams()
    x = scale_to_unit(bench_volume("sparse", 256, dev))
    plan = make_plan(x.shape, (1.0, 1.0, 1.0), params)
    gpyr, dogs, dmax = build_gpyr_and_dog(x, plan)
    nx, ny, nz = x.shape
    print(f"256^3 sparse, octave 0, on {card}; ms per launch")
    tmp, cur, dog = (torch.empty_like(x) for _ in range(3))
    dm = torch.zeros(1, device=dev)
    for level in (1, 5):
        src, prev = gpyr[0][level - 1], gpyr[0][level - 1]
        (wx, lox), (wy, loy), (wz, loz) = bk._diags(plan, 0, level, dev)
        bx, by, bz = wx.shape[1], wy.shape[1], wz.shape[1]
        xr = bk.blur_x_plain(src, wx, lox)
        cr, dr, _ = bk.blur_yz_dog_plain(xr, wy, loy, wz, loz, prev)
        print(f"level {level}, bands {bx}/{by}/{bz}:")
        for name in ("blur", "blur_4byte"):
            lib = libs[name]
            for tx in (8, 16, 32):
                smem = bk.x_smem_bytes(tx, bx)

                def run_x():
                    assert lib.s3d_blur_x(
                        src.data_ptr(), tmp.data_ptr(), wx.data_ptr(), bx,
                        lox, 1, 0, 0, nx, ny, nz, tx, smem, stream) == 0
                tmp.zero_()
                run_x()
                assert torch.equal(tmp, xr), (name, tx)
                print(f"  {name} x pass, tx {tx}: {cuda_ms(torch, run_x):.4f}")
            for ty, xs in ((16, 4), (32, 1), (32, 4)):
                smem = bk.yz_smem_bytes(ty, 64, by, bz)

                def run_yz():
                    assert lib.s3d_blur_yz_dog(
                        xr.data_ptr(), prev.data_ptr(), cur.data_ptr(),
                        dog.data_ptr(), dm.data_ptr(), wy.data_ptr(), by, loy,
                        wz.data_ptr(), bz, loz, 1, 0, 0, 0, 0, 0, nx, ny, nz,
                        nz, 0, ty, 64, xs, smem, stream) == 0
                cur.zero_()
                run_yz()
                assert torch.equal(cur, cr) and torch.equal(dog, dr)
                print(f"  {name} y/z + DoG, ty {ty}, xs {xs}: "
                      f"{cuda_ms(torch, run_yz):.4f}")
    d = dogs[0]
    nl = params.num_kp_levels
    thr = (params.peak_thresh * dmax[0][1:1 + nl]).contiguous()
    keys = torch.empty(ek.default_capacity(d.shape), dtype=torch.int64,
                       device=dev)
    counts = torch.zeros(1 + nl, dtype=torch.int64, device=dev)
    for cuboid in (0, 1):
        rk, rc = ek.extrema_candidates_plain(d, thr, bool(cuboid))
        rk = torch.sort(rk).values
        for name in [n for n in VARIANTS if n.startswith("extrema")]:
            lib = libs[name]

            def run_e():
                assert lib.s3d_extrema_candidates(
                    d.data_ptr(), thr.data_ptr(), keys.data_ptr(),
                    counts.data_ptr(), keys.numel(), 1, nl, nx, ny, nz,
                    1, nz - 2, 0, nz, cuboid, stream) == 0
            counts.zero_()
            run_e()
            n = int(counts[0])
            assert torch.equal(torch.sort(keys[:n]).values, rk), name
            assert torch.equal(counts[1:], rc), name
            print(f"  {name}, {'cuboid' if cuboid else 'face'}: "
                  f"{cuda_ms(torch, run_e):.4f} ({n} candidates)")
    print(f"  for scale: torch sum of the DoG levels "
          f"{cuda_ms(torch, lambda: d.sum()):.4f}, copy of one volume "
          f"{cuda_ms(torch, lambda: tmp.copy_(x)):.4f}")
    desc_variants(torch, libs, params, dev, stream, card)
    return 0


def desc_variants(torch, libs, params, dev, stream, card) -> None:
    """The descriptor kernel's variants on the dense phantom's octave-0
    keypoints (those orientation accepts), each against the package's
    wrapper bit for bit."""
    import numpy as np

    from sift3d_tpu_torch.detect import detect_extrema_octave
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.ops import ori_kernel as ok
    from sift3d_tpu_torch.phantoms import bench_volume
    from sift3d_tpu_torch.pyramid import build_gpyr_and_dog, make_plan, \
        scale_to_unit
    x = scale_to_unit(bench_volume("dense", 256, dev))
    plan = make_plan(x.shape, (1.0, 1.0, 1.0), params)
    gpyr, dogs, dmax = build_gpyr_and_dog(x, plan)
    nl = params.num_kp_levels
    cand = detect_extrema_octave(dogs[0], dmax[0], params)
    levels = gpyr[0][1:1 + nl]
    sd = torch.tensor(plan.scales[0][1:1 + nl], device=dev)[cand.level]
    ori = ok.orient(levels, cand.level, cand.coords, sd, plan.units, params)
    acc = ori.accepted
    lvl, centers = cand.level[acc], cand.coords[acc].float().contiguous()
    R, sd = ori.R[acc].contiguous(), sd[acc].contiguous()
    K = lvl.numel()
    sd_max = plan.scales[0][nl]
    ref = dk.desc_fused(levels, lvl, centers, R, sd, plan.units, params,
                        sd_max)
    geom, face_idx = dk._consts(dev)
    box = int(np.prod([e - 2 for e in dk.window_extents(
        sd_max, plan.units, plan.octave_dims[0], params)]))
    splits = max(1, min(-(-dk._MIN_BLOCKS // K),
                        box // dk._VOX_PER_BLOCK_MIN))
    u = [np.float32(v) for v in plan.units]
    scal = [*u, *[np.float32(1.0) / v for v in u], params.desc_sig_fctr,
            params.desc_rad_fctr, dk._SQRT2, params.bary_eps]
    out = torch.empty_like(ref)
    nx, ny, nz = plan.octave_dims[0]
    print(f"256^3 dense, octave 0, {K} keypoints, on {card}; ms per launch")
    for name in [n for n in VARIANTS if n.startswith("desc")]:
        lib = libs[name]
        accb = torch.zeros((K, 768), dtype=torch.int64, device=dev)
        bad = torch.zeros(K, dtype=torch.int32, device=dev)

        def run_d():
            accb.zero_()
            assert lib.s3d_desc_fused(
                levels.data_ptr(), lvl.data_ptr(), centers.data_ptr(),
                R.data_ptr(), sd.data_ptr(), geom.data_ptr(),
                face_idx.data_ptr(), accb.data_ptr(), bad.data_ptr(),
                out.data_ptr(), K, splits, nx, ny, nz, 0, nz,
                *(float(np.float32(v)) for v in scal), stream) == 0
        run_d()
        assert torch.equal(out, ref), name
        print(f"  {name}: {cuda_ms(torch, run_d):.4f}")


if __name__ == "__main__":
    sys.exit(main())

// Icosahedral descriptor histogram, with the window prep fused in.
//
// Replaces sift3d_tpu/ops/desc_kernel.py:304 desc_hist_pallas (TPU
// Pallas) together with the window prep that fed it,
// sift3d_tpu/descriptor.py:216 _prep_window. Python wrapper:
// sift3d_tpu_torch/ops/desc_kernel.py.
//
// Inputs: one octave's levels f32[nl, nx, ny, nzs], per keypoint its
// level, f32 center (integer-valued, or fractional after subvoxel
// refinement), R f32[3, 3] and scale sd. The levels may be a z-slab of a
// volume gnz deep whose slab row 0 sits at global z `z_origin` (a shard's
// rows with their halo, sift3d_tpu/windows.py:27-64 z_view): centers are
// global, the loop bounds clip at [1, gnz - 2], and global row z is slab
// row z - z_origin. The whole volume is z_origin 0, gnz = nzs. Output
// hist f32[K, 16, 48] = [(cz, cy), (cx, v)].
//
// Grid (K, splits): block (k, s) takes slice s of keypoint k's loop-bound
// box (IM_LOOP_SPHERE_START, sift.c:86-109) and reads the level in place.
// Per voxel: the central-difference gradient (IM_GET_GRAD_ISO,
// sift.c:140-145); the sphere test and the 0 <= vb < 4 bin test on
// vb = (R^T d + half_width) * bin_fctr (sift.c:1476-1492); the Gaussian
// weight and grot = R^T (w g); the first icosahedron face, in face order,
// that grot pierces, by the division-free hit test of
// sift3d_tpu/descriptor.py:151-172 (icos_hist_bin, sift.c:1254-1291);
// then |grot| x barycentric x trilinear weights (SIFT3D_desc_acc_interp,
// sift.c:1340-1363), 24 contributions. Every step uses the operations of
// sift3d_tpu_torch/descriptor.py prep_windows in its order, as
// round-to-nearest intrinsics, so that every mask and face decision is the
// plain path's; only the sums differ.
//
// The sums are exact integer sums, so the result does not depend on the
// order of the adds: the same keypoint gives the same bits on every call,
// in any launch, whatever the split, the batch or the shard it comes in.
// Each contribution v (|v| < 2^kExp) is rounded once to a multiple of
// 2^-S, S = 62 - kExp - ceil(log2(box voxels)) per keypoint (a voxel adds
// to a bin at most once, so no sum can pass 2^62), and added as an int64
// into a per-warp histogram in shared memory: its low 32-bit word by a
// 32-bit atomic add, its high word, with the low word's carry, by another
// only where that is not zero (rare: most contributions are small and
// positive). The block's histograms go into acc[k] by global 64-bit
// atomics, and a second kernel converts acc to f32 (through f64, exact
// below 2^53). A contribution at or past 2^kExp, or NaN, marks the
// keypoint, whose histogram then reads NaN: the [-1, 1]-scaled levels of the pipeline give
// |v| <= sqrt(3) / min(units), far below it at any real voxel size.
//
// Bound on the H100: operations (~400 f32 operations a voxel, of which
// the 20-face test is most) and the shared-memory atomics, as neighbouring
// voxels hit neighbouring bins. Neither grot nor the bins reach device
// memory: the only device-memory traffic is the level read (through L1/L2)
// and the histogram. Warps w and w + 4 share a histogram (kHists = 4,
// 24 KB of dynamic shared memory). With 64-bit shared-memory adds the
// kernel took 3.67 ms on the dense phantom's octave 0, with the split
// words 1.67 ms; one to eight histograms a block move it by under 4%
// (tools/torch_kernel_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFaces = 20;
constexpr int kBins = 768;
// Shared-memory histograms per block: warp w adds into number w % kHists.
constexpr int kHists = 4;
// Contributions lie below 2^kExp in magnitude (see the header).
constexpr int kExp = 10;

struct DescParams {
  int nx, ny, nzs, splits, z_origin, gnz;
  float u[3], inv[3];
  float sig_fctr, rad_fctr, sqrt2, eps;
};

// Window scalars of keypoint k in the order of descriptor.py prep_windows,
// and its loop-bound box: origin lo (global) and extent ext per axis.
struct Box {
  float sigma, win_radius, half_width, bin_fctr;
  int lo[3], ext[3];
};

__device__ Box keypoint_box(const float c[3], float sd, const DescParams& P) {
  Box b;
  b.sigma = __fmul_rn(sd, P.sig_fctr);
  b.win_radius = __fmul_rn(b.sigma, P.rad_fctr);
  b.half_width = __fdiv_rn(b.win_radius, P.sqrt2);
  b.bin_fctr =
      __fdiv_rn(1.0f, __fdiv_rn(__fmul_rn(2.0f, b.half_width), 4.0f));
  const int n[3] = {P.nx, P.ny, P.gnz};
  for (int a = 0; a < 3; ++a) {
    const float ra = __fdiv_rn(b.win_radius, P.u[a]);
    const float l = fmaxf(floorf(__fsub_rn(c[a], ra)), 1.0f);
    const float hi = fminf(ceilf(__fadd_rn(c[a], ra)), (float)(n[a] - 2));
    b.lo[a] = (int)l;
    b.ext[a] = max(0, (int)hi - (int)l + 1);
  }
  return b;
}

// S of a box of `total` voxels: 62 - kExp - ceil(log2(total)).
__device__ __forceinline__ int fixed_shift(int total) {
  const int log2_ceil = total > 1 ? 32 - __clz(total - 1) : 0;
  return 62 - kExp - log2_ceil;
}

__device__ __forceinline__ float dot3(float g0, float g1, float g2,
                                      const float* m, int col) {
  // m is MT_MATRIX [3, 60] row-major.
  return __fadd_rn(__fadd_rn(__fmul_rn(g0, m[col]), __fmul_rn(g1, m[60 + col])),
                   __fmul_rn(g2, m[120 + col]));
}

// (a0 * R[0][j] + a1 * R[1][j]) + a2 * R[2][j]: component j of R^T a.
__device__ __forceinline__ float rot_t(float a0, float a1, float a2,
                                       const float* R, int j) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, R[j]), __fmul_rn(a1, R[3 + j])),
                   __fmul_rn(a2, R[6 + j]));
}

__global__ void __launch_bounds__(kThreads)
desc_kernel(const float* __restrict__ levels, const int64_t* __restrict__ lvl,
            const float* __restrict__ centers, const float* __restrict__ Rk,
            const float* __restrict__ sd_in, const float* __restrict__ geom,
            const int* __restrict__ face_idx,
            unsigned long long* __restrict__ acc, int* __restrict__ bad,
            DescParams P) {
  // kHists histograms of kBins int64 sums, each as its low and its high
  // 32-bit words (dynamic shared memory): lo[kHists][kBins], then hi.
  extern __shared__ unsigned int h32[];
  unsigned int* const lo_h = h32;
  unsigned int* const hi_h = h32 + kHists * kBins;
  __shared__ float mt[180];
  __shared__ float kconst[kFaces];
  __shared__ int fidx[3 * kFaces];
  __shared__ float R[9];
  for (int i = threadIdx.x; i < 2 * kHists * kBins; i += blockDim.x) {
    h32[i] = 0u;
  }
  for (int i = threadIdx.x; i < 180; i += blockDim.x) mt[i] = geom[i];
  for (int i = threadIdx.x; i < kFaces; i += blockDim.x) {
    kconst[i] = geom[180 + i];
  }
  for (int i = threadIdx.x; i < 3 * kFaces; i += blockDim.x) {
    fidx[i] = face_idx[i];
  }
  const int64_t k = blockIdx.x;
  if (threadIdx.x < 9) R[threadIdx.x] = Rk[9 * k + threadIdx.x];
  __syncthreads();

  const float c[3] = {centers[3 * k], centers[3 * k + 1], centers[3 * k + 2]};
  const Box box = keypoint_box(c, sd_in[k], P);
  const float sigma = box.sigma, win_radius = box.win_radius;
  const float half_width = box.half_width, bin_fctr = box.bin_fctr;
  const float rad2 = __fmul_rn(win_radius, win_radius);
  const float sig2 = __fmul_rn(sigma, sigma);
  const int lo[3] = {box.lo[0], box.lo[1], box.lo[2]};
  const int ext[3] = {box.ext[0], box.ext[1], box.ext[2]};
  // A box holds at most (n-2)^3 < 2^31 voxels: 32-bit index arithmetic.
  const int total = ext[0] * ext[1] * ext[2];
  if (total > 0 && (lo[2] - 1 < P.z_origin ||
                    lo[2] + ext[2] > P.z_origin + P.nzs - 1)) {
    if (threadIdx.x == 0) bad[k] = 2;   // the box leaves the slab
    return;
  }
  const int chunk = (total + P.splits - 1) / P.splits;
  const int t0 = blockIdx.y * chunk;
  const int t1 = min(total, t0 + chunk);
  const int64_t sx = (int64_t)P.ny * P.nzs, sy = P.nzs;
  const float* level = levels + lvl[k] * P.nx * sx;
  const float eps = P.eps, neg_eps = -P.eps;
  const float scale = ldexpf(1.0f, fixed_shift(total));
  const float limit = ldexpf(1.0f, kExp);
  bool overflow = false;
  const int hoff = ((threadIdx.x >> 5) % kHists) * kBins;
  unsigned int* const lo_w = lo_h + hoff;
  unsigned int* const hi_w = hi_h + hoff;

  for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
    const int z = lo[2] + t % ext[2];
    const int r = t / ext[2];
    const int y = lo[1] + r % ext[1];
    const int x = lo[0] + r / ext[1];
    const float d0 = __fmul_rn(__fsub_rn((float)x, c[0]), P.u[0]);
    const float d1 = __fmul_rn(__fsub_rn((float)y, c[1]), P.u[1]);
    const float d2 = __fmul_rn(__fsub_rn((float)z, c[2]), P.u[2]);
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                               __fmul_rn(d2, d2));
    if (!(sq <= rad2)) continue;
    float vb[3];
    bool inside = true;
    for (int j = 0; j < 3; ++j) {
      vb[j] = __fmul_rn(__fadd_rn(rot_t(d0, d1, d2, R, j), half_width),
                        bin_fctr);
      inside &= vb[j] >= 0.0f && vb[j] < 4.0f;
    }
    if (!inside) continue;

    const float w = expf(__fdiv_rn(__fmul_rn(-0.5f, sq), sig2));
    const float* p = level + x * sx + y * sy + (z - P.z_origin);
    const float wg0 = __fmul_rn(
        w, __fmul_rn(__fmul_rn(0.5f, __fsub_rn(p[sx], p[-sx])), P.inv[0]));
    const float wg1 = __fmul_rn(
        w, __fmul_rn(__fmul_rn(0.5f, __fsub_rn(p[sy], p[-sy])), P.inv[1]));
    const float wg2 = __fmul_rn(
        w, __fmul_rn(__fmul_rn(0.5f, __fsub_rn(p[1], p[-1])), P.inv[2]));
    const float g0 = rot_t(wg0, wg1, wg2, R, 0);
    const float g1 = rot_t(wg0, wg1, wg2, R, 1);
    const float g2 = rot_t(wg0, wg1, wg2, R, 2);

    const float gsq = __fadd_rn(__fadd_rn(__fmul_rn(g0, g0), __fmul_rn(g1, g1)),
                                __fmul_rn(g2, g2));
    if (!(gsq >= eps)) continue;

    int face = -1;
    float det_s = 0.0f, yn_s = 0.0f, zn_s = 0.0f;
    for (int f = 0; f < kFaces; ++f) {
      const float det = dot3(g0, g1, g2, mt, f);
      const float yn = dot3(g0, g1, g2, mt, 20 + f);
      const float zn = dot3(g0, g1, g2, mt, 40 + f);
      const float sgn = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
      const float adet = __fmul_rn(det, sgn);
      const float neg_eps_adet = __fmul_rn(neg_eps, adet);
      const float ysn = __fmul_rn(yn, sgn);
      const float zsn = __fmul_rn(zn, sgn);
      if (adet >= eps && ysn >= neg_eps_adet && zsn >= neg_eps_adet &&
          __fsub_rn(__fsub_rn(adet, ysn), zsn) >= neg_eps_adet &&
          __fmul_rn(kconst[f], sgn) >= 0.0f) {
        face = f;
        det_s = det;
        yn_s = yn;
        zn_s = zn;
        break;
      }
    }
    if (face < 0) continue;

    const float inv = __fdiv_rn(1.0f, det_s);
    const float ys = __fmul_rn(yn_s, inv);
    const float zs = __fmul_rn(zn_s, inv);
    const float xs = __fsub_rn(__fsub_rn(1.0f, ys), zs);
    const float mag = __fsqrt_rn(gsq);
    const float bw[3] = {__fmul_rn(xs, mag), __fmul_rn(ys, mag),
                         __fmul_rn(zs, mag)};

    int base[3];
    float w0[3], w1[3];
    for (int a = 0; a < 3; ++a) {
      const float b = floorf(vb[a]);
      const float fr = __fsub_rn(vb[a], b);
      base[a] = (int)b;
      w0[a] = __fsub_rn(1.0f, fr);
      w1[a] = fr;
    }
    for (int iz = 0; iz < 2; ++iz) {
      const int cz = base[2] + iz;
      if (cz > 3) continue;
      const float wz = iz ? w1[2] : w0[2];
      for (int iy = 0; iy < 2; ++iy) {
        const int cy = base[1] + iy;
        if (cy > 3) continue;
        const float wzy = __fmul_rn(wz, iy ? w1[1] : w0[1]);
        for (int ix = 0; ix < 2; ++ix) {
          const int cx = base[0] + ix;
          if (cx > 3) continue;
          const float wx = ix ? w1[0] : w0[0];
          const int row = (cz * 4 + cy) * 48 + cx * 12;
          for (int j = 0; j < 3; ++j) {
            const float v = __fmul_rn(wzy, __fmul_rn(wx, bw[j]));
            overflow |= !(fabsf(v) < limit);
            // q = hi * 2^32 + lo: the low word by a 32-bit add, whose
            // carry goes to the high word with q's own high part (zero
            // for the small positive q that most adds bring).
            const long long q = __float2ll_rn(__fmul_rn(v, scale));
            const unsigned int lo = static_cast<unsigned int>(q);
            const int bin = row + fidx[3 * face + j];
            const unsigned int old = atomicAdd(lo_w + bin, lo);
            const unsigned int hi = static_cast<unsigned int>(q >> 32) +
                                    (old + lo < old ? 1u : 0u);
            if (hi != 0u) atomicAdd(hi_w + bin, hi);
          }
        }
      }
    }
  }
  if (overflow) bad[k] = 1;
  __syncthreads();
  unsigned long long* out = acc + k * kBins;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    unsigned long long s = 0ull;
    for (int j = 0; j < kHists; ++j) {
      s += (static_cast<unsigned long long>(hi_h[j * kBins + i]) << 32) +
           lo_h[j * kBins + i];
    }
    if (s != 0ull) atomicAdd(out + i, s);
  }
}

// hist[k] = acc[k] * 2^-S (NaN where bad[k]); one block per keypoint.
__global__ void __launch_bounds__(kThreads)
desc_finish_kernel(const float* __restrict__ centers,
                   const float* __restrict__ sd_in,
                   const unsigned long long* __restrict__ acc,
                   const int* __restrict__ bad, float* __restrict__ hist,
                   DescParams P) {
  const int64_t k = blockIdx.x;
  const float c[3] = {centers[3 * k], centers[3 * k + 1], centers[3 * k + 2]};
  const Box box = keypoint_box(c, sd_in[k], P);
  const double unit =
      ldexp(1.0, -fixed_shift(box.ext[0] * box.ext[1] * box.ext[2]));
  const bool nan = bad[k] != 0;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    const long long q = static_cast<long long>(acc[k * kBins + i]);
    hist[k * kBins + i] =
        nan ? __int_as_float(0x7fc00000)
            : __double2float_rn(__dmul_rn(__ll2double_rn(q), unit));
  }
}

}  // namespace

// hist f32[K, 16, 48]; acc u64[K, 768] and bad i32[K] zero on entry.
// levels f32[nl, nx, ny, nzs], its row 0 at global z z_origin of a volume
// gnz deep. bad[k] = 1 where a contribution overflowed, 2 where keypoint
// k's box, with its gradient border, leaves the slab (nothing is read);
// either row reads NaN.
extern "C" int s3d_desc_fused(const float* levels, const int64_t* lvl,
                              const float* centers, const float* R,
                              const float* sd, const float* geom,
                              const int* face_idx, long long* acc, int* bad,
                              float* hist, int K, int splits, int nx, int ny,
                              int nzs, int z_origin, int gnz, float ux,
                              float uy, float uz, float ix, float iy,
                              float iz, float sig_fctr, float rad_fctr,
                              float sqrt2, float eps, void* stream) {
  if (K < 1 || splits < 1 || gnz < 1 || nzs < 1) return cudaErrorInvalidValue;
  const DescParams P{nx, ny, nzs, splits, z_origin, gnz, {ux, uy, uz},
                     {ix, iy, iz}, sig_fctr, rad_fctr, sqrt2, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(K, splits);
  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  const int smem = 2 * kHists * kBins * (int)sizeof(unsigned int);
  if (smem > 40 * 1024) {   // with the static arrays, past the default 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        desc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  desc_kernel<<<grid, kThreads, smem, s>>>(levels, lvl, centers, R, sd, geom,
                                           face_idx, a, bad, P);
  desc_finish_kernel<<<K, kThreads, 0, s>>>(centers, sd, a, bad, hist, P);
  return static_cast<int>(cudaGetLastError());
}

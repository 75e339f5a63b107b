// Icosahedral descriptor histogram, with the window prep fused in.
//
// Replaces sift3d_tpu/ops/desc_kernel.py:304 desc_hist_pallas (TPU
// Pallas) together with the window prep that fed it,
// sift3d_tpu/descriptor.py:216 _prep_window. Python wrapper:
// sift3d_tpu_torch/ops/desc_kernel.py.
//
// Inputs: one octave's levels f32[nl, nx, ny, nz], per keypoint its level,
// f32 center (integer-valued, or fractional after subvoxel refinement),
// R f32[3, 3] and scale sd. Output hist f32[K, 16, 48] (zero on entry) =
// [(cz, cy), (cx, v)].
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
// sift.c:1340-1363), 24 adds into the block's histogram. Every step uses
// the operations of sift3d_tpu_torch/descriptor.py prep_windows in its
// order, as round-to-nearest intrinsics, so that every mask and face
// decision is the plain path's; only the sums run in another order.
//
// Bound on the H100: operations (~400 f32 operations a voxel, of which
// the 20-face test is most) and contention on the shared-memory atomics,
// as neighbouring voxels hit neighbouring bins. Neither grot nor the bins
// reach device memory: the only device-memory traffic is the level read
// (through L1/L2) and the histogram. Each warp adds into a histogram of its
// own (kHists = 8, 24 KB of shared memory), merged at the block's end and
// added into hist[k] with global atomics; on the 256^3 dense phantom this
// is 1-3% faster at the two largest octaves than one histogram per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFaces = 20;
constexpr int kBins = 768;
// Shared-memory histograms per block: warp w adds into number w % kHists.
constexpr int kHists = kThreads / 32;

struct DescParams {
  int nx, ny, nz, splits;
  float u[3], inv[3];
  float sig_fctr, rad_fctr, sqrt2, eps;
};

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
            const int* __restrict__ face_idx, float* __restrict__ hist,
            DescParams P) {
  __shared__ float h[kHists][kBins];
  __shared__ float mt[180];
  __shared__ float kconst[kFaces];
  __shared__ int fidx[3 * kFaces];
  __shared__ float R[9];
  for (int i = threadIdx.x; i < kHists * kBins; i += blockDim.x) {
    (&h[0][0])[i] = 0.0f;
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

  // Window scalars in the order of descriptor.py prep_windows.
  const float c[3] = {centers[3 * k], centers[3 * k + 1], centers[3 * k + 2]};
  const float sigma = __fmul_rn(sd_in[k], P.sig_fctr);
  const float win_radius = __fmul_rn(sigma, P.rad_fctr);
  const float half_width = __fdiv_rn(win_radius, P.sqrt2);
  const float bin_fctr =
      __fdiv_rn(1.0f, __fdiv_rn(__fmul_rn(2.0f, half_width), 4.0f));
  const float rad2 = __fmul_rn(win_radius, win_radius);
  const float sig2 = __fmul_rn(sigma, sigma);
  const int n[3] = {P.nx, P.ny, P.nz};
  int lo[3], ext[3];
  for (int a = 0; a < 3; ++a) {
    const float ra = __fdiv_rn(win_radius, P.u[a]);
    const float l = fmaxf(floorf(__fsub_rn(c[a], ra)), 1.0f);
    const float hi = fminf(ceilf(__fadd_rn(c[a], ra)), (float)(n[a] - 2));
    lo[a] = (int)l;
    ext[a] = max(0, (int)hi - (int)l + 1);
  }
  // A box holds at most (n-2)^3 < 2^31 voxels: 32-bit index arithmetic.
  const int total = ext[0] * ext[1] * ext[2];
  const int chunk = (total + P.splits - 1) / P.splits;
  const int t0 = blockIdx.y * chunk;
  const int t1 = min(total, t0 + chunk);
  const int64_t sx = (int64_t)P.ny * P.nz, sy = P.nz;
  const float* level = levels + lvl[k] * P.nx * sx;
  const float eps = P.eps, neg_eps = -P.eps;
  float* hw = h[(threadIdx.x >> 5) % kHists];

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
    const float* p = level + x * sx + y * sy + z;
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
          float* row = hw + (cz * 4 + cy) * 48 + cx * 12;
          for (int j = 0; j < 3; ++j) {
            atomicAdd(row + fidx[3 * face + j],
                      __fmul_rn(wzy, __fmul_rn(wx, bw[j])));
          }
        }
      }
    }
  }
  __syncthreads();
  float* out = hist + k * kBins;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    float s = h[0][i];
    for (int j = 1; j < kHists; ++j) s += h[j][i];
    if (s != 0.0f) atomicAdd(out + i, s);
  }
}

}  // namespace

// hist f32[K, 16, 48], zero on entry.
extern "C" int s3d_desc_fused(const float* levels, const int64_t* lvl,
                              const float* centers, const float* R,
                              const float* sd, const float* geom,
                              const int* face_idx, float* hist, int K,
                              int splits, int nx, int ny, int nz, float ux,
                              float uy, float uz, float ix, float iy,
                              float iz, float sig_fctr, float rad_fctr,
                              float sqrt2, float eps, void* stream) {
  const DescParams P{nx, ny, nz, splits, {ux, uy, uz}, {ix, iy, iz},
                     sig_fctr, rad_fctr, sqrt2, eps};
  const dim3 grid(K, splits);
  desc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, lvl, centers, R, sd, geom, face_idx, hist, P);
  return static_cast<int>(cudaGetLastError());
}

// Orientation window moments: A = sum w g g^T and vd = sum w g.
//
// Replaces sift3d_tpu/ops/ori_kernel.py:167 ori_moments_pallas (TPU
// Pallas). Python wrapper: sift3d_tpu_torch/ops/ori_kernel.py.
//
// One block per keypoint. The block walks the reference's loop-bound box
// (IM_LOOP_SPHERE_START, sift.c:86-109) on the keypoint's level in place,
// keeps the voxels of the sphere, and sums the Gaussian-weighted moments
// of the central-difference gradient (IM_GET_GRAD_ISO, sift.c:140-145) in
// f32. The per-voxel arithmetic uses round-to-nearest intrinsics in the
// order of sift3d_tpu/orientation.py:65-96, so the sphere test and the
// weights match the reference; only the sums run in another order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 9;  // a00 a01 a02 a11 a12 a22 v0 v1 v2

__global__ void ori_kernel(const float* __restrict__ levels,
                           const int* __restrict__ lvl,
                           const float* __restrict__ fp,
                           float* __restrict__ out, int nx, int ny, int nz,
                           float ux, float uy, float uz, float ix, float iy,
                           float iz, float sig_fctr, float rad_fctr) {
  const int k = blockIdx.x;
  const float c[3] = {fp[4 * k], fp[4 * k + 1], fp[4 * k + 2]};
  const float sd = fp[4 * k + 3];
  const float u[3] = {ux, uy, uz};
  const int n[3] = {nx, ny, nz};
  const float sigma = __fmul_rn(sig_fctr, sd);
  const float rad = __fmul_rn(sigma, rad_fctr);
  int lo[3], ext[3];
  for (int a = 0; a < 3; ++a) {
    const float ra = __fdiv_rn(rad, u[a]);
    const float l = fmaxf(floorf(__fsub_rn(c[a], ra)), 1.0f);
    const float h = fminf(ceilf(__fadd_rn(c[a], ra)), (float)(n[a] - 2));
    lo[a] = (int)l;
    ext[a] = max(0, (int)h - (int)l + 1);
  }
  const float rad2 = __fmul_rn(rad, rad);
  const float sig2 = __fmul_rn(sigma, sigma);
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  const float* level = levels + (int64_t)lvl[k] * nx * sx;
  const int64_t total = (int64_t)ext[0] * ext[1] * ext[2];

  float acc[kSums];
  for (int s = 0; s < kSums; ++s) acc[s] = 0.0f;
  for (int64_t t = threadIdx.x; t < total; t += blockDim.x) {
    const int z = lo[2] + (int)(t % ext[2]);
    const int64_t r = t / ext[2];
    const int y = lo[1] + (int)(r % ext[1]);
    const int x = lo[0] + (int)(r / ext[1]);
    const float dx = __fmul_rn(__fsub_rn((float)x, c[0]), ux);
    const float dy = __fmul_rn(__fsub_rn((float)y, c[1]), uy);
    const float dz = __fmul_rn(__fsub_rn((float)z, c[2]), uz);
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    if (!(sq <= rad2)) continue;
    const float w = expf(__fdiv_rn(__fmul_rn(-0.5f, sq), sig2));
    const float* p = level + x * sx + y * sy + z;
    const float gx = __fmul_rn(__fmul_rn(0.5f, __fsub_rn(p[sx], p[-sx])), ix);
    const float gy = __fmul_rn(__fmul_rn(0.5f, __fsub_rn(p[sy], p[-sy])), iy);
    const float gz = __fmul_rn(__fmul_rn(0.5f, __fsub_rn(p[1], p[-1])), iz);
    const float wgx = __fmul_rn(w, gx), wgy = __fmul_rn(w, gy),
                wgz = __fmul_rn(w, gz);
    acc[0] = __fmaf_rn(wgx, gx, acc[0]);
    acc[1] = __fmaf_rn(wgx, gy, acc[1]);
    acc[2] = __fmaf_rn(wgx, gz, acc[2]);
    acc[3] = __fmaf_rn(wgy, gy, acc[3]);
    acc[4] = __fmaf_rn(wgy, gz, acc[4]);
    acc[5] = __fmaf_rn(wgz, gz, acc[5]);
    acc[6] = __fadd_rn(acc[6], wgx);
    acc[7] = __fadd_rn(acc[7], wgy);
    acc[8] = __fadd_rn(acc[8], wgz);
  }

  __shared__ float partial[kSums][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = 0; s < kSums; ++s) {
    float v = acc[s];
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) partial[s][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    float tot[kSums];
    for (int s = 0; s < kSums; ++s) {
      float v = lane < nwarps ? partial[s][lane] : 0.0f;
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      tot[s] = v;
    }
    if (lane == 0) {
      float* o = out + 12 * (int64_t)k;
      o[0] = tot[0]; o[1] = tot[1]; o[2] = tot[2];
      o[3] = tot[1]; o[4] = tot[3]; o[5] = tot[4];
      o[6] = tot[2]; o[7] = tot[4]; o[8] = tot[5];
      o[9] = tot[6]; o[10] = tot[7]; o[11] = tot[8];
    }
  }
}

}  // namespace

extern "C" int s3d_ori_moments(const float* levels, const int* lvl,
                               const float* fp, float* out, int K, int nx,
                               int ny, int nz, float ux, float uy, float uz,
                               float ix, float iy, float iz, float sig_fctr,
                               float rad_fctr, void* stream) {
  ori_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, lvl, fp, out, nx, ny, nz, ux, uy, uz, ix, iy, iz, sig_fctr,
      rad_fctr);
  return static_cast<int>(cudaGetLastError());
}

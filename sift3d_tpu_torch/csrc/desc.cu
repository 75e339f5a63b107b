// Icosahedral descriptor histogram.
//
// Replaces sift3d_tpu/ops/desc_kernel.py:304 desc_hist_pallas (TPU
// Pallas). grot, vbins f32[K, 3, N] -> hist f32[K, 16, 48] (zero on
// entry) = [(cz, cy), (cx, v)]. Python wrapper:
// sift3d_tpu_torch/ops/desc_kernel.py.
//
// Grid (K, splits): block (k, s) takes voxel slice s of keypoint k, adds
// into a private float[768] histogram in shared memory, then adds that
// into hist[k] with global atomics. Per voxel: the first icosahedron face,
// in face order, that the gradient pierces, by the division-free hit test
// of sift3d_tpu/descriptor.py:151-172 (icos_hist_bin, sift.c:1254-1291),
// then |g| x barycentric x trilinear weights (SIFT3D_desc_acc_interp,
// sift.c:1340-1363) as 24 shared-memory atomicAdds. Round-to-nearest
// intrinsics keep the face tests in the reference's arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFaces = 20;
constexpr int kBins = 768;

__device__ __forceinline__ float dot3(float g0, float g1, float g2,
                                      const float* m, int col) {
  // m is MT_MATRIX [3, 60] row-major.
  return __fadd_rn(__fadd_rn(__fmul_rn(g0, m[col]), __fmul_rn(g1, m[60 + col])),
                   __fmul_rn(g2, m[120 + col]));
}

__global__ void desc_kernel(const float* __restrict__ grot,
                            const float* __restrict__ vbins,
                            const float* __restrict__ geom,
                            const int* __restrict__ face_idx,
                            float* __restrict__ hist, int N, int chunk,
                            float eps) {
  __shared__ float h[kBins];
  __shared__ float mt[180];
  __shared__ float kconst[kFaces];
  __shared__ int fidx[3 * kFaces];
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) h[i] = 0.0f;
  for (int i = threadIdx.x; i < 180; i += blockDim.x) mt[i] = geom[i];
  for (int i = threadIdx.x; i < kFaces; i += blockDim.x) {
    kconst[i] = geom[180 + i];
  }
  for (int i = threadIdx.x; i < 3 * kFaces; i += blockDim.x) {
    fidx[i] = face_idx[i];
  }
  __syncthreads();

  const int64_t k = blockIdx.x;
  const int n0 = blockIdx.y * chunk;
  const int n1 = min(N, n0 + chunk);
  const float* g = grot + k * 3 * (int64_t)N;
  const float* vb = vbins + k * 3 * (int64_t)N;
  const float neg_eps = -eps;

  for (int n = n0 + threadIdx.x; n < n1; n += blockDim.x) {
    const float g0 = g[n], g1 = g[N + n], g2 = g[2 * (int64_t)N + n];
    const float gsq = __fadd_rn(__fadd_rn(__fmul_rn(g0, g0), __fmul_rn(g1, g1)),
                                __fmul_rn(g2, g2));
    if (!(gsq >= eps)) continue;  // masked voxels carry a zero gradient

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
      const float v = vb[a * (int64_t)N + n];
      const float b = floorf(v);
      const float fr = __fsub_rn(v, b);
      base[a] = (int)b;
      w0[a] = __fsub_rn(1.0f, fr);
      w1[a] = fr;
    }
    for (int iz = 0; iz < 2; ++iz) {
      const int cz = base[2] + iz;
      if (cz < 0 || cz > 3) continue;
      const float wz = iz ? w1[2] : w0[2];
      for (int iy = 0; iy < 2; ++iy) {
        const int cy = base[1] + iy;
        if (cy < 0 || cy > 3) continue;
        const float wzy = __fmul_rn(wz, iy ? w1[1] : w0[1]);
        for (int ix = 0; ix < 2; ++ix) {
          const int cx = base[0] + ix;
          if (cx < 0 || cx > 3) continue;
          const float wx = ix ? w1[0] : w0[0];
          float* row = h + (cz * 4 + cy) * 48 + cx * 12;
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
    if (h[i] != 0.0f) atomicAdd(out + i, h[i]);
  }
}

}  // namespace

extern "C" int s3d_desc_hist(const float* grot, const float* vbins,
                             const float* geom, const int* face_idx,
                             float* hist, int K, int N, int splits, float eps,
                             void* stream) {
  const int chunk = (N + splits - 1) / splits;
  const dim3 grid(K, splits);
  desc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      grot, vbins, geom, face_idx, hist, N, chunk, eps);
  return static_cast<int>(cudaGetLastError());
}

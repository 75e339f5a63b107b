// Gaussian-pyramid blur: banded axis pass and DoG with per-level max |DoG|.
//
// Replaces sift3d_tpu/ops/blur_kernel.py:337 chain_octave (TPU Pallas).
// Volumes are f32[nx, ny, nz], C order (z fastest). Python wrapper:
// sift3d_tpu_torch/ops/blur_kernel.py.
//
// Every product and sum uses the round-to-nearest intrinsics: nvcc would
// otherwise contract a*b+c into an FMA, and the reference multiplies, then
// adds, one band term at a time (sift3d_tpu/pyramid.py:182 _diag_pass).
// A different rounding moves the pyramid by ulps and can flip
// near-threshold extrema.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// out[.., i, ..] = sum_k wd[i, k] * src[.., i + lo + k, ..] along `axis`,
// k ascending; out-of-range reads carry zero weight and are skipped.
__global__ void axis_pass_kernel(const float* __restrict__ src,
                                 float* __restrict__ dst,
                                 const float* __restrict__ wd, int band,
                                 int lo, int nx, int ny, int nz, int axis) {
  const int64_t total = (int64_t)nx * ny * nz;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= total) return;
  const int z = (int)(v % nz);
  const int64_t r = v / nz;
  const int y = (int)(r % ny);
  const int x = (int)(r / ny);
  int i, n;
  int64_t stride;
  if (axis == 0) {
    i = x; n = nx; stride = (int64_t)ny * nz;
  } else if (axis == 1) {
    i = y; n = ny; stride = nz;
  } else {
    i = z; n = nz; stride = 1;
  }
  const float* line = src + (v - (int64_t)i * stride);
  const float* w = wd + (int64_t)i * band;
  float acc = 0.0f;
  for (int k = 0; k < band; ++k) {
    const int j = i + lo + k;
    if (j >= 0 && j < n) {
      acc = __fadd_rn(acc, __fmul_rn(w[k], line[(int64_t)j * stride]));
    }
  }
  dst[v] = acc;
}

// dog = prev - cur; *dmax = max(*dmax, max |dog|) by an integer atomicMax
// on the bits of the non-negative float (exact, independent of order).
__global__ void dog_max_kernel(const float* __restrict__ prev,
                               const float* __restrict__ cur,
                               float* __restrict__ dog,
                               unsigned int* __restrict__ dmax, int64_t n) {
  float m = 0.0f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float d = __fsub_rn(prev[i], cur[i]);
    dog[i] = d;
    m = fmaxf(m, fabsf(d));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
    }
    if (lane == 0) atomicMax(dmax, __float_as_uint(m));
  }
}

}  // namespace

extern "C" const char* s3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int s3d_blur_axis_pass(const float* src, float* dst,
                                  const float* wd, int band, int lo, int nx,
                                  int ny, int nz, int axis, void* stream) {
  const int64_t total = (int64_t)nx * ny * nz;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  axis_pass_kernel<<<(unsigned int)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      src, dst, wd, band, lo, nx, ny, nz, axis);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s3d_dog_max(const float* prev, const float* cur, float* dog,
                           float* dmax, int64_t n, void* stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  dog_max_kernel<<<(unsigned int)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      prev, cur, dog, reinterpret_cast<unsigned int*>(dmax), n);
  return static_cast<int>(cudaGetLastError());
}

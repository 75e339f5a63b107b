// DoG extrema stencil mask.
//
// Replaces sift3d_tpu/ops/extrema_kernel.py:384 extrema_mask_pallas (TPU
// Pallas). dog f32[nl + 2, nx, ny, nz], thr f32[nl] -> mask
// int8[nl, nx, ny, nz], border zero. Python wrapper:
// sift3d_tpu_torch/ops/extrema_kernel.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One thread per voxel (l, x, y, z). The centre is DoG level l + 1; it is
// a candidate when |v| clears thr[l] and v is strictly above, or strictly
// below, every compared neighbour (detect_extrema, sift.c:735-871): the 6
// face neighbours and the centres of levels l and l + 2, or the 3x3x3
// cube in all three levels (80 neighbours) when `cuboid`.
__global__ void extrema_kernel(const float* __restrict__ dog,
                               const float* __restrict__ thr,
                               int8_t* __restrict__ mask, int nl, int nx,
                               int ny, int nz, int cuboid) {
  const int64_t vol = (int64_t)nx * ny * nz;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= (int64_t)nl * vol) return;
  const int z = (int)(v % nz);
  int64_t r = v / nz;
  const int y = (int)(r % ny);
  r /= ny;
  const int x = (int)(r % nx);
  const int l = (int)(r / nx);
  if (x < 1 || x > nx - 2 || y < 1 || y > ny - 2 || z < 1 || z > nz - 2) {
    mask[v] = 0;
    return;
  }
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  const float* cur = dog + (int64_t)(l + 1) * vol + x * sx + y * sy + z;
  const float c = *cur;
  bool is_max = true, is_min = true;
  if (cuboid) {
    for (int lv = -1; lv <= 1; ++lv) {
      for (int dz = -1; dz <= 1; ++dz) {
        for (int dy = -1; dy <= 1; ++dy) {
          for (int dx = -1; dx <= 1; ++dx) {
            if (lv == 0 && dx == 0 && dy == 0 && dz == 0) continue;
            const float nb = cur[lv * vol + dx * sx + dy * sy + dz];
            is_max = is_max && (c > nb);
            is_min = is_min && (c < nb);
          }
        }
      }
    }
  } else {
    const int64_t offs[8] = {sx, -sx, sy, -sy, -1, 1, -vol, vol};
    for (int i = 0; i < 8; ++i) {
      const float nb = cur[offs[i]];
      is_max = is_max && (c > nb);
      is_min = is_min && (c < nb);
    }
  }
  const float t = thr[l];
  mask[v] = (int8_t)(((c > t) || (c < -t)) && (is_max || is_min));
}

}  // namespace

extern "C" int s3d_extrema_mask(const float* dog, const float* thr,
                                int8_t* mask, int nl, int nx, int ny, int nz,
                                int cuboid, void* stream) {
  const int64_t total = (int64_t)nl * nx * ny * nz;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  extrema_kernel<<<(unsigned int)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(dog, thr, mask, nl,
                                                        nx, ny, nz, cuboid);
  return static_cast<int>(cudaGetLastError());
}

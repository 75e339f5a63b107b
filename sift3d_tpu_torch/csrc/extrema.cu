// DoG extrema stencil with the candidates compacted inside the kernel.
//
// Replaces sift3d_tpu/ops/extrema_kernel.py:384 extrema_mask_pallas (TPU
// Pallas) and the XLA compaction that followed it. A batch of B octave
// DoG stacks dog f32[B, nl + 2, nx, ny, nz], thr f32[B, nl] -> the int64
// key (((b * nl + l) * nz + z) * ny + y) * nx + x of every candidate, in
// no particular order (the wrapper sorts them: volume-major, then the
// reference's scan order), and the count of candidates in all and per
// volume and level. No mask is written. Python wrapper:
// sift3d_tpu_torch/ops/extrema_kernel.py.
//
// Bound on the H100: device-memory bytes. The test that rejects almost
// every voxel, |v| > thr, needs only the voxel's own value: the kernel
// reads keypoint level l's DoG level l + 1 once, coalesced, and reads the
// neighbours (DoG levels l and l + 2 among them) only where a voxel passes
// the threshold, a few percent of the voxels, mostly from L1 and L2, where
// the neighbouring threads' reads left them. So DoG levels 0 and nl + 1
// are read almost nowhere and the others about once. (The TPU's
// fused-octave variant _kernel_fused_db stages all levels of a tile so
// that each serves as previous, centre and next level; a shared-memory
// ring of haloed planes that did the same here took twice as long,
// PERF.md.) A warp gathers its candidates with __ballot_sync + __popc and
// reserves their slots with one atomicAdd.
//
// z-slab contract (sift3d_tpu/parallel/spatial.py:160-248, which runs the
// TPU kernel on a shard's rows with a one-voxel z halo): the stack may be
// rows of a volume gnz deep, slab row 0 at global z z_origin. Only slab
// rows [zmin, zmax] are tested (the wrapper makes them the shard's own
// rows, inside [1, nz - 2] of the slab and [1, gnz - 2] globally), and the
// keys carry the global z and depth: (((b * nl + l) * gnz + z_origin + z)
// * ny + y) * nx + x. The whole volume is z_origin 0, gnz = nz, rows
// [1, nz - 2].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // values a thread reads before testing them
constexpr int kChunk = 2048;    // voxels of a plane a block tests

// Voxel (x, y, z) of keypoint level l (DoG level l + 1) is a candidate
// when it lies in the interior [1, n - 2]^3, its value c has c > thr[l]
// or c < -thr[l], and c is strictly above, or strictly below, every
// compared neighbour (detect_extrema, sift.c:735-871): the 6 faces and the
// centres of DoG levels l and l + 2, or the 3x3x3 cube in all three levels
// (80 neighbours) when `cuboid`. The threshold is tested first; the
// neighbours only where it passes. Block (c, x, b * nl + l) tests voxels
// [c * kChunk, (c + 1) * kChunk) of plane x of level l of volume b, in
// (y, z) order.
__global__ void __launch_bounds__(kThreads)
    extrema_kernel(const float* __restrict__ dog,
                   const float* __restrict__ thr, int64_t* __restrict__ keys,
                   unsigned long long* __restrict__ counts,
                   long long capacity, int nl, int nx, int ny, int nz,
                   int zmin, int zmax, int z_origin, int gnz, int cuboid) {
  const int bl = blockIdx.z, x = blockIdx.y;
  const int b = bl / nl, l = bl - b * nl;
  const int lane = threadIdx.x & 31;
  const int plane = ny * nz;
  const int64_t vol = (int64_t)nx * plane;
  const float* cur = dog + ((int64_t)b * (nl + 2) + l + 1) * vol +
                     (int64_t)x * plane;
  const float t = thr[bl];
  const bool x_in = x >= 1 && x <= nx - 2;
  const int p0 = blockIdx.x * kChunk, p1 = min(p0 + kChunk, plane);
  // Every lane runs every step (the ballots need whole warps).
  for (int base = p0; base < p1; base += kThreads * kUnroll) {
    float c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * kThreads + threadIdx.x;
      c[u] = p < p1 ? __ldg(cur + p) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * kThreads + threadIdx.x;
      int y = 0, z = 0;
      bool cand = false;
      if (p < p1 && x_in && (c[u] > t || c[u] < -t)) {
        y = p / nz;
        z = p - y * nz;
        if (y >= 1 && y <= ny - 2 && z >= zmin && z <= zmax) {
          const float* q = cur + p;
          bool is_max = true, is_min = true;
          if (cuboid) {
            for (int lv = -1; lv <= 1; ++lv) {
              for (int dx = -1; dx <= 1; ++dx) {
                for (int dy = -1; dy <= 1; ++dy) {
                  for (int dz = -1; dz <= 1; ++dz) {
                    if (lv == 0 && dx == 0 && dy == 0 && dz == 0) continue;
                    const float nb =
                        __ldg(q + lv * vol + dx * plane + dy * nz + dz);
                    is_max = is_max && (c[u] > nb);
                    is_min = is_min && (c[u] < nb);
                  }
                }
              }
            }
          } else {
            const int64_t offs[8] = {plane, -plane, nz, -nz, -1, 1,
                                     -vol, vol};
            for (int i = 0; i < 8; ++i) {
              const float nb = __ldg(q + offs[i]);
              is_max = is_max && (c[u] > nb);
              is_min = is_min && (c[u] < nb);
            }
          }
          cand = is_max || is_min;
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, cand);
      if (ballot != 0u) {
        unsigned long long first = 0;
        if (lane == 0) {
          first = atomicAdd(&counts[0], (unsigned long long)__popc(ballot));
          atomicAdd(&counts[1 + bl], (unsigned long long)__popc(ballot));
        }
        first = __shfl_sync(0xffffffffu, first, 0);
        if (cand) {
          const long long slot =
              (long long)first + __popc(ballot & ((1u << lane) - 1u));
          if (slot < capacity) {
            keys[slot] =
                (((int64_t)bl * gnz + z_origin + z) * ny + y) * nx + x;
          }
        }
      }
    }
  }
}

}  // namespace

// counts u64[1 + nb * nl], zero on entry: [all candidates, then per
// volume and level]. Keys past `capacity` are counted but not written.
extern "C" int s3d_extrema_candidates(const float* dog, const float* thr,
                                      int64_t* keys, int64_t* counts,
                                      long long capacity, int nb, int nl,
                                      int nx, int ny, int nz, int zmin,
                                      int zmax, int z_origin, int gnz,
                                      int cuboid, void* stream) {
  if (nb < 1 || nl < 1 || nx < 1 || ny < 1 || nz < 1 || nx > 65535 ||
      (int64_t)nb * nl > 65535 || zmin < 1 || zmax > nz - 2 ||
      z_origin + zmin < 1 || z_origin + zmax > gnz - 2) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((ny * nz + kChunk - 1) / kChunk, nx, nb * nl);
  extrema_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dog, thr, keys, reinterpret_cast<unsigned long long*>(counts), capacity,
      nl, nx, ny, nz, zmin, zmax, z_origin, gnz, cuboid);
  return static_cast<int>(cudaGetLastError());
}

// Gaussian-pyramid blur level: an x pass, then the y and z passes fused
// with the DoG and the level's max |DoG|, both through shared-memory tiles.
//
// Replaces sift3d_tpu/ops/blur_kernel.py:337 chain_octave (TPU Pallas),
// which makes each level and its DoG in one pass from a halo slab. Here
// the level is split at the seam where the halo changes: the x pass needs
// neighbours in x only, and the y and z passes then stay inside one
// x-plane. Volumes are f32[nx, ny, nz], C order (z fastest); a batch of
// them is one launch per pass, volume b at its tensor's base plus b times
// that tensor's batch stride (in elements, 64-bit), so a level of a
// [B, L, nx, ny, nz] pyramid needs no copy. Python wrapper and tile
// picker: sift3d_tpu_torch/ops/blur_kernel.py.
//
// Bound on the H100: device-memory bytes. The x pass reads and writes the
// volume once; the y/z pass reads the x output and the previous level and
// writes the level and the DoG. Halo rows are read again by the
// neighbouring tile, from L2. What the design does about it:
//  - tiles reach shared memory by cp.async, 16 bytes a copy where the row
//    length allows (a multiple of 4 words), every copy of a tile in flight
//    at once; in the y/z pass the next x-plane's tile is in flight while
//    this one's z pass and writes run;
//  - a band term costs a shared-memory read, and shared memory serves
//    fewer reads than the multiplies and adds can issue. So each thread
//    holds four outputs along the band: a value read once serves all four
//    (as their taps k, k - 1, k - 2, k - 3), against one float4 of skewed
//    weights (stage_skewed), and that float4 serves every column the
//    thread holds. The z pass runs on the y pass's output transposed, so
//    that its band also runs down a column with lanes along rows.
//
// Every product and sum uses the round-to-nearest intrinsics: nvcc would
// otherwise contract a*b+c into an FMA, and the reference multiplies, then
// adds, one band term at a time, k ascending, in the order x, y, z
// (sift3d_tpu/pyramid.py:182 _diag_pass). A different rounding moves the
// pyramid by ulps and can flip near-threshold extrema. A halo value that
// two tiles both compute comes out identical, since the same operations
// run in the same order. Taps outside the volume read zeros; their weight
// is zero (filters.conv_diagonals), as in the plain version's padding.
//
// Offsets: a 64-bit base per volume and tile (or row), 32-bit arithmetic
// inside it.
//
// z-slab contract of the y/z pass (a z-sharded pyramid,
// sift3d_tpu/parallel/spatial.py:113-157): its input may be a slab of nzs
// rows that holds the nz output rows from slab row zoff, with halo rows of
// the neighbouring shards on both sides (zeros beyond the volume). The
// caller hands the z weights of the output rows' global indices, so the
// boundary rule applies only at the volume's own ends; the pass writes,
// and counts in max |DoG|, only the output rows. A halo at least the
// band's reach gives every output row the whole-volume launch's terms in
// its order: the same bits. The whole volume is nzs = nz, zoff = 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kXThreads = 128;   // x pass: threads of a tile
constexpr int kXCols = 2;        // x pass: columns a thread holds
constexpr int kXWidth = kXThreads * kXCols;   // (y, z) columns of a tile
constexpr int kYZThreads = 256;  // y/z pass: 8 warps
constexpr int kWarps = kYZThreads / 32;
constexpr int kBlock = 4;        // outputs along the band a thread holds
constexpr int kYCols = 3;        // y pass: column groups of 32 a thread holds
constexpr int kOut = 8;          // y/z pass: outputs a thread writes

// Asynchronous 4-byte copy to shared memory; `in` false writes a zero (a
// tap outside the volume) and reads nothing.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0));
}

// Asynchronous 16-byte copy (L2 only); `in` false writes zeros.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ float mul_add(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

// acc[i] += w.i * v for the kBlock outputs that value v serves.
__device__ __forceinline__ void mul_add4(float (&acc)[kBlock], float4 w,
                                         float v) {
  acc[0] = mul_add(acc[0], w.x, v);
  acc[1] = mul_add(acc[1], w.y, v);
  acc[2] = mul_add(acc[2], w.z, v);
  acc[3] = mul_add(acc[3], w.w, v);
}

// The band weights of `groups` blocks of kBlock output rows, skewed: for
// rows from row0 + kBlock * g, dst[g][j] = (w[row][j], w[row + 1][j - 1],
// w[row + 2][j - 2], w[row + 3][j - 3]), j < band + kBlock - 1, so input
// row j of the block is multiplied by one float4. A tap outside the band,
// or a row at or past `rows`, gets weight zero: it adds zero to the sum
// (a zero product of a finite value), so each output still sums its band
// terms alone, k ascending.
__device__ void stage_skewed(float* dst, const float* __restrict__ w,
                             int band, int row0, int rows, int groups,
                             int tid, int nthreads) {
  const int per = (band + kBlock - 1) * kBlock;
  for (int e = tid; e < groups * per; e += nthreads) {
    const int g = e / per, r = e - g * per;
    const int j = r / kBlock, i = r - j * kBlock;
    const int row = kBlock * g + i, k = j - i;
    dst[e] = (row < rows && k >= 0 && k < band)
                 ? w[(int64_t)(row0 + row) * band + k]
                 : 0.0f;
  }
}

// out[x0 + r, p] = sum_k wx[x0 + r, k] * in[x0 + r + lo + k, p], for a
// tile of kXWidth columns p of the (y, z) plane and tx rows from x0 (tx a
// multiple of kBlock) of volume blockIdx.z. Thread t holds columns t and
// t + kXThreads and kBlock rows at a time: an input value read once serves
// four rows.
//
// Shared memory: w4 [tx / 4][band + 3] float4 the skewed weight rows;
// slab [tx + band - 1][kXWidth] the input rows, zeros outside the volume.
__global__ void __launch_bounds__(kXThreads)
    blur_x_kernel(const float* __restrict__ src, float* __restrict__ dst,
                  const float* __restrict__ wx, int band, int lo,
                  int64_t src_bs, int64_t dst_bs, int nx, int plane, int tx,
                  bool vec) {
  extern __shared__ float4 smem4[];
  src += blockIdx.z * src_bs;
  dst += blockIdx.z * dst_bs;
  const int jn = band + kBlock - 1;
  const float4* w4 = smem4;
  float* slab = reinterpret_cast<float*>(smem4 + (tx / kBlock) * jn);
  const int t = threadIdx.x;
  const int p0 = blockIdx.x * kXWidth;
  const int x0 = blockIdx.y * tx;
  const int nout = min(tx, nx - x0);
  bool col[kXCols];
  for (int n = 0; n < kXCols; ++n) col[n] = p0 + t + n * kXThreads < plane;
  // The input rows: with `vec` (plane a multiple of 4, src 16-byte
  // aligned) by 16-byte copies, which lie wholly inside or outside the
  // plane, else word by word.
  const int rows = tx + band - 1, step = vec ? 4 : 1;
  const int shift = vec ? 6 : 8;   // log2(kXWidth / step)
  static_assert(kXWidth == 256, "shift");
  for (int e = t; e < rows << shift; e += kXThreads) {
    const int r = e >> shift, c = step * (e & ((1 << shift) - 1));
    const int xi = x0 + lo + r;
    const bool ok = xi >= 0 && xi < nx && p0 + c < plane;
    const float* in = src + (ok ? (int64_t)xi * plane + p0 + c : 0);
    if (vec) {
      copy16(slab + r * kXWidth + c, in, ok);
    } else {
      copy4(slab + r * kXWidth + c, in, ok);
    }
  }
  copy_commit();
  stage_skewed(reinterpret_cast<float*>(smem4), wx, band, x0, nout,
               tx / kBlock, t, kXThreads);
  copy_wait_all();
  __syncthreads();

  float* out = dst + (int64_t)x0 * plane + p0 + t;
  for (int g = 0; g * kBlock < nout; ++g) {
    float acc[kXCols][kBlock] = {};
    const float4* wg = w4 + g * jn;
    const float* v = slab + g * kBlock * kXWidth + t;
    for (int j = 0; j < jn; ++j) {
      const float4 w = wg[j];
      for (int n = 0; n < kXCols; ++n) {
        mul_add4(acc[n], w, v[j * kXWidth + n * kXThreads]);
      }
    }
    for (int i = 0; i < kBlock && g * kBlock + i < nout; ++i) {
      for (int n = 0; n < kXCols; ++n) {
        if (col[n]) out[(g * kBlock + i) * plane + n * kXThreads] = acc[n][i];
      }
    }
  }
}

// A ty x tz tile (ty a multiple of kBlock, at most 32; tz 32 or 64) of xs
// consecutive x-planes of one volume (src rows nzs deep, output row z at
// src row zoff + z) (blockIdx.z = b * ceil(nx / xs) + the
// planes' group; each tensor's volume b at its base + b * its batch
// stride, dmax[b * dmax_bs] the volume's max): the y pass and the z pass of
// the x output `src`, the level written to `cur`; with `prev`, also
// dog = prev - cur and *dmax = max(*dmax, max |dog|) by an integer
// atomicMax on the bits of the non-negative float (exact, independent of
// order). The weights are staged once for the xs planes; the next plane's
// tile is in flight during the z pass and the writes.
//
// Shared memory (floats), ca = tz + bz - 1 columns from z0 + loz:
//   wy4 [ty / 4][by + 3] float4  skewed y weight rows (broadcast reads)
//   wz4 [tz / 4][bz + 3] float4  skewed z weight rows (broadcast reads)
//   o   [ty][tz + 4]             the z pass, before the coalesced writes
//   bt  [ca][ty + 1]             the y pass, transposed
//   a   [ty + by - 1][cw]        the x output, y from y0 + loy, zeros
//                                outside the volume
// In the y pass warp w holds rows 4w .. 4w + 3 of kYCols column groups
// (lanes along z); in the z pass lane r holds row r and warp w the column
// blocks 4g .. 4g + 3, g = w, w + 8 (bt's odd stride keeps both passes'
// shared reads and writes free of bank conflicts). Each reads one float4
// of weights per input row for four outputs.
__global__ void __launch_bounds__(kYZThreads) blur_yz_dog_kernel(
    const float* __restrict__ src, const float* __restrict__ prev,
    float* __restrict__ cur, float* __restrict__ dog,
    unsigned int* __restrict__ dmax, const float* __restrict__ wy, int by,
    int loy, const float* __restrict__ wz, int bz, int loz, int64_t src_bs,
    int64_t prev_bs, int64_t cur_bs, int64_t dog_bs, int64_t dmax_bs, int nx,
    int ny, int nz, int nzs, int zoff, int ty, int tz, int xs, bool vec) {
  extern __shared__ float4 smem4[];
  const int groups = (nx + xs - 1) / xs;
  const int vb = blockIdx.z / groups, xg = blockIdx.z - vb * groups;
  src += vb * src_bs;
  cur += vb * cur_bs;
  if (dog != nullptr) {
    prev += vb * prev_bs;
    dog += vb * dog_bs;
    dmax += vb * dmax_bs;
  }
  const int ca = tz + bz - 1, ra = ty + by - 1;
  const int jy = by + kBlock - 1, jz = bz + kBlock - 1;
  const int so = tz + 4, sb = ty + 1;
  float4* wy4 = smem4;
  float4* wz4 = wy4 + (ty / kBlock) * jy;
  float* o = reinterpret_cast<float*>(wz4 + (tz / kBlock) * jz);
  // a's rows start at src row z0 + zoff + loz - sh, a multiple of 4 (z0
  // is), so that 16-byte copies land aligned; its row stride cw is a
  // multiple of 4.
  const int sh = (zoff + loz) & 3, cw = (ca + sh + 3) & ~3;
  float* bt = o + ty * so;
  float* a = bt + ((ca * sb + 3) & ~3);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int z0 = blockIdx.x * tz, y0 = blockIdx.y * ty;
  const int x0 = xg * xs, x1 = min(x0 + xs, nx);
  const int plane = ny * nz, plane_s = ny * nzs;
  const int nry = min(ty, ny - y0), nrz = min(tz, nz - z0);
  const int tz_shift = tz == 64 ? 6 : 5;

  // With `vec` (nzs a multiple of 4, src 16-byte aligned) by 16-byte
  // copies, which lie wholly inside or outside the slab, else word by
  // word.
  const int step = vec ? 4 : 1;
  auto stage = [&](int x) {
    const float* in = src + (int64_t)x * plane_s;
    for (int r = warp; r < ra; r += kWarps) {
      const int y = y0 + loy + r;
      const bool row = y >= 0 && y < ny;
      for (int c = step * lane; c < cw; c += step * 32) {
        const int z = z0 + zoff + loz - sh + c;
        const bool ok = row && z >= 0 && z < nzs;
        const float* g = in + (ok ? y * nzs + z : 0);
        if (vec) {
          copy16(a + r * cw + c, g, ok);
        } else {
          copy4(a + r * cw + c, g, ok);
        }
      }
    }
    copy_commit();
  };
  stage(x0);
  stage_skewed(reinterpret_cast<float*>(wy4), wy, by, y0, nry, ty / kBlock,
               tid, kYZThreads);
  stage_skewed(reinterpret_cast<float*>(wz4), wz, bz, z0, nrz, tz / kBlock,
               tid, kYZThreads);

  float m = 0.0f;
  for (int x = x0; x < x1; ++x) {
    const int64_t base = (int64_t)x * plane + (int64_t)y0 * nz + z0;
    copy_wait_all();
    __syncthreads();

    const int r0 = kBlock * warp;
    if (r0 < nry) {
      const float4* wr = wy4 + warp * jy;
      for (int c0 = lane; c0 < ca; c0 += 32 * kYCols) {
        float acc[kYCols][kBlock] = {};
        // Row r0 + j of a is tap j - i of output row r0 + i.
        for (int j = 0; j < jy; ++j) {
          const float4 w = wr[j];
          const float* v = a + (r0 + j) * cw + sh;
#pragma unroll
          for (int n = 0; n < kYCols; ++n) {
            const int c = c0 + 32 * n;
            mul_add4(acc[n], w, c < ca ? v[c] : 0.0f);
          }
        }
#pragma unroll
        for (int n = 0; n < kYCols; ++n) {
          const int c = c0 + 32 * n;
          if (c < ca) {
            for (int i = 0; i < kBlock; ++i) bt[c * sb + r0 + i] = acc[n][i];
          }
        }
      }
    }
    __syncthreads();
    if (x + 1 < x1) stage(x + 1);   // a is free until the next barrier

    // This thread's previous-level values, in flight during the z pass.
    float pv[kOut];
    if (dog != nullptr) {
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        const int e = tid + q * kYZThreads;
        const int r = e >> tz_shift, c = e & (tz - 1);
        pv[q] = (r < nry && c < nrz) ? prev[base + r * nz + c] : 0.0f;
      }
    }

    // Column j of bt is tap j - i of output column 4g + i.
    for (int g = warp; g < tz / kBlock; g += kWarps) {
      float acc[kBlock] = {};
      const float4* wg = wz4 + g * jz;
      const float* v = bt + kBlock * g * sb + lane;
      for (int j = 0; j < jz; ++j) mul_add4(acc, wg[j], v[j * sb]);
      if (lane < ty) {
        *reinterpret_cast<float4*>(o + lane * so + kBlock * g) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      const int e = tid + q * kYZThreads;
      const int r = e >> tz_shift, c = e & (tz - 1);
      if (r < nry && c < nrz) {
        const float v = o[r * so + c];
        cur[base + r * nz + c] = v;
        if (dog != nullptr) {
          const float d = __fsub_rn(pv[q], v);
          dog[base + r * nz + c] = d;
          m = fmaxf(m, fabsf(d));
        }
      }
    }
  }
  if (dog == nullptr) return;
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  __shared__ float warp_max[kWarps];
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
    }
    if (lane == 0) atomicMax(dmax, __float_as_uint(m));
  }
}

// Raise the kernel's dynamic shared-memory limit where a tile needs more
// than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" const char* s3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tile sizes and shared-memory bytes come from the wrapper's tile
// picker (ops/blur_kernel.py x_tile, yz_tile); a tile the kernel does not
// take, or fewer bytes than it needs, is refused. nb volumes, each
// tensor's volume b at its base + b * its batch stride (elements).
extern "C" int s3d_blur_x(const float* src, float* dst, const float* wx,
                          int band, int lo, int nb, int64_t src_bs,
                          int64_t dst_bs, int nx, int ny, int nz, int tx,
                          int smem_bytes, void* stream) {
  const int need = (int)sizeof(float) * ((band + kBlock - 1) * tx +
                                         (tx + band - 1) * kXWidth);
  if (tx < 1 || tx % kBlock != 0 || band < 1 || smem_bytes < need ||
      nb < 1 || nb > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(blur_x_kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  const int plane = ny * nz;
  const dim3 grid((plane + kXWidth - 1) / kXWidth, (nx + tx - 1) / tx, nb);
  blur_x_kernel<<<grid, kXThreads, smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      src, dst, wx, band, lo, src_bs, dst_bs, nx, plane, tx,
      plane % 4 == 0 && src_bs % 4 == 0 &&
          reinterpret_cast<uintptr_t>(src) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

// prev, dog and dmax are null for the first level of octave 0 (no DoG).
// src has nzs rows, output row z at src row zoff + z; wz holds the nz
// output rows' weights.
extern "C" int s3d_blur_yz_dog(const float* src, const float* prev,
                               float* cur, float* dog, float* dmax,
                               const float* wy, int by, int loy,
                               const float* wz, int bz, int loz, int nb,
                               int64_t src_bs, int64_t prev_bs,
                               int64_t cur_bs, int64_t dog_bs,
                               int64_t dmax_bs, int nx, int ny, int nz,
                               int nzs, int zoff, int ty, int tz, int xs,
                               int smem_bytes, void* stream) {
  const int ca = tz + bz - 1;
  const int need = (int)sizeof(float) *
                   ((by + kBlock - 1) * ty + (bz + kBlock - 1) * tz +
                    ty * (tz + 4) + ((ca * (ty + 1) + 3) & ~3) +
                    (ty + by - 1) * ((ca + 6) & ~3));
  if (ty < 1 || ty > kBlock * kWarps || ty % kBlock != 0 ||
      (tz != 32 && tz != 64) || ty * tz > kOut * kYZThreads || xs < 1 ||
      by < 1 || bz < 1 || smem_bytes < need || nb < 1 ||
      (int64_t)nb * ((nx + xs - 1) / xs) > 65535 || zoff < 0 ||
      zoff + nz > nzs) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(blur_yz_dog_kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((nz + tz - 1) / tz, (ny + ty - 1) / ty,
                  nb * ((nx + xs - 1) / xs));
  blur_yz_dog_kernel<<<grid, kYZThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      src, prev, cur, dog, reinterpret_cast<unsigned int*>(dmax), wy, by,
      loy, wz, bz, loz, src_bs, prev_bs, cur_bs, dog_bs, dmax_bs, nx, ny, nz,
      nzs, zoff, ty, tz, xs,
      nzs % 4 == 0 && src_bs % 4 == 0 &&
          reinterpret_cast<uintptr_t>(src) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

// Orientation of one octave's candidates: window moments, 3x3 eigensolver,
// rejection tests and the rotation R, in one kernel.
//
// Replaces sift3d_tpu/ops/ori_kernel.py:167 ori_moments_pallas (TPU
// Pallas) together with the XLA epilogue that followed it in
// sift3d_tpu/orientation.py:250-289 (eigh3x3 :110, rejection, R). Python
// wrapper: sift3d_tpu_torch/ops/ori_kernel.py.
//
// One block per keypoint. The block walks the reference's loop-bound box
// (IM_LOOP_SPHERE_START, sift.c:86-109) of the keypoint's f32 center,
// integer-valued or fractional after subvoxel refinement (the TPU kernel's
// fp), on the keypoint's level in place, keeps the voxels of the sphere,
// and sums the Gaussian-weighted moments of the central-difference
// gradient (IM_GET_GRAD_ISO, sift.c:140-145) in f32. After the block
// reduction one thread runs the rest of assign_orientations on its 12
// numbers, in registers: 6 cyclic Jacobi sweeps and a stable ascending sort
// (eigh3x3), the weak-gradient, eigenvalue-ratio and corner tests
// (sift.c:996-1102), sign fixing and R.
//
// Bound on the H100: latency. An octave has tens to hundreds of
// candidates of ~10^4 window voxels each, a few microseconds of reads;
// what the kernel removes is the host's launch of the epilogue as some
// 1300 tiny tensor ops per octave (PERF.md). The per-voxel arithmetic and
// the eigensolver use round-to-nearest intrinsics, so nvcc contracts
// nothing into an FMA: the sphere test and the weights match the
// reference, and eigh3x3 matches sift3d_tpu_torch's plain eigh3x3 op for
// op (bit for bit on the same A; s3d_eigh3x3 exports it batched). Only
// the moment sums run in another order than the plain version. The TPU
// kernel's integer anchors placed its window DMA; walking the box in place
// needs none.
//
// z-slab contract (the TPU kernel's z_origin / global_nz,
// sift3d_tpu/ops/ori_kernel.py:178-191): the levels may be rows of a
// volume gnz deep, slab row 0 at global z z_origin (a shard's rows with
// their halo). Centers stay global, the loop bounds clip at [1, gnz - 2],
// and global row z is read from slab row z - z_origin. The sums and their
// order do not depend on the slab, so a slab launch gives the whole-volume
// launch's bits. A keypoint whose box, with its gradient border, leaves
// the slab reads nothing: its A, vd and R read NaN and none of its four
// predicates is set (neither accepted nor rejected), with no host sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 9;  // a00 a01 a02 a11 a12 a22 v0 v1 v2

// torch.sign: +1, -1, 0 for +-0; NaN stays NaN.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : (x == 0.0f ? 0.0f : x));
}

// Sort key order of torch.sort: ascending, NaN after every number.
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (!isnan(a) && isnan(b));
}

// Symmetric 3x3 eigendecomposition, the arithmetic of
// sift3d_tpu_torch/ops/ori_kernel.py eigh3x3_plain (and of
// sift3d_tpu/orientation.py:110 eigh3x3): 6 cyclic Jacobi sweeps over
// (0,1), (0,2), (1,2), then a stable ascending sort with NaN last.
// a: row-major 3x3 in, w: eigenvalues ascending, V: row-major, eigenvectors
// in columns.
__device__ void eigh3x3(const float a_in[9], float w[3], float V[9]) {
  float a[3][3], v[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      a[i][j] = a_in[3 * i + j];
      v[i][j] = i == j ? 1.0f : 0.0f;
    }
  }
  for (int sweep = 0; sweep < 6; ++sweep) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = r == 2 ? 1 : 0;
      const int q = r == 0 ? 1 : 2;
      const float app = a[p][p], aqq = a[q][q], apq = a[p][q];
      const bool safe = fabsf(apq) > 0.0f;
      const float tau = __fdiv_rn(__fsub_rn(aqq, app),
                                  safe ? __fmul_rn(2.0f, apq) : 1.0f);
      const float root = __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)));
      float t = __fdiv_rn(sign_of(tau), __fadd_rn(fabsf(tau), root));
      if (tau == 0.0f) t = 1.0f;
      float c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
      const float s = safe ? __fmul_rn(t, c) : 0.0f;
      if (!safe) c = 1.0f;
      // a' = J^T a J: columns p, q, then rows p, q.
      float n[3][3];
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) n[i][j] = a[i][j];
      }
      for (int k = 0; k < 3; ++k) {
        const float akp = a[k][p], akq = a[k][q];
        n[k][p] = __fsub_rn(__fmul_rn(c, akp), __fmul_rn(s, akq));
        n[k][q] = __fadd_rn(__fmul_rn(s, akp), __fmul_rn(c, akq));
      }
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) a[i][j] = n[i][j];
      }
      for (int k = 0; k < 3; ++k) {
        const float apk = n[p][k], aqk = n[q][k];
        a[p][k] = __fsub_rn(__fmul_rn(c, apk), __fmul_rn(s, aqk));
        a[q][k] = __fadd_rn(__fmul_rn(s, apk), __fmul_rn(c, aqk));
      }
      for (int k = 0; k < 3; ++k) {
        const float vp = v[k][p], vq = v[k][q];
        v[k][p] = __fsub_rn(__fmul_rn(c, vp), __fmul_rn(s, vq));
        v[k][q] = __fadd_rn(__fmul_rn(s, vp), __fmul_rn(c, vq));
      }
    }
  }
  const float d[3] = {a[0][0], a[1][1], a[2][2]};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i) {  // stable insertion sort
    for (int j = i; j > 0 && before(d[order[j]], d[order[j - 1]]); --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  }
  for (int j = 0; j < 3; ++j) {
    w[j] = d[order[j]];
    for (int i = 0; i < 3; ++i) V[3 * i + j] = v[i][order[j]];
  }
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

// C's fabs(x) > thr: an infinite ratio rejects, NaN keeps.
__device__ __forceinline__ bool ratio_gt(float num, float den, float thr) {
  const float r = fabsf(__fdiv_rn(num, den));
  return !isnan(r) && r > thr;
}

struct Thresholds {
  float grad, eig_ratio, corner;
};

// The epilogue of assign_orientations on one keypoint's moments A (row-
// major 3x3) and vd: R (row-major, columns r0 r1 r2) and the four
// predicates accepted, reject_grad, reject_ratio, reject_corner.
__device__ void orient_one(const float A[9], const float vd[3],
                           const Thresholds& th, float R[9], bool flags[4]) {
  float w[3], V[9];
  eigh3x3(A, w, V);
  const float grad_sq = dot3(vd, vd);
  const bool rej_grad = grad_sq < th.grad;
  const bool rej_ratio =
      ratio_gt(w[0], w[1], th.eig_ratio) || ratio_gt(w[1], w[2], th.eig_ratio);
  const float v2[3] = {V[2], V[5], V[8]}, v1[3] = {V[1], V[4], V[7]};
  const float d2 = dot3(vd, v2), d1 = dot3(vd, v1);
  const float gnorm = __fsqrt_rn(grad_sq);
  const float cos2 = __fdiv_rn(d2, __fmul_rn(__fsqrt_rn(dot3(v2, v2)), gnorm));
  const float cos1 = __fdiv_rn(d1, __fmul_rn(__fsqrt_rn(dot3(v1, v1)), gnorm));
  // torch.minimum propagates NaN, and NaN < thr is false.
  const float c2 = fabsf(cos2), c1 = fabsf(cos1);
  const bool rej_corner =
      !isnan(c2) && !isnan(c1) && fminf(c2, c1) < th.corner;
  const float s2 = d2 > 0.0f ? 1.0f : -1.0f, s1 = d1 > 0.0f ? 1.0f : -1.0f;
  float r0[3], r1[3];
  for (int i = 0; i < 3; ++i) {
    r0[i] = __fmul_rn(v2[i], s2);
    r1[i] = __fmul_rn(v1[i], s1);
  }
  const float r2[3] = {
      __fsub_rn(__fmul_rn(r0[1], r1[2]), __fmul_rn(r0[2], r1[1])),
      __fsub_rn(__fmul_rn(r0[2], r1[0]), __fmul_rn(r0[0], r1[2])),
      __fsub_rn(__fmul_rn(r0[0], r1[1]), __fmul_rn(r0[1], r1[0]))};
  for (int i = 0; i < 3; ++i) {
    R[3 * i] = r0[i];
    R[3 * i + 1] = r1[i];
    R[3 * i + 2] = r2[i];
  }
  flags[0] = !rej_grad && !rej_ratio && !rej_corner;
  flags[1] = rej_grad;
  flags[2] = rej_ratio;
  flags[3] = rej_corner;
}

struct Window {
  int nx, ny, nzs, z_origin, gnz;
  float u[3], inv[3];
  float sig_fctr, rad_fctr;
};

__global__ void ori_kernel(const float* __restrict__ levels,
                           const int64_t* __restrict__ lvl,
                           const float* __restrict__ centers,
                           const float* __restrict__ sd_in,
                           float* __restrict__ moments,
                           float* __restrict__ R_out,
                           bool* __restrict__ flags_out, Window win,
                           Thresholds th) {
  const int k = blockIdx.x;
  const float c[3] = {centers[3 * k], centers[3 * k + 1], centers[3 * k + 2]};
  const float sd = sd_in[k];
  const int n[3] = {win.nx, win.ny, win.gnz};
  const float sigma = __fmul_rn(sd, win.sig_fctr);
  const float rad = __fmul_rn(sigma, win.rad_fctr);
  int lo[3], ext[3];
  for (int a = 0; a < 3; ++a) {
    const float ra = __fdiv_rn(rad, win.u[a]);
    const float l = fmaxf(floorf(__fsub_rn(c[a], ra)), 1.0f);
    const float h = fminf(ceilf(__fadd_rn(c[a], ra)), (float)(n[a] - 2));
    lo[a] = (int)l;
    ext[a] = max(0, (int)h - (int)l + 1);
  }
  const float rad2 = __fmul_rn(rad, rad);
  const float sig2 = __fmul_rn(sigma, sigma);
  const int64_t sx = (int64_t)win.ny * win.nzs, sy = win.nzs;
  const float* level = levels + lvl[k] * win.nx * sx;
  // A box holds at most (n-2)^3 < 2^31 voxels: 32-bit index arithmetic.
  const int total = ext[0] * ext[1] * ext[2];
  if (total > 0 && (lo[2] - 1 < win.z_origin ||
                    lo[2] + ext[2] > win.z_origin + win.nzs - 1)) {
    const float nan = __int_as_float(0x7fc00000);
    if (threadIdx.x < 12) moments[12 * (int64_t)k + threadIdx.x] = nan;
    if (threadIdx.x < 9) R_out[9 * (int64_t)k + threadIdx.x] = nan;
    if (threadIdx.x < 4) flags_out[4 * (int64_t)k + threadIdx.x] = false;
    return;
  }

  float acc[kSums];
  for (int s = 0; s < kSums; ++s) acc[s] = 0.0f;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int z = lo[2] + t % ext[2];
    const int r = t / ext[2];
    const int y = lo[1] + r % ext[1];
    const int x = lo[0] + r / ext[1];
    const float dx = __fmul_rn(__fsub_rn((float)x, c[0]), win.u[0]);
    const float dy = __fmul_rn(__fsub_rn((float)y, c[1]), win.u[1]);
    const float dz = __fmul_rn(__fsub_rn((float)z, c[2]), win.u[2]);
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    if (!(sq <= rad2)) continue;
    const float w = expf(__fdiv_rn(__fmul_rn(-0.5f, sq), sig2));
    const float* p = level + x * sx + y * sy + (z - win.z_origin);
    const float gx =
        __fmul_rn(__fmul_rn(0.5f, __fsub_rn(p[sx], p[-sx])), win.inv[0]);
    const float gy =
        __fmul_rn(__fmul_rn(0.5f, __fsub_rn(p[sy], p[-sy])), win.inv[1]);
    const float gz =
        __fmul_rn(__fmul_rn(0.5f, __fsub_rn(p[1], p[-1])), win.inv[2]);
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
  if (warp != 0) return;
  const int nwarps = blockDim.x >> 5;
  float tot[kSums];
  for (int s = 0; s < kSums; ++s) {
    float v = lane < nwarps ? partial[s][lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    tot[s] = v;
  }
  if (lane != 0) return;
  const float A[9] = {tot[0], tot[1], tot[2], tot[1], tot[3],
                      tot[4], tot[2], tot[4], tot[5]};
  const float vd[3] = {tot[6], tot[7], tot[8]};
  float* o = moments + 12 * (int64_t)k;
  for (int i = 0; i < 9; ++i) o[i] = A[i];
  for (int i = 0; i < 3; ++i) o[9 + i] = vd[i];
  float R[9];
  bool flags[4];
  orient_one(A, vd, th, R, flags);
  for (int i = 0; i < 9; ++i) R_out[9 * (int64_t)k + i] = R[i];
  for (int i = 0; i < 4; ++i) flags_out[4 * (int64_t)k + i] = flags[i];
}

__global__ void eigh_kernel(const float* __restrict__ A, float* __restrict__ w,
                            float* __restrict__ V, int64_t count) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float a[9], wi[3], vi[9];
  for (int j = 0; j < 9; ++j) a[j] = A[9 * i + j];
  eigh3x3(a, wi, vi);
  for (int j = 0; j < 3; ++j) w[3 * i + j] = wi[j];
  for (int j = 0; j < 9; ++j) V[9 * i + j] = vi[j];
}

}  // namespace

// centers f32[K, 3]; moments f32[K, 12] = A (row-major) then vd; R f32[K,
// 3, 3]; flags bool[K, 4] = accepted, reject_grad, reject_ratio,
// reject_corner.
extern "C" int s3d_orient(const float* levels, const int64_t* lvl,
                          const float* centers, const float* sd,
                          float* moments, float* R, bool* flags, int K,
                          int nx, int ny, int nzs, int z_origin, int gnz,
                          float ux, float uy, float uz,
                          float ix, float iy, float iz, float sig_fctr,
                          float rad_fctr, float grad_thresh, float eig_ratio,
                          float corner_thresh, void* stream) {
  const Window win{nx, ny, nzs, z_origin, gnz, {ux, uy, uz}, {ix, iy, iz},
                   sig_fctr, rad_fctr};
  const Thresholds th{grad_thresh, eig_ratio, corner_thresh};
  ori_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, lvl, centers, sd, moments, R, flags, win, th);
  return static_cast<int>(cudaGetLastError());
}

// Batched eigh3x3: A f32[count, 3, 3] -> w f32[count, 3], V f32[count, 3, 3].
extern "C" int s3d_eigh3x3(const float* A, float* w, float* V, int64_t count,
                           void* stream) {
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  eigh_kernel<<<(unsigned int)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(A, w, V, count);
  return static_cast<int>(cudaGetLastError());
}

// Native IO runtime: fast NIfTI-1 payload handling and CSV serialization.
//
// The PyTorch port's own copy of sift3d_tpu/native/fastio.cc, the
// counterpart of the reference's native IO layer (nifticlib + zlib,
// nifti.c, and the CSV writer of imutil.c:405-479). The port loads it with
// ctypes (sift3d_tpu_torch/native.py), which builds it at first use:
//
//   g++ -O3 -shared -fPIC fastio.cc -o libs3d_fastio.so -lz
//
// Exposed C ABI:
//   s3d_read_all(path, out_buf, out_cap) -> bytes read (gunzipped) or -1
//   s3d_csv_write(path, data, rows, cols, gzipped) -> 0 / -1
//      formats with "%f" and comma/newline delimiters, matching the
//      reference's write_Mat_rm byte-for-byte.
//   s3d_cast_to_f32(src, dst, n, dtype_code, slope, inter, apply_scaling)
//      dtype codes follow the NIfTI-1 datatype field.
//   s3d_nifti_read_f32(path, out, cap, dims, units) -> 0 / error code
//      self-contained single-file NIfTI-1 read (header parse + gunzip +
//      typed cast + x-fastest -> C-order transpose, fused in one pass).
//   s3d_nifti_read_batch(paths, n, out, stride, dims, units, rc, nthreads)
//      std::thread fan-out of s3d_nifti_read_f32 over a batch of volumes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>
#include <zlib.h>

// ---------------------------------------------------------------------------
// typed payload -> float32 helper (template must live outside extern "C")
// ---------------------------------------------------------------------------

template <typename T>
static void cast_loop(const void *src, float *dst, long long n, float slope,
                      float inter, int apply) {
    const T *s = static_cast<const T *>(src);
    if (apply) {
        for (long long i = 0; i < n; i++)
            dst[i] = static_cast<float>(s[i]) * slope + inter;
    } else {
        for (long long i = 0; i < n; i++)
            dst[i] = static_cast<float>(s[i]);
    }
}

extern "C" {

// ---------------------------------------------------------------------------
// gzip-or-plain file reading
// ---------------------------------------------------------------------------

// Reads the whole (decompressed) file into out_buf (capacity out_cap).
// Works for both gzipped and plain files (zlib's gzopen transparently
// handles uncompressed data). Returns bytes read, or -1 on error.
long long s3d_read_all(const char *path, void *out_buf, long long out_cap) {
    gzFile f = gzopen(path, "rb");
    if (!f) return -1;
    // larger internal buffer helps bulk decompression speed
    gzbuffer(f, 1 << 20);
    long long total = 0;
    char *dst = static_cast<char *>(out_buf);
    while (total < out_cap) {
        int chunk = static_cast<int>(
            std::min<long long>(out_cap - total, 1 << 24));
        int got = gzread(f, dst + total, chunk);
        if (got < 0) { gzclose(f); return -1; }
        if (got == 0) break;
        total += got;
    }
    gzclose(f);
    return total;
}

// ---------------------------------------------------------------------------
// typed payload -> float32 with slope/intercept (read_nii semantics,
// reference nifti.c:101-155)
// ---------------------------------------------------------------------------

int s3d_cast_to_f32(const void *src, float *dst, long long n, int dtype,
                    float slope, float inter, int apply_scaling) {
    switch (dtype) {
        case 2: cast_loop<uint8_t>(src, dst, n, slope, inter, apply_scaling); break;
        case 4: cast_loop<int16_t>(src, dst, n, slope, inter, apply_scaling); break;
        case 8: cast_loop<int32_t>(src, dst, n, slope, inter, apply_scaling); break;
        case 16: cast_loop<float>(src, dst, n, slope, inter, apply_scaling); break;
        case 64: cast_loop<double>(src, dst, n, slope, inter, apply_scaling); break;
        case 256: cast_loop<int8_t>(src, dst, n, slope, inter, apply_scaling); break;
        case 512: cast_loop<uint16_t>(src, dst, n, slope, inter, apply_scaling); break;
        case 768: cast_loop<uint32_t>(src, dst, n, slope, inter, apply_scaling); break;
        case 1024: cast_loop<int64_t>(src, dst, n, slope, inter, apply_scaling); break;
        case 1280: cast_loop<uint64_t>(src, dst, n, slope, inter, apply_scaling); break;
        default: return -1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// CSV writer ("%f", ',' between columns, '\n' after the last column —
// write_Mat_rm, reference imutil.c:436-447)
// ---------------------------------------------------------------------------

int s3d_csv_write(const char *path, const double *data, long long rows,
                  long long cols, int gzipped) {
    // Serialize into an in-memory buffer first (snprintf "%f"), then write
    // in one call; dominates Python's per-value formatting by ~20x.
    std::vector<char> buf;
    buf.reserve(static_cast<size_t>(rows * cols * 12 + rows));
    char tmp[64];
    for (long long r = 0; r < rows; r++) {
        const double *row = data + r * cols;
        for (long long c = 0; c < cols; c++) {
            int len = snprintf(tmp, sizeof(tmp), "%f", row[c]);
            buf.insert(buf.end(), tmp, tmp + len);
            buf.push_back(c + 1 < cols ? ',' : '\n');
        }
    }
    if (gzipped) {
        gzFile f = gzopen(path, "wb");
        if (!f) return -1;
        gzbuffer(f, 1 << 20);
        if (gzwrite(f, buf.data(), static_cast<unsigned>(buf.size())) !=
            static_cast<int>(buf.size())) { gzclose(f); return -1; }
        if (gzclose(f) != Z_OK) return -1;
    } else {
        FILE *f = fopen(path, "wb");
        if (!f) return -1;
        size_t n = fwrite(buf.data(), 1, buf.size(), f);
        fclose(f);
        if (n != buf.size()) return -1;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Self-contained NIfTI-1 volume reader (batch data-loader fast path)
// ---------------------------------------------------------------------------

// Fused cast+scale+transpose of one channel's payload: the disk payload is
// x-fastest (Fortran order), the framework's arrays are [nx, ny, nz(, nc)]
// C order (read_nifti semantics, reference nifti.c:101-155). Cache-blocked
// over (x, z): within a 16x16 block the destination writes run contiguous
// in z and the 16 source planes' lines stay in L1 across x iterations.
template <typename T>
static void cast_transpose(const char *raw, float *out, long long nx,
                           long long ny, long long nz, long long nc,
                           long long c, float slope, float inter,
                           int apply) {
    const long long B = 16;
    const T *src = reinterpret_cast<const T *>(raw) + c * nx * ny * nz;
    for (long long x0 = 0; x0 < nx; x0 += B) {
        long long x1 = std::min(x0 + B, nx);
        for (long long y = 0; y < ny; y++) {
            for (long long z0 = 0; z0 < nz; z0 += B) {
                long long z1 = std::min(z0 + B, nz);
                for (long long x = x0; x < x1; x++) {
                    float *dst = out + (x * ny + y) * nz * nc + c;
                    const T *s = src + y * nx + x;
                    if (apply) {
                        for (long long z = z0; z < z1; z++)
                            dst[z * nc] = static_cast<float>(
                                s[z * nx * ny]) * slope + inter;
                    } else {
                        for (long long z = z0; z < z1; z++)
                            dst[z * nc] = static_cast<float>(s[z * nx * ny]);
                    }
                }
            }
        }
    }
}

typedef void (*cast_transpose_fn)(const char *, float *, long long,
                                  long long, long long, long long,
                                  long long, float, float, int);

static cast_transpose_fn cast_transpose_for(int dtype, int *itemsize) {
    switch (dtype) {
        case 2:    *itemsize = 1; return cast_transpose<uint8_t>;
        case 4:    *itemsize = 2; return cast_transpose<int16_t>;
        case 8:    *itemsize = 4; return cast_transpose<int32_t>;
        case 16:   *itemsize = 4; return cast_transpose<float>;
        case 64:   *itemsize = 8; return cast_transpose<double>;
        case 256:  *itemsize = 1; return cast_transpose<int8_t>;
        case 512:  *itemsize = 2; return cast_transpose<uint16_t>;
        case 768:  *itemsize = 4; return cast_transpose<uint32_t>;
        case 1024: *itemsize = 8; return cast_transpose<int64_t>;
        case 1280: *itemsize = 8; return cast_transpose<uint64_t>;
        default:   return nullptr;
    }
}

extern "C" {

// Reads one single-file NIfTI-1 volume (.nii / .nii.gz) to float32 in
// C order [nx, ny, nz] (or [nx, ny, nz, nc] for 4-D files). dims must
// hold 4 slots (nx, ny, nz, nc), units 3. Error codes:
//   -1 io error / truncated          -3 unsupported dimensionality
//   -2 not little-endian NIfTI-1     -4 unsupported datatype
//   -5 output capacity too small (dims/units are still filled)
// Big-endian files and .hdr/.img pairs return -2: the loader reads those
// with the numpy reader (io/nifti.py), by file; this function is the
// batch loader's hot path.
int s3d_nifti_read_f32(const char *path, float *out, long long cap,
                       long long *dims, float *units) {
    gzFile f = gzopen(path, "rb");
    if (!f) return -1;
    gzbuffer(f, 1 << 20);
    unsigned char hdr[348];
    if (gzread(f, hdr, 348) != 348) { gzclose(f); return -1; }

    int32_t sizeof_hdr;
    std::memcpy(&sizeof_hdr, hdr, 4);
    if (sizeof_hdr != 348) { gzclose(f); return -2; }
    // single-file magic "n+1"; "ni1" pairs + ANALYZE go to the numpy reader
    if (std::memcmp(hdr + 344, "n+1", 3) != 0) { gzclose(f); return -2; }

    int16_t dim[8], datatype;
    float pixdim[8], vox_offset, scl_slope, scl_inter;
    std::memcpy(dim, hdr + 40, sizeof(dim));
    std::memcpy(&datatype, hdr + 70, 2);
    std::memcpy(pixdim, hdr + 76, sizeof(pixdim));
    std::memcpy(&vox_offset, hdr + 108, 4);
    std::memcpy(&scl_slope, hdr + 112, 4);
    std::memcpy(&scl_inter, hdr + 116, 4);

    int ndim = dim[0];
    if (ndim == 4 && dim[4] == 1) ndim = 3;
    if (ndim != 3 && ndim != 4) { gzclose(f); return -3; }
    long long nx = dim[1], ny = dim[2], nz = dim[3];
    long long nc = ndim == 4 ? dim[4] : 1;
    if (nx <= 0 || ny <= 0 || nz <= 0 || nc <= 0) { gzclose(f); return -3; }

    int itemsize = 0;
    cast_transpose_fn run = cast_transpose_for(datatype, &itemsize);
    if (!run) { gzclose(f); return -4; }

    dims[0] = nx; dims[1] = ny; dims[2] = nz; dims[3] = nc;
    for (int a = 0; a < 3; a++)
        units[a] = pixdim[1 + a] > 0.0f ? pixdim[1 + a] : 1.0f;
    if (!(pixdim[1] > 0.0f && pixdim[2] > 0.0f && pixdim[3] > 0.0f))
        units[0] = units[1] = units[2] = 1.0f;

    long long count = nx * ny * nz * nc;
    if (count > cap) { gzclose(f); return -5; }

    if (vox_offset > 348.0f) {
        if (gzseek(f, static_cast<z_off_t>(vox_offset), SEEK_SET) < 0) {
            gzclose(f); return -1;
        }
    }

    float slope = scl_slope, inter = scl_inter;
    int apply = scl_slope != 0.0f;

    // Read the whole typed payload, then cast+transpose per channel with
    // the cache-blocked kernel (the 16x16 (x, z) blocking keeps both the
    // x-fastest source lines and the z-fastest destination lines hot).
    std::vector<char> raw(static_cast<size_t>(count) * itemsize);
    long long total = 0;
    while (total < static_cast<long long>(raw.size())) {
        int chunk = static_cast<int>(std::min<long long>(
            raw.size() - total, 1 << 24));
        int got = gzread(f, raw.data() + total, chunk);
        if (got <= 0) { gzclose(f); return -1; }
        total += got;
    }
    gzclose(f);
    for (long long c = 0; c < nc; c++)
        run(raw.data(), out, nx, ny, nz, nc, c, slope, inter, apply);
    return 0;
}

// Batch fan-out: volume i lands at out + i*stride, dims + i*4,
// units + i*3, result code in rc[i]. nthreads std::threads pull volumes
// from a shared atomic-ish counter (simple striding is fine at this
// granularity). GIL-free from Python: one ctypes call per batch.
void s3d_nifti_read_batch(const char **paths, int n, float *out,
                          long long stride, long long *dims, float *units,
                          int *rc, int nthreads) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > n) nthreads = n;
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; t++) {
        threads.emplace_back([=]() {
            for (int i = t; i < n; i += nthreads)
                rc[i] = s3d_nifti_read_f32(paths[i], out + i * stride,
                                           stride, dims + i * 4,
                                           units + i * 3);
        });
    }
    for (auto &th : threads) th.join();
}

}  // extern "C"

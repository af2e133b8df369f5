// Gram matrix K = k(X, Zᵀ) of blocked-CSR rows (fixed nnz_cap slots of
// column id / value, (0, 0) on padding), of one or more jobs, with the
// fused linear / poly / rbf epilogue of gram.cu.
//
// Replaces the TPU kernel src/repro/kernels/gram.py: sparse_gram
// (_sparse_gram_kernel, pl.pallas_call at line 201). It computes the
// same function: K_ij = Σ over slot pairs with equal column ids of
// x_v · z_v (duplicate ids sum, padding adds 0), f32 sums from f32-cast
// values, norms Σ v², the same transforms.
//
// It does NOT carry over the TPU's index match, which spends px·pz
// compare-selects on every pair (65536 at nnz_cap 256) to find the
// ~0.5 column ids two TF×IDF rows share at d = 131072. Instead Z's
// nonzero slots are handed in column-major order (a CSC view of Z,
// built once per call by the wrapper with a stable sort): for column c,
// the Z rows that hold it and their values. One warp owns one output
// row K[i, :]: it zeroes the row, then for each nonzero slot (c, v) of
// x_i walks Z's list of column c and adds v · z_v into K[i, z], then
// applies the transform to the row. The work is the index matches that
// exist plus one pass over K, not px·pz per pair. Slots are taken in a
// fixed order with a warp barrier after each, so reruns are
// bit-identical; the adds are atomics only so that a row that breaks
// the distinct-index contract still sums correctly.
//
// What bounds it on an H100: bytes — writing K (n·m·4 bytes) dominates
// the slot arrays, and the matched multiply-adds are few. The row is
// written, updated and transformed by one warp while it is hot in L2;
// each lane prefetches one slot's column id, value and list bounds so a
// warp waits for one list read per 32 slots, not three dependent reads
// per slot.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

enum Kind { kLinear = 0, kPoly = 1, kRbf = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Σ float(v)² over the slots of `rows` rows; one thread per row.
template <typename T>
__global__ void slot_sq_norms_kernel(const T* __restrict__ v, long long rows,
                                     int cap, float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* p = v + (size_t)r * cap;
  float s = 0.f;
  for (int k = 0; k < cap; ++k) {
    const float f = to_float(p[k]);
    s = fmaf(f, f, s);
  }
  out[r] = s;
}

struct XRows {
  const int* hi;          // home indices (jobs_x · per, cap)
  const void* hv;         // home values
  long long job_rows;     // rows between two jobs' home blocks (0: shared)
  int per;
  const int* si;          // shared indices (S, cap)
  const void* sv;
  int n;                  // per + S
  long long home_total;   // norm index of the first shared row
};

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sparse_gram_kernel(XRows x, int cap, int nz, const long long* __restrict__ off,
                   long long off_job_stride, const int* __restrict__ zrow,
                   const T* __restrict__ zval, int kind, float gamma,
                   float coef0, int degree, const float* __restrict__ xnorm,
                   const float* __restrict__ znorm, long long z_norm_job_rows,
                   int z_per, long long z_home_total, float* __restrict__ K) {
  const int job = blockIdx.y;
  const int i = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= x.n) return;
  const long long xr = i < x.per ? (long long)job * x.job_rows + i
                                 : (long long)(i - x.per);
  const int* xi = (i < x.per ? x.hi : x.si) + (size_t)xr * cap;
  const T* xv = static_cast<const T*>(i < x.per ? x.hv : x.sv) +
                (size_t)xr * cap;
  const long long* offj = off + (long long)job * off_job_stride;
  float* Krow = K + ((size_t)job * x.n + i) * nz;

  for (int c = lane; c < nz; c += 32) Krow[c] = 0.f;
  __syncwarp();

  for (int p0 = 0; p0 < cap; p0 += 32) {
    // lane q holds slot p0 + q: its value and Z's list [lo, hi)
    float v = 0.f;
    long long lo = 0, hi = 0;
    if (p0 + lane < cap) {
      v = to_float(xv[p0 + lane]);
      if (v != 0.f) {
        const int col = xi[p0 + lane];
        lo = offj[col];
        hi = offj[col + 1];
      }
    }
    const int slots = min(32, cap - p0);
    for (int q = 0; q < slots; ++q) {
      const float vq = __shfl_sync(0xffffffffu, v, q);
      const long long lq = __shfl_sync(0xffffffffu, lo, q);
      const long long hq = __shfl_sync(0xffffffffu, hi, q);
      for (long long e = lq + lane; e < hq; e += 32)
        atomicAdd(Krow + zrow[e], __fmul_rn(vq, to_float(zval[e])));
      __syncwarp();
    }
  }

  if (kind == kLinear) return;
  const float xn = kind == kRbf
      ? xnorm[i < x.per ? xr : x.home_total + xr] : 0.f;
  for (int c = lane; c < nz; c += 32) {
    const float acc = __ldcg(Krow + c);
    float out;
    if (kind == kPoly) {
      const float base = __fadd_rn(__fmul_rn(gamma, acc), coef0);
      out = 1.f;
      for (int e = 0; e < degree; ++e) out = __fmul_rn(out, base);
    } else {
      const long long zr = c < z_per ? (long long)job * z_norm_job_rows + c
                                     : z_home_total + (c - z_per);
      const float sq = __fsub_rn(__fadd_rn(xn, znorm[zr]),
                                 __fmul_rn(2.f, acc));
      out = expf(__fmul_rn(-gamma, fmaxf(sq, 0.f)));
    }
    Krow[c] = out;
  }
}

template <typename T>
cudaError_t norms(const void* v, long long rows, int cap, float* out,
                  cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  const int threads = 256;
  slot_sq_norms_kernel<T><<<(unsigned)((rows + threads - 1) / threads),
                            threads, 0, stream>>>(static_cast<const T*>(v),
                                                  rows, cap, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const XRows& x, long long x_shared, int cap, int jobs,
                   int nz, const long long* off, long long off_job_stride,
                   const int* zrow, const void* zval, int kind, float gamma,
                   float coef0, int degree, const void* zh_values,
                   long long z_job_rows, int z_per, long long z_home_total,
                   const void* zs_values, long long z_shared, float* xnorm,
                   float* znorm, float* K, cudaStream_t stream) {
  cudaError_t err;
  if (kind == kRbf) {
    if ((err = norms<T>(x.hv, x.home_total, cap, xnorm, stream))) return err;
    if ((err = norms<T>(x.sv, x_shared, cap, xnorm + x.home_total, stream)))
      return err;
    if ((err = norms<T>(zh_values, z_home_total, cap, znorm, stream)))
      return err;
    if ((err = norms<T>(zs_values, z_shared, cap, znorm + z_home_total,
                        stream)))
      return err;
  }
  const dim3 grid((x.n + kWarpsPerBlock - 1) / kWarpsPerBlock, jobs);
  sparse_gram_kernel<T><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(
      x, cap, nz, off, off_job_stride, zrow, static_cast<const T*>(zval),
      kind, gamma, coef0, degree, xnorm, znorm, z_job_rows, z_per,
      z_home_total, K);
  return cudaGetLastError();
}

}  // namespace

// K (jobs, nx, nz) f32. X rows of job l: home row l·x_job_rows + i for
// i < x_per, else shared row i − x_per; each row is `cap` slots of
// int32 column id and value (bf16 if is_bf16 else f32). Z comes as its
// CSC view: for job l (offsets at l·off_job_stride) and column c, the
// entries [off[c], off[c+1]) of zrow (Z row in 0..nz) and zval. Z's
// slot values (zh_values, zs_values, laid out like X's) are read only
// for the rbf norms. xnorm and znorm are scratch. kind: 0 linear,
// 1 poly, 2 rbf. Returns a cudaError_t (0 = ok).
extern "C" int sparse_gram(
    const int* xh_idx, const void* xh_val, long long x_job_rows, int x_per,
    long long x_home_total, const int* xs_idx, const void* xs_val,
    int x_shared, int cap, int jobs, int nz, const long long* off,
    long long off_job_stride, const int* zrow, const void* zval,
    const void* zh_val, long long z_job_rows, int z_per,
    long long z_home_total, const void* zs_val, int z_shared, int is_bf16,
    int kind, float gamma, float coef0, int degree, float* xnorm,
    float* znorm, float* K, void* stream) {
  const XRows x{xh_idx, xh_val, x_job_rows, x_per, xs_idx, xs_val,
                x_per + x_shared, x_home_total};
  if (jobs <= 0 || x.n <= 0 || nz <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(
        x, x_shared, cap, jobs, nz, off, off_job_stride, zrow, zval, kind,
        gamma, coef0, degree, zh_val, z_job_rows, z_per, z_home_total,
        zs_val, z_shared, xnorm, znorm, K, s);
  return launch<float>(x, x_shared, cap, jobs, nz, off, off_job_stride, zrow,
                       zval, kind, gamma, coef0, degree, zh_val, z_job_rows,
                       z_per, z_home_total, zs_val, z_shared, xnorm, znorm,
                       K, s);
}

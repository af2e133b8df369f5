// Dense Gram matrix K = k(X, Zᵀ) of one or more jobs, with a fused
// linear / poly / rbf epilogue.
//
// Replaces the TPU kernel src/repro/kernels/gram.py: gram
// (_gram_kernel, pl.pallas_call at line 83). As there, products are
// taken from float32-cast rows and summed in float32, γ and coef0 are
// runtime scalars, and the transform is applied to the finished sum:
//     linear: K = acc
//     poly:   K = (γ·acc + c0)^degree   (integer degree ≥ 0, repeated
//             multiplication — powf NaNs on negative bases)
//     rbf:    K = exp(−γ·max(‖x‖² + ‖z‖² − 2·acc, 0)), the squared norms
//             from the float32-cast rows (gram.py:76-77)
//
// Rows of job l come through two pointers, as in cd_solve.cu: row i is
// home row i of the job for i < per, else shared row i − per. A
// MapReduce round's L augmented partitions [X_l; SV_global] are so never
// copied; a plain (n, d) matrix is one job with no shared rows.
//
// What bounds it on an H100: operations. 2·n·m·d multiply-adds against
// (n + m)·d input bytes; at one full-width reducer Gram (10240² pairs,
// d = 131072) that is 2.75e13 flop, 27.8 ms at the bf16 tensor-core
// rate and 410 ms at the 67 TFLOP/s float32 rate outside the tensor
// cores, which is the most this kernel can reach. What its design does
// about it: 128 × 128 output tiles, 16-deep slices of X and Z staged in
// shared memory (transposed, so each thread reads its 8 rows and 8
// columns as float4), 8 × 8 float32 sums in registers per thread. The
// bf16 tensor-core path (mma/wgmma with float32 accumulation) is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output rows (X) per block
constexpr int kBN = 128;      // output columns (Z) per block
constexpr int kBK = 16;       // depth of one staged slice
constexpr int kTM = 8;        // rows per thread
constexpr int kTN = 8;        // columns per thread
constexpr int kThreads = 256;
constexpr int kPad = 4;       // keeps float4 alignment of the smem rows

enum Kind { kLinear = 0, kPoly = 1, kRbf = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

// Row i of job `job`: home rows first, then the shared rows.
struct RowSource {
  const void* home;
  long long job_rows;   // rows between two jobs' home blocks (0: shared)
  int per;              // home rows per job
  const void* shared;
  int n;                // per + shared rows
  long long home_total; // home rows of all jobs (norm index of shared)
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const RowSource& s, int job,
                                            int i, int d) {
  return i < s.per
             ? static_cast<const T*>(s.home) +
                   (size_t)((long long)job * s.job_rows + i) * d
             : static_cast<const T*>(s.shared) + (size_t)(i - s.per) * d;
}

__device__ __forceinline__ long long norm_index(const RowSource& s, int job,
                                                int i) {
  return i < s.per ? (long long)job * s.job_rows + i
                   : s.home_total + (i - s.per);
}

// Σ_k float(x_k)² of `rows` contiguous rows; one warp per row.
template <typename T>
__global__ void row_sq_norms_kernel(const T* __restrict__ x, long long rows,
                                    int d, float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* p = x + (size_t)r * d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float v = to_float(p[k]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[r] = s;
}

template <typename T, bool kVectorized>
__device__ __forceinline__ void load_slice(const T* row, int k0, int d,
                                           float* v) {
  if (row == nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
  } else if (kVectorized && k0 + 8 <= d) {
    load8(row + k0, v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = k0 + e < d ? to_float(row[k0 + e]) : 0.f;
  }
}

template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
gram_kernel(RowSource xs, RowSource zs, int d, int kind, float gamma,
            float coef0, int degree, const float* __restrict__ xnorm,
            const float* __restrict__ znorm, float* __restrict__ K) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];

  const int job = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / (kBN / kTN);   // 0..15: row group
  const int tx = tid % (kBN / kTN);   // 0..15: column group
  // Staging: each thread brings 8 consecutive depth elements of one row.
  const int lr = tid >> 1;            // 0..127
  const int lk = (tid & 1) * 8;       // 0 or 8
  const T* xrow = m0 + lr < xs.n ? row_ptr<T>(xs, job, m0 + lr, d) : nullptr;
  const T* zrow = n0 + lr < zs.n ? row_ptr<T>(zs, job, n0 + lr, d) : nullptr;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    float xv[8], zv[8];
    load_slice<T, kVectorized>(xrow, k0 + lk, d, xv);
    load_slice<T, kVectorized>(zrow, k0 + lk, d, zv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      As[lk + e][lr] = xv[e];
      Bs[lk + e][lr] = zv[e];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][ty * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* Kj = K + (size_t)job * xs.n * zs.n;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + ty * kTM + i;
    if (r >= xs.n) continue;
    const float xn = kind == kRbf ? xnorm[norm_index(xs, job, r)] : 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tx * kTN + j;
      if (c >= zs.n) continue;
      float v = acc[i][j];
      if (kind == kPoly) {
        const float base = __fadd_rn(__fmul_rn(gamma, v), coef0);
        v = 1.f;
        for (int e = 0; e < degree; ++e) v = __fmul_rn(v, base);
      } else if (kind == kRbf) {
        const float zn = znorm[norm_index(zs, job, c)];
        const float sq = __fsub_rn(__fadd_rn(xn, zn), __fmul_rn(2.f, v));
        v = expf(__fmul_rn(-gamma, fmaxf(sq, 0.f)));
      }
      Kj[(size_t)r * zs.n + c] = v;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t norms(const void* x, long long rows, int d, float* out,
                  cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  constexpr int kWarpsPerBlock = 8;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_sq_norms_kernel<T><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                           stream>>>(static_cast<const T*>(x), rows, d, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const RowSource& xs, const RowSource& zs, long long x_shared,
                   long long z_shared, int jobs, int d, int kind, float gamma,
                   float coef0, int degree, float* xnorm, float* znorm,
                   float* K, cudaStream_t stream) {
  cudaError_t err;
  if (kind == kRbf) {
    if ((err = norms<T>(xs.home, xs.home_total, d, xnorm, stream))) return err;
    if ((err = norms<T>(xs.shared, x_shared, d, xnorm + xs.home_total,
                        stream)))
      return err;
    if ((err = norms<T>(zs.home, zs.home_total, d, znorm, stream))) return err;
    if ((err = norms<T>(zs.shared, z_shared, d, znorm + zs.home_total,
                        stream)))
      return err;
  }
  const bool vec = d % 8 == 0 && aligned16(xs.home) && aligned16(zs.home) &&
                   (x_shared == 0 || aligned16(xs.shared)) &&
                   (z_shared == 0 || aligned16(zs.shared));
  const dim3 grid((zs.n + kBN - 1) / kBN, (xs.n + kBM - 1) / kBM, jobs);
  if (vec)
    gram_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xs, zs, d, kind, gamma, coef0, degree, xnorm, znorm, K);
  else
    gram_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xs, zs, d, kind, gamma, coef0, degree, xnorm, znorm, K);
  return cudaGetLastError();
}

}  // namespace

// K (jobs, nx, nz) f32 with nx = x_per + x_shared, nz = z_per + z_shared.
// X rows of job l: xh[l·x_job_rows + i] for i < x_per, else
// xs[i − x_per]; likewise Z. x_home_total/z_home_total are the home rows
// of all jobs. Rows are bf16 if is_bf16 else f32, all of one type.
// xnorm (x_home_total + x_shared) and znorm are scratch, read only for
// rbf. kind: 0 linear, 1 poly, 2 rbf. Returns a cudaError_t (0 = ok).
extern "C" int gram(const void* xh, long long x_job_rows, int x_per,
                    long long x_home_total, const void* xs, int x_shared,
                    const void* zh, long long z_job_rows, int z_per,
                    long long z_home_total, const void* zs, int z_shared,
                    int jobs, int d, int is_bf16, int kind, float gamma,
                    float coef0, int degree, float* xnorm, float* znorm,
                    float* K, void* stream) {
  const RowSource x{xh, x_job_rows, x_per, xs, x_per + x_shared,
                    x_home_total};
  const RowSource z{zh, z_job_rows, z_per, zs, z_per + z_shared,
                    z_home_total};
  if (jobs <= 0 || x.n <= 0 || z.n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, z, x_shared, z_shared, jobs, d, kind,
                                 gamma, coef0, degree, xnorm, znorm, K, s);
  return launch<float>(x, z, x_shared, z_shared, jobs, d, kind, gamma, coef0,
                       degree, xnorm, znorm, K, s);
}

// Dense Gram matrix K = k(X, Zᵀ) of one or more jobs, with a fused
// linear / poly / rbf epilogue: two routes, chosen by the rows' dtype.
//
// Replaces the TPU kernel src/repro/kernels/gram.py: gram
// (_gram_kernel, pl.pallas_call at line 83). As there, products are
// taken from float32-cast rows and summed in float32, γ and coef0 are
// runtime values (one of each a job, read from the card, so that a
// sweep over kernel scales runs in one launch), and the transform is
// applied to the finished sum:
//     linear: K = acc
//     poly:   K = (γ·acc + c0)^degree   (integer degree ≥ 0, repeated
//             multiplication — powf NaNs on negative bases)
//     rbf:    K = exp(−γ·max(‖x‖² + ‖z‖² − 2·acc, 0)), the squared norms
//             from the float32-cast rows (gram.py:76-77)
//
// Rows of job l come through per-row pointers (row_ptr), as in
// cd_solve.cu: row i is row i of home block l % n_home for i < per,
// else row i − per of shared block l / jobs_per_shared. A MapReduce
// round's L augmented partitions [X_l; SV_global] are so never copied,
// nor a sweep's S·L ones [X_l; SV_s]; a plain (n, d) matrix is one job
// with no shared rows.
//
// What bounds it on an H100: operations. 2·n·m·d multiply-adds against
// (n + m)·d input bytes; at one full-width reducer Gram (10240² pairs,
// d = 131072, symmetric) the n(n + 1)·d distinct flop take 13.9 ms at
// the 989 TFLOP/s bf16 tensor-core rate and ~205 ms at the 67 TFLOP/s
// float32 rate outside the tensor cores.
//
// bf16 rows: the tensor cores (gram_tc). A bf16 × bf16 product is exact
// in float32, so wgmma (m64n256k16, bf16 → f32) computes the reference's
// function; only the order of the sums changes. Each CTA computes one
// 128 × 256 tile of K: two consumer warpgroups run wgmma on 64 rows each
// (128 float32 sums a thread); two producer warps copy 64-deep (128-byte)
// slices of the tile's X and Z rows into a ring of 4 shared-memory
// stages (48 KB each) with cp.async, through the per-row pointers (so a
// tile may straddle the home/shared boundary, and ragged n and d are
// zero-filled), in the 128-byte swizzled layout wgmma reads. Full/empty
// mbarriers hand the stages over: up to 4 slices stay in flight while
// the tensor cores work, and no block-wide barrier stands in the loop.
// The 128 × 256 tile asks shared memory and L2 for 48 KB per 4.2 Mflop,
// 3/4 of what a 128 × 128 tile asks (PERF.md has what still holds it
// at about half the tensor-core rate). When both sides are the same rows (the
// wrapper's flag), only tiles holding a pair r ≤ c are computed, each
// pair is stored twice, at (r, c) and at (c, r), from the same fragment
// (each quad of lanes fills whole 32-byte sectors of K in both
// directions), so K equals its transpose bit for bit, and the norms are
// computed once. Tiles are ordered in bands of 8 tile rows, so that the
// CTAs in flight share their X and Z slices in L2.
//
// float32 rows: SIMT FMAs (gram), as the golden Gram pipeline runs them
// (TF32 stays off): 128 × 128 output tiles, 16-deep slices of X and Z
// staged in shared memory (transposed, so each thread reads its 8 rows
// and 8 columns as float4), 8 × 8 float32 sums in registers per thread.
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

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

// Row i of job `job`: the rows of its home block first, then those of
// its shared block.
struct RowSource {
  const void* home;
  int n_home;           // home blocks; job l's is l % n_home
  int per;              // rows a home block
  const void* shared;
  int n_shared;         // rows a shared block
  int jps;              // jobs a shared block; job l's is l / jps
  int n;                // per + n_shared
  long long home_total; // rows of all home blocks (norm index of shared)
};

// Index of row i of job `job` among all home rows, then all shared rows.
__device__ __forceinline__ long long row_index(const RowSource& s, int job,
                                               int i) {
  return i < s.per ? (long long)(job % s.n_home) * s.per + i
                   : s.home_total + (long long)(job / s.jps) * s.n_shared +
                         (i - s.per);
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const RowSource& s, int job,
                                            int i, int d) {
  const long long r = row_index(s, job, i);
  return i < s.per ? static_cast<const T*>(s.home) + (size_t)r * d
                   : static_cast<const T*>(s.shared) +
                         (size_t)(r - s.home_total) * d;
}

// A side's row norms for one job: row i's is home[i] for i < per, else
// shared[i]; the block offsets are taken once a job, not once a pair.
struct JobNorms {
  const float* home;
  const float* shared;
  int per;

  __device__ __forceinline__ float operator[](int i) const {
    return i < per ? home[i] : shared[i];
  }
};

__device__ __forceinline__ JobNorms job_norms(const RowSource& s,
                                              const float* norms, int job) {
  return JobNorms{norms + (long long)(job % s.n_home) * s.per,
                  norms + s.home_total + (long long)(job / s.jps) * s.n_shared -
                      s.per,
                  s.per};
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
gram_kernel(RowSource xs, RowSource zs, int d, int kind,
            const float* __restrict__ gammas, const float* __restrict__ coef0s,
            int degree, const float* __restrict__ xnorm,
            const float* __restrict__ znorm, float* __restrict__ K) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];

  const int job = blockIdx.z;
  const float gamma = gammas[job], coef0 = coef0s[job];
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
  const JobNorms xnj = job_norms(xs, xnorm, job);
  const JobNorms znj = job_norms(zs, znorm, job);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + ty * kTM + i;
    if (r >= xs.n) continue;
    const float xn = kind == kRbf ? xnj[r] : 0.f;
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
        const float zn = znj[c];
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
cudaError_t side_norms(const RowSource& s, long long shared_rows, int d,
                       float* out, cudaStream_t stream) {
  cudaError_t err = norms<T>(s.home, s.home_total, d, out, stream);
  if (err != cudaSuccess) return err;
  return norms<T>(s.shared, shared_rows, d, out + s.home_total, stream);
}

cudaError_t launch_simt(const RowSource& xs, const RowSource& zs, int jobs,
                        int d, int kind, const float* gamma,
                        const float* coef0, int degree,
                        const float* xnorm, const float* znorm, float* K,
                        cudaStream_t stream) {
  const bool vec = d % 8 == 0 && aligned16(xs.home) && aligned16(zs.home) &&
                   aligned16(xs.shared) && aligned16(zs.shared);
  const dim3 grid((zs.n + kBN - 1) / kBN, (xs.n + kBM - 1) / kBM, jobs);
  if (vec)
    gram_kernel<float, true><<<grid, kThreads, 0, stream>>>(
        xs, zs, d, kind, gamma, coef0, degree, xnorm, znorm, K);
  else
    gram_kernel<float, false><<<grid, kThreads, 0, stream>>>(
        xs, zs, d, kind, gamma, coef0, degree, xnorm, znorm, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 rows: wgmma on the tensor cores, fed by a cp.async ring.
namespace tc {

constexpr int kBM = 128;                  // tile rows (X), two warpgroups
constexpr int kBN = 256;                  // tile columns (Z)
constexpr int kBK = 64;                   // slice depth: 128 bytes of a row
constexpr int kStages = 4;
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kProducers = 64;            // two warps
constexpr int kThreads = kConsumers + kProducers;
constexpr int kRowsPerPass = kProducers / 8;  // rows a pass of 16-byte copies
constexpr int kCopies = (kBM + kBN) / kRowsPerPass;  // per producer, slice
constexpr int kBytesX = kBM * kBK * 2;      // 16 KB of X a stage
constexpr int kStageBytes = (kBM + kBN) * kBK * 2;  // + 32 KB of Z
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
constexpr int kBand = 8;                  // tile rows per band (L2 reuse)
constexpr unsigned kSpinLimit = 1u << 22; // a lost hand-over traps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (unsigned spins = 0; !mbar_try(bar, parity); ++spins)
    if (spins == kSpinLimit) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// 16 bytes global → shared; zero-filled when !valid (src is not read).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// K-major operand in the 128-byte swizzled layout: rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO), 16-byte chunk c of row r stored
// at chunk c ^ (r % 8).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Column tiles of Z that tile row bi of a symmetric K needs: those with
// a column at or past the tile's first row.
__host__ __device__ __forceinline__ int first_col_tile(int bi) {
  return bi * kBM / kBN;
}

// Tile (bi, bj) of linear index t: bands of kBand tile rows, each walked
// column by column; the symmetric grid keeps the tiles that hold a pair
// (r, c) with r ≤ c.
__device__ __forceinline__ void tile_of(int t, int tm, int tn, bool sym,
                                        int& bi, int& bj) {
  for (int g0 = 0;; g0 += kBand) {
    const int rows = min(kBand, tm - g0);
    for (bj = 0; bj < tn; ++bj) {
      // tile rows g0 .. g0 + cnt − 1 of this column; symmetric: those
      // with first_col_tile(bi) ≤ bj, i.e. bi·kBM < (bj + 1)·kBN
      const int cnt =
          sym ? max(0, min(rows, ((bj + 1) * kBN + kBM - 1) / kBM - g0))
              : rows;
      if (t < cnt) {
        bi = g0 + t;
        return;
      }
      t -= cnt;
    }
  }
}

__device__ __forceinline__ float epilogue(float v, int kind, float gamma,
                                          float coef0, int degree, float xn,
                                          float zn) {
  if (kind == kPoly) {
    const float base = __fadd_rn(__fmul_rn(gamma, v), coef0);
    v = 1.f;
    for (int e = 0; e < degree; ++e) v = __fmul_rn(v, base);
  } else if (kind == kRbf) {
    const float sq = __fsub_rn(__fadd_rn(xn, zn), __fmul_rn(2.f, v));
    v = expf(__fmul_rn(-gamma, fmaxf(sq, 0.f)));
  }
  return v;
}

// Producer warps: thread p copies 16-byte chunk p % 8 of rows p / 8 +
// 8·j of the stage: the X tile's rows first, then the Z tile's.
template <bool kVec>
__device__ __forceinline__ void produce(const RowSource& xs,
                                        const RowSource& zs, int job, int m0,
                                        int n0, int d, int slices,
                                        uint32_t tiles, uint32_t full,
                                        uint32_t empty) {
  const int p = threadIdx.x - kConsumers;
  const int c = p & 7;
  const int r0 = p >> 3;
  const uint32_t sw = (uint32_t)((c ^ (r0 & 7)) << 4);
  const __nv_bfloat16* any = row_ptr<__nv_bfloat16>(xs, job, 0, d);
  // Row j of the stage; the cp.async route keeps the pointers in
  // registers, the element-wise route (rare) recomputes them.
  auto row_of = [&](int j) -> const __nv_bfloat16* {
    const bool is_x = j < kBM / kRowsPerPass;
    const int r = r0 + kRowsPerPass * j - (is_x ? 0 : kBM) + (is_x ? m0 : n0);
    const RowSource& side = is_x ? xs : zs;
    return r < side.n ? row_ptr<__nv_bfloat16>(side, job, r, d) : nullptr;
  };
  const __nv_bfloat16* rows[kVec ? kCopies : 1];
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < kCopies; ++j) rows[j] = row_of(j);
  }
  for (int s = 0; s < slices; ++s) {
    const int st = s % kStages;
    if (s >= kStages) mbar_wait(empty + 8 * st, (s / kStages - 1) & 1);
    const int k = s * kBK + 8 * c;
    const uint32_t base = tiles + st * kStageBytes + r0 * 128 + sw;
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const uint32_t dst = base + j * kRowsPerPass * 128;
      if constexpr (kVec) {
        const bool ok = rows[j] != nullptr && k < d;
        cp16(dst, ok ? rows[j] + k : any, ok);
      } else {
        const __nv_bfloat16* row = row_of(j);
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t pair = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (row != nullptr && k + 2 * q + e < d)
              pair |= (uint32_t)__bfloat16_as_ushort(row[k + 2 * q + e])
                      << (16 * e);
          w[q] = pair;
        }
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(dst),
                     "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                     : "memory");
      }
    }
    if (kVec)
      cp_async_arrive(full + 8 * st);
    else
      mbar_arrive(full + 8 * st);
  }
  if (kVec) asm volatile("cp.async.wait_all;" ::: "memory");
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
gram_tc_kernel(RowSource xs, RowSource zs, int d, int sym, int kind,
               const float* __restrict__ gammas,
               const float* __restrict__ coef0s, int degree,
               const float* __restrict__ xnorm,
               const float* __restrict__ znorm, float* __restrict__ K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t tiles = (raw + 1023) & ~1023u;   // 1024-aligned for SW128
  const uint32_t full = tiles + kStages * kStageBytes;
  const uint32_t empty = full + 8 * kStages;
  const int tm = (xs.n + kBM - 1) / kBM;
  const int tn = (zs.n + kBN - 1) / kBN;
  int bi, bj;
  tile_of(blockIdx.x, tm, tn, sym != 0, bi, bj);
  const int job = blockIdx.z;
  const float gamma = gammas[job], coef0 = coef0s[job];
  const int m0 = bi * kBM, n0 = bj * kBN;
  const int slices = (d + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, kProducers);
      mbar_init(empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    produce<kVec>(xs, zs, job, m0, n0, d, slices, tiles, full, empty);
    return;
  }

  // Consumers: warpgroup wg takes rows 64·wg .. 64·wg + 63 of the tile.
  const int wg = threadIdx.x / 128;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  fence_operands(acc);
  for (int s = 0; s < slices; ++s) {
    const int st = s % kStages;
    mbar_wait(full + 8 * st, (s / kStages) & 1);
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint32_t a = tiles + st * kStageBytes + wg * 64 * 128;
    const uint32_t b = tiles + st * kStageBytes + kBytesX;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n256k16(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the slice before this one is no longer read: hand its stage back
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (s > 0) mbar_arrive(empty + 8 * ((s - 1) % kStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_operands(acc);

  // acc[4j + e]: row 16·warp + lane/4 (+8 for e ≥ 2), column 8j +
  // 2·(lane % 4) + (e & 1) of this warpgroup's 64 × 256 block.
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  float* Kj = K + (size_t)job * xs.n * zs.n;
  const JobNorms xnj = job_norms(xs, xnorm, job);
  const JobNorms znj = job_norms(zs, znorm, job);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (r >= xs.n) continue;
    const float xn = kind == kRbf ? xnj[r] : 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n0 + 8 * j + 2 * (lane & 3) + e;
        if (c >= zs.n) continue;
        // a symmetric K takes each pair once, from the upper triangle
        if (sym != 0 && c < r) continue;
        const float zn = kind == kRbf ? znj[c] : 0.f;
        const float v = epilogue(acc[4 * j + 2 * h + e], kind, gamma, coef0,
                                 degree, xn, zn);
        Kj[(size_t)r * zs.n + c] = v;
        if (sym != 0 && c != r) Kj[(size_t)c * zs.n + r] = v;
      }
    }
  }
}

cudaError_t launch(const RowSource& xs, const RowSource& zs, int jobs, int d,
                   bool sym, int kind, const float* gamma, const float* coef0,
                   int degree,
                   const float* xnorm, const float* znorm, float* K,
                   cudaStream_t stream) {
  const long long tm = (xs.n + kBM - 1) / kBM, tn = (zs.n + kBN - 1) / kBN;
  long long tiles = tm * tn;
  if (sym) {
    tiles = 0;
    for (int bi = 0; bi < tm; ++bi) tiles += tn - first_col_tile(bi);
  }
  const bool vec = d % 8 == 0 && aligned16(xs.home) && aligned16(zs.home) &&
                   aligned16(xs.shared) && aligned16(zs.shared);
  const dim3 grid((unsigned)tiles, 1, jobs);
  auto kernel = vec ? gram_tc_kernel<true> : gram_tc_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(xs, zs, d, sym ? 1 : 0,
                                                 kind, gamma, coef0, degree,
                                                 xnorm, znorm, K);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// K (jobs, nx, nz) f32 with nx = x_per + x_shared, nz = z_per + z_shared.
// X rows of job l: row i of home block l % x_n_home (xh, x_per rows a
// block) for i < x_per, else row i − x_per of shared block l /
// x_jps (xs, x_shared rows a block); likewise Z. x_home_total /
// x_shared_total are the rows of all home / shared blocks. Rows are
// bf16 if is_bf16 (the tensor-core route) else f32 (the SIMT route),
// all of one type. symmetric: Z's rows are X's (same pointers and
// counts), so only tiles on or above the diagonal are computed
// (tensor-core route) and the norms once. xnorm (x_home_total +
// x_shared_total) and znorm are scratch, read only for rbf. kind: 0
// linear, 1 poly, 2 rbf; gamma, coef0 (jobs,) f32, each job's own.
// *route ← 1 for the tensor-core route, 0 for SIMT. Returns a
// cudaError_t (0 = ok).
extern "C" int gram(const void* xh, int x_n_home, int x_per,
                    long long x_home_total, const void* xs, int x_shared,
                    int x_jps, long long x_shared_total, const void* zh,
                    int z_n_home, int z_per, long long z_home_total,
                    const void* zs, int z_shared, int z_jps,
                    long long z_shared_total, int jobs, int d, int is_bf16,
                    int symmetric, int kind, const float* gamma,
                    const float* coef0, int degree, float* xnorm,
                    float* znorm, float* K, int* route, void* stream) {
  const RowSource x{xh, x_n_home, x_per, xs, x_shared, x_jps,
                    x_per + x_shared, x_home_total};
  const RowSource z{zh, z_n_home, z_per, zs, z_shared, z_jps,
                    z_per + z_shared, z_home_total};
  *route = is_bf16 ? 1 : 0;
  if (jobs <= 0 || x.n <= 0 || z.n <= 0) return cudaSuccess;
  if (x_n_home < 1 || z_n_home < 1 || x_jps < 1 || z_jps < 1)
    return cudaErrorInvalidValue;
  if (symmetric &&
      (xh != zh || xs != zs || x_n_home != z_n_home || x_per != z_per ||
       x_shared != z_shared || x_jps != z_jps ||
       x_home_total != z_home_total || x_shared_total != z_shared_total))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zn = symmetric ? xnorm : znorm;
  cudaError_t err;
  if (kind == kRbf) {
    err = is_bf16
              ? side_norms<__nv_bfloat16>(x, x_shared_total, d, xnorm, s)
              : side_norms<float>(x, x_shared_total, d, xnorm, s);
    if (err != cudaSuccess) return err;
    if (!symmetric) {
      err = is_bf16
                ? side_norms<__nv_bfloat16>(z, z_shared_total, d, znorm, s)
                : side_norms<float>(z, z_shared_total, d, znorm, s);
      if (err != cudaSuccess) return err;
    }
  }
  if (is_bf16)
    return tc::launch(x, z, jobs, d, symmetric != 0, kind, gamma, coef0,
                      degree, xnorm, zn, K, s);
  return launch_simt(x, z, jobs, d, kind, gamma, coef0, degree, xnorm, zn, K,
                     s);
}

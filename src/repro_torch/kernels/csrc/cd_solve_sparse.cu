// Dual coordinate-descent solve of L binary SVMs on blocked-CSR rows,
// one CTA per job (the cd_solve/sparse route).
//
// The reference has no Pallas kernel for this: src/repro/core/svm.py:
// fit_binary_linear (lines 154-201) runs it as XLA gathers and scatters
// inside a fori_loop. It computes on blocked-CSR rows what the TPU
// kernel src/repro/kernels/svm_step.py: cd_epoch (pl.pallas_call at line
// 81) computes on dense rows, with the same contract as csrc/cd_solve.cu:
// the whole solve, every epoch with the reference's stop rule
// (src/repro/core/svm.py:206-222), the epochs run and the violation.
//
// Rows are nnz_cap (column id, value) slots, values f32 or bf16 (read
// as stored, computed in f32). Per job l and epoch, the rows i = 0..n-1
// of [home rows of job l; shared rows] go in order:
//     w·x_i = Σ_s w[id_s] v_s,  g = y_i (w·x_i + b) − 1
//     α_i ← clip(α_i − g/Q_ii, 0, C);  Δ = (α_new − α_old)·m_i
//     w[id_s] += Δ y_i v_s;  b += Δ y_i;  viol = max(viol, |pg_i| m_i)
// with Q_ii = Σ_s v_s² + 1 (1 on masked rows), computed once per row
// before the epochs, Σ_s v_s² rounded to the values' type as the
// reference rounds it (bf16 values give a bf16 Σ v², svm.py:165). Home rows and the shared rows (SV_global) come
// through two pointers each, so the augmented partitions are never
// copied.
//
// Contracts of the rows (repro_torch/sparse.py): padding slots are
// (index 0, value 0.0), and dead SV slots keep their ids with value 0;
// the column ids of a row's live slots are distinct.
//
// What bounds it on an H100: the row recurrence, not bytes. The least
// time for the work is the rows' slots read once per epoch (8 jobs ×
// 10240 rows × 256 slots × 6 bytes = 126 MB in bf16, 0.038 ms at
// 3.35 TB/s), but each row needs the w of the row before, so a job is
// a chain of n dependent (gather, reduce, update, scatter) steps and
// the chain's latency per row sets the time.
//
// Design. One CTA a job, w (d floats) in the job's row of the output,
// which the launcher zeroes; at d = 131072 the L jobs' w is 4 MB and
// stays in the 50 MB L2. A CTA has up to 8 warps; thread t owns the
// slots t, t + T, ... of every row (kSpt of them, nnz_cap ≤ 8 × 256).
// Rows do not depend on w, so each thread loads its slots and the row's
// (y, m, Q, α) for row i + 1 while row i is reduced. Per row:
//   - each thread gathers w at its live slots (value ≠ 0) and keeps the
//     values it read;
//   - the products are summed in a fixed order (the thread's slots in
//     order, a warp's lanes by xor shuffles, the warps in order through
//     shared memory), so every thread reads the same w·x and computes
//     the same α update, Δ and b itself: no second barrier to broadcast
//     them, and reruns are bit-identical;
//   - if Δ ≠ 0 (the same branch in every thread), each thread writes
//     w[id] = w_read + Δ y v at its live slots and a barrier follows
//     before the next row's gather. Distinct ids make each column one
//     thread's within a row, so no atomics are needed. Skipping value-0
//     slots is what keeps a padding slot (id 0) from writing back a
//     stale w[0] over a real column 0 of the same row; both skips are
//     exact, as the reference adds zeros there.
// The partials of consecutive rows alternate between two shared slots,
// so a row whose Δ is 0 needs one barrier, not two.
//
// Sums are taken in another order than the plain version's; α, w and b
// agree with it to float32 rounding. The update itself is rounded as
// the plain version rounds it (Δy·v, then the add).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMaxSpt = 8;                    // slots a thread, at most
constexpr int kMaxCap = kMaxSpt * kMaxThreads;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and back: identity for f32, to nearest-even for bf16.
template <typename T>
__device__ __forceinline__ float round_as(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A row as one thread holds it: its slots and the row's scalars.
template <int kSpt>
struct Row {
  int id[kSpt];
  float v[kSpt];
  float y, m, q, a;
};

template <typename T, int kSpt>
__device__ __forceinline__ Row<kSpt> load_row(const int* ri, const T* rv,
                                              int cap, int tid, int threads,
                                              const float* y, const float* m,
                                              const float* q, const float* a,
                                              int i) {
  Row<kSpt> r;
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    const int s = k * threads + tid;
    r.id[k] = s < cap ? ri[s] : 0;
    r.v[k] = s < cap ? to_float(rv[s]) : 0.f;
  }
  r.y = y[i];
  r.m = m[i];
  r.q = q[i];
  r.a = a[i];
  return r;
}

template <typename T, int kSpt>
__global__ void __launch_bounds__(kMaxThreads)
cd_solve_sparse_kernel(const int* __restrict__ xh_idx,
                       const T* __restrict__ xh_val,
                       const int* __restrict__ xs_idx,
                       const T* __restrict__ xs_val,
                       const float* __restrict__ y,
                       const float* __restrict__ m, int per, int n_shared,
                       int cap, float C, float tol, int max_epochs, int d,
                       float* __restrict__ q, float* __restrict__ alpha,
                       float* w_all, float* __restrict__ b_out,
                       int* __restrict__ epochs_out,
                       float* __restrict__ viol_out) {
  __shared__ float red[2][kMaxWarps];

  const int job = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int n = per + n_shared;
  const int* hidx = xh_idx + (size_t)job * per * cap;
  const T* hval = xh_val + (size_t)job * per * cap;
  const float* yj = y + (size_t)job * n;
  const float* mj = m + (size_t)job * n;
  float* aj = alpha + (size_t)job * n;
  float* qj = q + (size_t)job * n;
  // w is read and written by every thread of the CTA: plain loads and
  // stores, ordered by the barriers (no read-only cache path).
  float* w = w_all + (size_t)job * d;

  auto row_idx = [&](int i) {
    return i < per ? hidx + (size_t)i * cap : xs_idx + (size_t)(i - per) * cap;
  };
  auto row_val = [&](int i) {
    return i < per ? hval + (size_t)i * cap : xs_val + (size_t)(i - per) * cap;
  };

  // Q_ii once per row (a warp a row, a fixed order), α = 0. Σ v² is
  // rounded as the reference's jitted sparse.row_sq_norms rounds it
  // (svm.py:165): f32 products (exact for bf16) summed in f32, the sum
  // rounded to the values' type; no fma, so that the plain version
  // (ref.sparse_sq_norms, the same order) rounds alike.
  for (int i = warp; i < n; i += warps) {
    const T* v = row_val(i);
    float s = 0.f;
    for (int k = lane; k < cap; k += 32) {
      const float x = to_float(v[k]);
      s = __fadd_rn(s, __fmul_rn(x, x));
    }
    s = round_as<T>(warp_sum(s));
    if (lane == 0) {
      qj[i] = mj[i] > 0.f ? __fadd_rn(s, 1.f) : 1.f;
      aj[i] = 0.f;
    }
  }

  // Every thread holds the job's state and computes it identically.
  float b = 0.f;
  float viol = INFINITY;
  int t = 0;
  while (t < max_epochs && (t == 0 || viol > tol)) {
    // Q, α and w of the epoch before are visible to every thread.
    __syncthreads();
    float viol_ep = 0.f;
    Row<kSpt> r = {};
    if (n > 0)
      r = load_row<T, kSpt>(row_idx(0), row_val(0), cap, tid, threads, yj,
                            mj, qj, aj, 0);
    for (int i = 0; i < n; ++i) {
      float wg[kSpt];
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < kSpt; ++k) {
        wg[k] = r.v[k] != 0.f ? w[r.id[k]] : 0.f;
        p += wg[k] * r.v[k];
      }
      // The next row's slots and scalars load while this row reduces.
      Row<kSpt> next = {};
      if (i + 1 < n)
        next = load_row<T, kSpt>(row_idx(i + 1), row_val(i + 1), cap, tid,
                                 threads, yj, mj, qj, aj, i + 1);
      p = warp_sum(p);
      if (lane == 0) red[i & 1][warp] = p;
      __syncthreads();
      float wx = 0.f;
      for (int k = 0; k < warps; ++k) wx += red[i & 1][k];
      const float g = r.y * (wx + b) - 1.f;
      const float pg = r.a <= 0.f ? fminf(g, 0.f)
                                  : (r.a >= C ? fmaxf(g, 0.f) : g);
      const float a_new = fminf(fmaxf(r.a - g / r.q, 0.f), C);
      const float delta = (a_new - r.a) * r.m;
      const float coef = delta * r.y;
      b += coef;
      viol_ep = fmaxf(viol_ep, fabsf(pg) * r.m);
      if (tid == 0) aj[i] = r.a + delta;
      if (delta != 0.f) {
#pragma unroll
        for (int k = 0; k < kSpt; ++k)
          if (r.v[k] != 0.f)
            w[r.id[k]] = __fadd_rn(wg[k], __fmul_rn(coef, r.v[k]));
        __syncthreads();
      }
      r = next;
    }
    viol = viol_ep;
    ++t;
  }
  if (tid == 0) {
    b_out[job] = b;
    epochs_out[job] = t;
    viol_out[job] = viol;
  }
}

template <typename T>
cudaError_t launch(const void* xh_idx, const void* xh_val, const void* xs_idx,
                   const void* xs_val, const float* y, const float* m, int L,
                   int per, int n_shared, int cap, int d, float C, float tol,
                   int max_epochs, float* q, float* alpha, float* w, float* b,
                   int* epochs, float* viol, cudaStream_t s) {
  const int warps = (cap + 31) / 32 < kMaxWarps ? (cap + 31) / 32 : kMaxWarps;
  const int threads = warps * 32;
  const int spt = (cap + threads - 1) / threads;
  const auto* hi = static_cast<const int*>(xh_idx);
  const auto* hv = static_cast<const T*>(xh_val);
  const auto* si = static_cast<const int*>(xs_idx);
  const auto* sv = static_cast<const T*>(xs_val);
#define CDS_LAUNCH(SPT)                                                       \
  cd_solve_sparse_kernel<T, SPT><<<L, threads, 0, s>>>(                       \
      hi, hv, si, sv, y, m, per, n_shared, cap, C, tol, max_epochs, d, q,     \
      alpha, w, b, epochs, viol)
  if (spt <= 1)
    CDS_LAUNCH(1);
  else if (spt <= 2)
    CDS_LAUNCH(2);
  else if (spt <= 4)
    CDS_LAUNCH(4);
  else
    CDS_LAUNCH(8);
#undef CDS_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int cd_solve_sparse_max_cap() { return kMaxCap; }

// xh: indices (L, per, cap) int32 and values (L, per, cap); xs: indices
// (S, cap) int32 and values (S, cap); values f32 (bf16 = 0) or bf16
// (bf16 = 1). y, m (L, per + S) f32. Scratch q (L, per + S) f32.
// Outputs alpha (L, n), w (L, d) f32 ZEROED by the caller, b (L,),
// epochs (L,) int32, viol (L,). Returns a cudaError_t (0 = ok).
extern "C" int cd_solve_sparse(const void* xh_idx, const void* xh_val,
                               const void* xs_idx, const void* xs_val,
                               int bf16, const float* y, const float* m,
                               int L, int per, int n_shared, int cap, int d,
                               float C, float tol, int max_epochs, float* q,
                               float* alpha, float* w, float* b, int* epochs,
                               float* viol, void* stream) {
  if (L < 1 || cap < 1 || cap > kMaxCap || per < 0 || n_shared < 0 || d < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(xh_idx, xh_val, xs_idx, xs_val, y, m, L, per,
                                 n_shared, cap, d, C, tol, max_epochs, q,
                                 alpha, w, b, epochs, viol, s);
  return launch<float>(xh_idx, xh_val, xs_idx, xs_val, y, m, L, per, n_shared,
                       cap, d, C, tol, max_epochs, q, alpha, w, b, epochs,
                       viol, s);
}

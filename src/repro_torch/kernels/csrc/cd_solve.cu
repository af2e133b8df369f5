// Dual coordinate-descent solve of L binary SVMs, one CTA per job.
//
// Replaces the TPU kernel src/repro/kernels/svm_step.py: cd_epoch
// (_cd_epoch_kernel, pl.pallas_call at line 81), and goes past it: the
// CTA runs the whole epoch loop with the reference solver's stop rule
// (src/repro/core/svm.py:206-222) and also returns the epochs run and
// the max projected-gradient violation, which the Pallas kernel omits.
//
// Per job l and epoch, the rows i = 0..n-1 of [home rows of job l;
// shared rows] go in order:
//     g   = y_i (w·x_i + b) − 1,  Q_ii = ||x_i||² + 1 (1 if masked)
//     α_i ← clip(α_i − g/Q_ii, 0, C);  Δ = (α_new − α_old)·m_i
//     w  += Δ y_i x_i;  b += Δ y_i;  viol = max(viol, |pg_i| m_i)
// Home rows (job l's partition) and the shared rows (SV_global) come
// through two pointers, so the L augmented partitions are never copied.
// A launch may hold the jobs of a sweep: job l reads home block
// l % n_home and shared block l / jobs_per_shared (S configs × L
// partitions over L shared home blocks and S SV buffers), and its own
// C, tol and epoch cutoff, read once at the kernel's start. A job with
// cutoff 0 runs no epoch and returns α = 0, w = 0, b = 0.
//
// What bounds it on an H100: the row recurrence. Each row needs the
// w of the row before, so one job is one chain of n dependent
// (dot, axpy) steps. The least time for the work is the bytes of the
// rows read once per epoch at 3.35 TB/s (5.29 ms an epoch at 8 jobs ×
// 10240 rows × 131072 bf16); the chain's latency per row sets how far
// above that a kernel sits. Two routes, chosen in Python
// (ops.cd_solve_cluster_size):
//
// single (c = 1, cd_solve_kernel): one CTA of 1024 threads per job
// splits each row in 16-byte loads and reduces (w·x, x·x) in one pass;
// w stays in shared memory when d·4 bytes fit (≤ 200 KB) and otherwise
// in global memory; the axpy is skipped when Δ = 0. The golden shape
// (d = 1024) runs here. At d = 131072 only L SMs worked and w went
// through L1/L2: ~20 µs a row (PERF.md §6).
//
// cluster (c > 1, cd_solve_cluster_kernel): a job is one thread-block
// cluster of c CTAs (launched with cudaLaunchKernelEx and a cluster
// dimension). CTA r owns a column slice; thread t of it owns a fixed
// set of kNV 16-byte column vectors and keeps w's values there in its
// registers for the whole solve, so w never leaves the chip and no
// thread reads another's w. Rows do not depend on w, so each thread
// streams its columns of the next rows through its own slots of a
// kStages-deep cp.async ring in shared memory (no barrier guards the
// ring: a thread reads only what it copied). Per row: each warp reduces
// its (w·x, x·x) with shuffles and its lanes 0..c−1 store the pair into
// slot [row parity][rank][warp] of every peer's shared memory (DSMEM);
// one cluster barrier (arrive.release / wait.acquire) follows; then
// every warp of every CTA sums the c × warps pairs in one fixed order
// and computes the same g, α update and Δ, so the CTAs agree bit for
// bit with no second exchange; each CTA keeps its copy of α in shared
// memory. Slots alternate by row parity: a peer writes a row's slot
// only after the next row's barrier, which every reader has passed only
// after reading it. The axpy runs on the thread's own columns, skipped
// when Δ = 0. Rank 0 writes α, b, the epochs and the violation; each
// rank writes its slice of w. The launcher checks with
// cudaOccupancyMaxActiveClusters that a cluster of c can be resident
// and returns an error if not; it never shrinks c. What bounds this
// route is the row step's latency (~1.9 µs at d = 131072 on 8 CTAs a
// job: the shuffles, the DSMEM stores and the cluster barrier), not
// the rows' bytes; 16 CTAs a job ran slower than 8 (PERF.md §6).
//
// Sums are taken in another order than the reference's; α, w and b
// agree with the plain version to float32 rounding. Both routes are
// deterministic: reruns are bit-identical.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                       // elements per vector load
constexpr size_t kMaxSmemW = 200 * 1024;      // w in shared memory up to this

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
cd_solve_kernel(const T* __restrict__ xh, const T* __restrict__ xs,
                const float* __restrict__ y, const float* __restrict__ m,
                int per, int n_shared, int d, int n_home, int jps,
                const float* __restrict__ Cs, const float* __restrict__ tols,
                const int* __restrict__ cutoffs, int w_in_smem,
                float* __restrict__ alpha, float* __restrict__ w_out,
                float* __restrict__ b_out, int* __restrict__ epochs_out,
                float* __restrict__ viol_out) {
  extern __shared__ float4 smem_w[];
  __shared__ float red_wx[kWarps];
  __shared__ float red_xx[kWarps];
  __shared__ float s_coef;
  __shared__ int s_go;

  const int job = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = per + n_shared;
  const T* home = xh + (size_t)(job % n_home) * per * d;
  const T* shared = xs + (size_t)(job / jps) * n_shared * d;
  const float C = Cs[job], tol = tols[job];
  const int max_epochs = cutoffs[job];
  const float* yj = y + (size_t)job * n;
  const float* mj = m + (size_t)job * n;
  float* aj = alpha + (size_t)job * n;
  float* w = w_in_smem ? reinterpret_cast<float*>(smem_w)
                       : w_out + (size_t)job * d;

  for (int j = tid; j < d; j += kThreads) w[j] = 0.f;
  for (int i = tid; i < n; i += kThreads) aj[i] = 0.f;
  // State of the job's recurrence; thread 0 holds it.
  float b = 0.f;
  float viol = INFINITY;
  int t = 0;
  __syncthreads();

  while (true) {
    if (tid == 0) s_go = (t < max_epochs) && (t == 0 || viol > tol);
    __syncthreads();
    const int go = s_go;
    __syncthreads();
    if (!go) break;
    float viol_ep = 0.f;
    for (int i = 0; i < n; ++i) {
      const T* x = i < per ? home + (size_t)i * d
                           : shared + (size_t)(i - per) * d;
      float yi = 0.f, mi = 0.f, ai = 0.f;
      if (tid == 0) { yi = yj[i]; mi = mj[i]; ai = aj[i]; }
      float wx = 0.f, xx = 0.f;
      if (kVectorized) {
        for (int j = tid * kVec; j < d; j += kThreads * kVec) {
          float xv[kVec];
          load8(x + j, xv);
          const float4 w0 = *reinterpret_cast<const float4*>(w + j);
          const float4 w1 = *reinterpret_cast<const float4*>(w + j + 4);
          wx += w0.x * xv[0] + w0.y * xv[1] + w0.z * xv[2] + w0.w * xv[3] +
                w1.x * xv[4] + w1.y * xv[5] + w1.z * xv[6] + w1.w * xv[7];
#pragma unroll
          for (int k = 0; k < kVec; ++k) xx += xv[k] * xv[k];
        }
      } else {
        for (int j = tid; j < d; j += kThreads) {
          const float xv = to_float(x[j]);
          wx += w[j] * xv;
          xx += xv * xv;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        wx += __shfl_xor_sync(0xffffffffu, wx, o);
        xx += __shfl_xor_sync(0xffffffffu, xx, o);
      }
      if (lane == 0) { red_wx[warp] = wx; red_xx[warp] = xx; }
      __syncthreads();
      if (warp == 0) {
        wx = red_wx[lane];
        xx = red_xx[lane];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          wx += __shfl_xor_sync(0xffffffffu, wx, o);
          xx += __shfl_xor_sync(0xffffffffu, xx, o);
        }
        if (lane == 0) {
          const float g = yi * (wx + b) - 1.f;
          const float pg = ai <= 0.f ? fminf(g, 0.f)
                                     : (ai >= C ? fmaxf(g, 0.f) : g);
          const float q = mi > 0.f ? xx + 1.f : 1.f;
          const float a_new = fminf(fmaxf(ai - g / q, 0.f), C);
          const float delta = (a_new - ai) * mi;
          aj[i] = ai + delta;
          b += delta * yi;
          viol_ep = fmaxf(viol_ep, fabsf(pg) * mi);
          s_coef = delta * yi;
        }
      }
      __syncthreads();
      const float coef = s_coef;
      if (coef != 0.f) {
        // Each thread updates the columns it read above, so w needs no
        // barrier between this row's axpy and the next row's dot.
        if (kVectorized) {
          for (int j = tid * kVec; j < d; j += kThreads * kVec) {
            float xv[kVec];
            load8(x + j, xv);
            float4 w0 = *reinterpret_cast<float4*>(w + j);
            float4 w1 = *reinterpret_cast<float4*>(w + j + 4);
            w0.x += coef * xv[0]; w0.y += coef * xv[1];
            w0.z += coef * xv[2]; w0.w += coef * xv[3];
            w1.x += coef * xv[4]; w1.y += coef * xv[5];
            w1.z += coef * xv[6]; w1.w += coef * xv[7];
            *reinterpret_cast<float4*>(w + j) = w0;
            *reinterpret_cast<float4*>(w + j + 4) = w1;
          }
        } else {
          for (int j = tid; j < d; j += kThreads) w[j] += coef * to_float(x[j]);
        }
      }
    }
    if (tid == 0) { viol = viol_ep; ++t; }
  }

  if (tid == 0) {
    b_out[job] = b;
    epochs_out[job] = t;
    viol_out[job] = viol;
  }
  if (w_in_smem) {
    float* wj = w_out + (size_t)job * d;
    for (int j = tid; j < d; j += kThreads) wj[j] = w[j];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The job axis of a launch: its jobs' home and shared blocks and their
// per-job hyper-parameters.
struct Jobs {
  int jobs, n_home, jps;
  const float* C;
  const float* tol;
  const int* cutoff;
};

template <typename T, bool kVectorized>
cudaError_t launch(const void* xh, const void* xs, const float* y,
                   const float* m, const Jobs& J, int per, int n_shared,
                   int d, float* alpha, float* w, float* b, int* epochs,
                   float* viol, cudaStream_t stream) {
  const size_t w_bytes = (size_t)d * sizeof(float);
  const int w_in_smem = w_bytes <= kMaxSmemW;
  const size_t smem = w_in_smem ? w_bytes : 0;
  auto kernel = cd_solve_kernel<T, kVectorized>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmemW);
  if (err != cudaSuccess) return err;
  kernel<<<J.jobs, kThreads, smem, stream>>>(
      static_cast<const T*>(xh), static_cast<const T*>(xs), y, m, per,
      n_shared, d, J.n_home, J.jps, J.C, J.tol, J.cutoff, w_in_smem, alpha,
      w, b, epochs, viol);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// cluster route: one thread-block cluster of c CTAs per job.
namespace cl {

namespace cg = cooperative_groups;

constexpr int kNV = 4;             // 16-byte column vectors a thread owns
constexpr int kMaxThreads = 512;   // a CTA's threads (≤ 128 registers)
constexpr int kMaxCluster = 16;    // non-portable above 8
constexpr int kStages = 4;         // rows in flight per thread

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; zero-filled when !valid (src is not read).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The thread's copies of all but the newest kStages − 1 groups landed.
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void unpack(const uint4& raw, float* v, float) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(const uint4& raw, float* v,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

constexpr size_t kSmemMax = 232448;  // dynamic shared memory a CTA

// Shared memory: the ring, kStages × kNV × threads uint4, then the
// partial slots, 2 (row parity) × c × warps float2, then the CTA's
// copy of α (n floats).
__host__ __device__ constexpr size_t smem_bytes(int threads, int c, int n) {
  return (size_t)kStages * kNV * threads * 16 +
         (size_t)2 * c * (threads / 32) * sizeof(float2) + (size_t)n * 4;
}

// One CTA an SM at most (its shared memory sees to that), so ptxas may
// use up to 128 registers a thread: w's slice and the per-job values
// stay out of local memory.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
cd_solve_cluster_kernel(const T* __restrict__ xh, const T* __restrict__ xs,
                        const float* __restrict__ y,
                        const float* __restrict__ m, int per, int n_shared,
                        int d, int n_home, int jps,
                        const float* __restrict__ Cs,
                        const float* __restrict__ tols,
                        const int* __restrict__ cutoffs,
                        float* __restrict__ alpha,
                        float* __restrict__ w_out, float* __restrict__ b_out,
                        int* __restrict__ epochs_out,
                        float* __restrict__ viol_out) {
  constexpr int N = 16 / sizeof(T);  // values in a 16-byte vector
  extern __shared__ uint4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int job = blockIdx.x / c;
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  const int n = per + n_shared;
  const int parts = c * warps;       // partial pairs a row
  uint4* ring = smem;
  float2* slots = reinterpret_cast<float2*>(smem + kStages * kNV * threads);
  // Every rank keeps its own copy of α, all equal, in shared memory: a
  // global store in the row loop would hold up each barrier's release.
  float* aj = reinterpret_cast<float*>(slots + 2 * parts);

  // Every CTA of a cluster reads its job's C, tol and cutoff, so all
  // run the same epochs and meet at the same barriers.
  const T* home = xh + (size_t)(job % n_home) * per * d;
  const T* shared = xs + (size_t)(job / jps) * n_shared * d;
  const float C = Cs[job], tol = tols[job];
  const int max_epochs = cutoffs[job];
  const float* yj = y + (size_t)job * n;
  const float* mj = m + (size_t)job * n;

  int col[kNV];
#pragma unroll
  for (int u = 0; u < kNV; ++u)
    col[u] = ((rank * kNV + u) * threads + tid) * N;
  float w[kNV][N];
#pragma unroll
  for (int u = 0; u < kNV; ++u)
#pragma unroll
    for (int k = 0; k < N; ++k) w[u][k] = 0.f;
  for (int i = tid; i < n; i += threads) aj[i] = 0.f;

  // Step s of the stream is row s % n; its copy sits in stage s % kStages.
  auto issue = [&](long long s) {
    const int i = (int)(s % n);
    const T* x = i < per ? home + (size_t)i * d
                         : shared + (size_t)(i - per) * d;
    uint4* st = ring + (size_t)(s % kStages) * kNV * threads;
#pragma unroll
    for (int u = 0; u < kNV; ++u)
      cp16(smem_addr(st + u * threads + tid), col[u] < d ? x + col[u] : x,
           col[u] < d);
    cp_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  // Every CTA of the cluster runs (its shared memory may be written),
  // and this CTA's zeroed α is visible to all its threads.
  cluster_barrier();

  float b = 0.f;
  float viol = INFINITY;
  int t = 0;
  long long s = 0;
  while (t < max_epochs && (t == 0 || viol > tol)) {
    float viol_ep = 0.f;
    for (int i = 0; i < n; ++i, ++s) {
      issue(s + kStages - 1);
      const float yi = yj[i], mi = mj[i], ai = aj[i];
      cp_wait_ring();
      const uint4* st = ring + (size_t)(s % kStages) * kNV * threads;
      float wx = 0.f, xx = 0.f;
#pragma unroll
      for (int u = 0; u < kNV; ++u) {
        float xv[N];
        unpack(st[u * threads + tid], xv, T());
#pragma unroll
        for (int k = 0; k < N; ++k) {
          wx += w[u][k] * xv[k];
          xx += xv[k] * xv[k];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        wx += __shfl_xor_sync(0xffffffffu, wx, o);
        xx += __shfl_xor_sync(0xffffffffu, xx, o);
      }
      float2* slot = slots + (s & 1) * parts;
      if (lane < c)
        *cluster.map_shared_rank(slot + rank * warps + warp, lane) =
            make_float2(wx, xx);
      cluster_barrier();
      // Every warp sums the c × warps pairs in the same order (lane, then
      // a butterfly, which gives every lane the same bits).
      wx = 0.f;
      xx = 0.f;
      for (int e = lane; e < parts; e += 32) {
        const float2 v = slot[e];
        wx += v.x;
        xx += v.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        wx += __shfl_xor_sync(0xffffffffu, wx, o);
        xx += __shfl_xor_sync(0xffffffffu, xx, o);
      }
      const float g = yi * (wx + b) - 1.f;
      const float pg = ai <= 0.f ? fminf(g, 0.f)
                                 : (ai >= C ? fmaxf(g, 0.f) : g);
      const float q = mi > 0.f ? xx + 1.f : 1.f;
      const float a_new = fminf(fmaxf(ai - g / q, 0.f), C);
      const float delta = (a_new - ai) * mi;
      if (tid == 0) aj[i] = ai + delta;
      // The next step reads aj[i + 1] after its own barrier; with one row
      // it reads this aj[0] before any barrier, so wait for the store.
      if (n == 1) __syncthreads();
      b += delta * yi;
      viol_ep = fmaxf(viol_ep, fabsf(pg) * mi);
      const float coef = delta * yi;
      if (coef != 0.f) {
#pragma unroll
        for (int u = 0; u < kNV; ++u) {
          float xv[N];
          unpack(st[u * threads + tid], xv, T());
#pragma unroll
          for (int k = 0; k < N; ++k) w[u][k] += coef * xv[k];
        }
      }
    }
    viol = viol_ep;
    ++t;
  }
  cp_wait_all();
  __syncthreads();  // the last row's α is in shared memory

  if (rank == 0) {
    float* alpha_j = alpha + (size_t)job * n;
    for (int i = tid; i < n; i += threads) alpha_j[i] = aj[i];
  }
  float* wj = w_out + (size_t)job * d;
#pragma unroll
  for (int u = 0; u < kNV; ++u) {
    if (col[u] < d) {
#pragma unroll
      for (int k = 0; k < N; k += 4)
        *reinterpret_cast<float4*>(wj + col[u] + k) =
            make_float4(w[u][k], w[u][k + 1], w[u][k + 2], w[u][k + 3]);
    }
  }
  if (rank == 0 && tid == 0) {
    b_out[job] = b;
    epochs_out[job] = t;
    viol_out[job] = viol;
  }
  // No CTA leaves while a peer may still address its shared memory.
  cluster_barrier();
}

// Threads of a CTA for a slice of d / c columns: whole warps, each
// thread kNV vectors. 0 if the slice needs more than kMaxThreads.
int threads_for(int d, int c, int vec) {
  const long long vecs = ((long long)d / vec + c - 1) / c;
  const long long threads = ((vecs + kNV - 1) / kNV + 31) / 32 * 32;
  return threads <= kMaxThreads ? (int)threads : 0;
}

template <typename T>
cudaError_t configure(int jobs, int d, int n, int c, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  constexpr int N = 16 / sizeof(T);
  if (c < 2 || c > kMaxCluster || (c & (c - 1)) != 0 || d % N != 0)
    return cudaErrorInvalidValue;
  const int threads = threads_for(d, c, N);
  if (threads == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(threads, c, n);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = cd_solve_cluster_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(jobs * c);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t max_active(int d, int n, int c, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<T>(1, d, n, c, 0, &cfg, &attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(c);
  return cudaOccupancyMaxActiveClusters(clusters, cd_solve_cluster_kernel<T>,
                                        &cfg);
}

template <typename T>
cudaError_t launch(const void* xh, const void* xs, const float* y,
                   const float* m, const Jobs& J, int per, int n_shared,
                   int d, int c, float* alpha, float* w, float* b,
                   int* epochs, float* viol, cudaStream_t stream) {
  const int n = per + n_shared;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<T>(J.jobs, d, n, c, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = max_active<T>(d, n, c, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, cd_solve_cluster_kernel<T>,
                           static_cast<const T*>(xh),
                           static_cast<const T*>(xs), y, m, per, n_shared, d,
                           J.n_home, J.jps, J.C, J.tol, J.cutoff, alpha, w, b,
                           epochs, viol);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace cl
}  // namespace

// xh (n_home, per, d) and xs (jobs / jobs_per_shared, n_shared, d) rows,
// bf16 if is_bf16 else f32; y, m (jobs, per + n_shared) f32; C, tol
// (jobs,) f32 and cutoff (jobs,) int32, each job's own. Job l reads home
// block l % n_home and shared block l / jobs_per_shared. Outputs: alpha
// (jobs, n), w (jobs, d), b, epochs, viol (jobs,). Returns a cudaError_t
// (0 = ok).
extern "C" int cd_solve(const void* xh, const void* xs, int is_bf16,
                        const float* y, const float* m, int jobs, int per,
                        int n_shared, int d, int n_home, int jobs_per_shared,
                        const float* C, const float* tol, const int* cutoff,
                        float* alpha, float* w, float* b, int* epochs,
                        float* viol, void* stream) {
  if (jobs <= 0) return cudaSuccess;
  if (n_home < 1 || jobs_per_shared < 1) return cudaErrorInvalidValue;
  const Jobs J{jobs, n_home, jobs_per_shared, C, tol, cutoff};
  const bool vec = d % kVec == 0 && aligned16(xh) && aligned16(w) &&
                   (n_shared == 0 || aligned16(xs));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return vec ? launch<__nv_bfloat16, true>(xh, xs, y, m, J, per, n_shared,
                                             d, alpha, w, b, epochs, viol, s)
               : launch<__nv_bfloat16, false>(xh, xs, y, m, J, per, n_shared,
                                              d, alpha, w, b, epochs, viol, s);
  }
  return vec ? launch<float, true>(xh, xs, y, m, J, per, n_shared, d, alpha,
                                   w, b, epochs, viol, s)
             : launch<float, false>(xh, xs, y, m, J, per, n_shared, d, alpha,
                                    w, b, epochs, viol, s);
}

// Cluster route: as cd_solve, one cluster of c CTAs (a power of two in
// 2..16) per job; d a whole number of 16-byte vectors, rows and w
// 16-byte aligned, 1 ≤ n, and the CTA's ring, slots and copy of α
// within its shared memory. Returns cudaErrorInvalidValue for a shape
// the route does not take and cudaErrorInvalidConfiguration when no
// cluster of c such CTAs can be resident on the card.
extern "C" int cd_solve_cluster(const void* xh, const void* xs, int is_bf16,
                                const float* y, const float* m, int jobs,
                                int per, int n_shared, int d, int n_home,
                                int jobs_per_shared, const float* C,
                                const float* tol, const int* cutoff, int c,
                                float* alpha, float* w, float* b, int* epochs,
                                float* viol, void* stream) {
  if (jobs <= 0) return cudaSuccess;
  if (per + n_shared < 1 || n_home < 1 || jobs_per_shared < 1 ||
      !aligned16(xh) || !aligned16(w) || (n_shared > 0 && !aligned16(xs)))
    return cudaErrorInvalidValue;
  const Jobs J{jobs, n_home, jobs_per_shared, C, tol, cutoff};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return cl::launch<__nv_bfloat16>(xh, xs, y, m, J, per, n_shared, d, c,
                                     alpha, w, b, epochs, viol, s);
  return cl::launch<float>(xh, xs, y, m, J, per, n_shared, d, c, alpha, w, b,
                           epochs, viol, s);
}

// How many clusters of c CTAs of the cluster route for n rows of width
// d can be resident at once (cudaOccupancyMaxActiveClusters) → *clusters.
extern "C" int cd_solve_cluster_occupancy(int is_bf16, int d, int n, int c,
                                          int* clusters) {
  return is_bf16 ? cl::max_active<__nv_bfloat16>(d, n, c, clusters)
                 : cl::max_active<float>(d, n, c, clusters);
}

// The route's constants, for the Python rule that picks c: vectors a
// thread owns, threads a CTA at most, the largest cluster.
extern "C" int cd_solve_cluster_vectors() { return cl::kNV; }
extern "C" int cd_solve_cluster_max_threads() { return cl::kMaxThreads; }
extern "C" int cd_solve_cluster_max_size() { return cl::kMaxCluster; }
extern "C" int cd_solve_cluster_stages() { return cl::kStages; }

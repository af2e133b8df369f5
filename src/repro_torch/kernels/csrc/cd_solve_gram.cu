// Gram-based dual coordinate-descent solve of L binary SVMs: one
// thread-block cluster of c CTAs per job (c = 1 is the single route),
// rows in tiles of kTile.
//
// The JAX package has no TPU kernel for this loop: fit_binary_kernel
// (src/repro/core/svm.py:279-308) leaves the while_loop / fori_loop
// over rows to XLA. In eager PyTorch the row recurrence is about eight
// launches per row, so it gets a kernel, as cd_solve.cu took over the
// loop around the Pallas cd_epoch. The cluster runs the reference's
// whole solve with its stop rule (t == 0 or viol > tol, and
// t < max_epochs):
//     Q_ij = (y_i y_j) · (K_ij + 1) · (m_i m_j)    (bias augmentation)
//     Q_ii → 1 where m_i = 0
//     g = −m, α = 0; per row i in order:
//       pg  = projected g_i on the box [0, C]
//       α_i ← clip(α_i − g_i / Q_ii, 0, C), Δ = (α_new − α_old) · m_i
//       g  += Δ · Q[:, i];  viol = max(viol, |pg| · m_i)
// K excludes the +1: the kernel adds it where it forms Q. Each job has
// its own C, tol and epoch cutoff (a sweep's configs on one launch),
// read once at the kernel's start by every CTA of its cluster, so the
// CTAs run the same epochs; a job with cutoff 0 runs none (α = 0).
//
// State type: the reference keeps K, y, m, α, g, C and tol in the rows'
// dtype (svm.py:248, :260-261, :305). The kernel is templated on float
// and bf16 state: it computes each operation in float32 and rounds the
// result to the state type where the reference's operation would
// produce it, with explicit _rn intrinsics so that no multiply-add is
// contracted.
//
// Design. Each g_j receives the additions Δ_i·Q_ji in the reference's
// order, row i ascending, so α equals the plain version bit for bit;
// what changes is who adds them and how often the CTAs meet:
//   * CTA r of a job's cluster owns the rows [r·W, (r + 1)·W) (W a
//     multiple of kTile): their g, α, Q_ii, y and m live in its shared
//     memory (20 bytes a row, so a job takes up to 16 × 11552 rows).
//   * Rows go in tiles of kTile. The tile's owner runs the tile's chain
//     on warp 0: lane k holds g_k of row t + k in a register and the
//     tile's kTile × kTile block of Q (formed before the first step, as
//     it does not depend on Δ); step k decides Δ_k on lane k,
//     broadcasts it by shuffle and adds Δ_k·Q_jk into the tile's own g.
//   * The tile's (Δ, y, m) go into every CTA's shared memory (DSMEM),
//     and one cluster barrier follows: one barrier a tile, not a row.
//   * Every CTA then adds the tile's rank-kTile update to the g of the
//     rows it owns outside the tile, k in tile order, reading K's rows
//     t..t+kTile−1 (Q is symmetric, so Q[:, i] is K's contiguous row i)
//     and skipping rows whose Δ is 0 (exact for a finite K; a job whose
//     K holds a NaN or ±Inf skips none, as the reference adds 0 · Inf =
//     NaN); its slices of those rows are
//     first prefetched into L2, so each thread's later loads of 32 rows
//     of a column wait on L2, not on device memory. Warp 0 of the next
//     tile's owner updates the next tile's rows first and runs its
//     chain at once, while warps 1.. update the rest: the next chain
//     overlaps this update, and no second barrier is needed. It also
//     prefetches into L2 the rows its next phase reads first.
//   * At an epoch's end each CTA puts its violation into every peer's
//     shared memory; after one more cluster barrier every CTA takes the
//     same maximum, so all run the same number of barriers.
// What bounds it on an H100: the bytes of K's rows whose α moved (read
// once an epoch) and, per tile, the chain (kTile dependent steps) and
// one cluster barrier.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// NaN passes through these as through the reference's jnp.maximum,
// jnp.minimum and jnp.clip: fmaxf and fminf return the other operand when
// one is NaN, which would turn a NaN step into a finite one.
__device__ __forceinline__ float max0(float x) { return x < 0.f ? 0.f : x; }
__device__ __forceinline__ float min0(float x) { return x > 0.f ? 0.f : x; }
__device__ __forceinline__ float clip0(float x, float C) {
  return x < 0.f ? 0.f : (x > C ? C : x);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

namespace cg = cooperative_groups;

constexpr int kTile = 32;          // rows a chain: one warp's lanes
constexpr int kThreads = 512;      // warp 0 chains, warps 1.. update
constexpr int kMaxCluster = 16;    // non-portable above 8
constexpr int kStateArrays = 5;    // g, alpha, qdiag, y, m
constexpr size_t kSmemMax = 232448;
// static shared memory: (Δ, y, m) of a tile by parity, violations, the
// job's tol and cutoff
constexpr size_t kStaticSmem = (2 * 3 * kTile + 2 * kMaxCluster + 2) * 4;
// rows a CTA can own: whole tiles of state in its dynamic shared memory
constexpr int kMaxRowsPerCta =
    (int)((kSmemMax - kStaticSmem) / (kStateArrays * 4)) / kTile * kTile;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ float rt(float x);
template <> __device__ __forceinline__ float rt<float>(float x) { return x; }
template <> __device__ __forceinline__ float rt<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Q_ij from K_ij in the state type, in the reference's order:
// rt(rt(rt(y_i·y_j) · rt(K_ij + 1)) · rt(m_i·m_j)).
template <typename T>
__device__ __forceinline__ float q_entry(float k, float yi, float yj, float mi,
                                         float mj) {
  const float yy = rt<T>(__fmul_rn(yi, yj));
  const float k1 = rt<T>(__fadd_rn(k, 1.f));
  const float mm = rt<T>(__fmul_rn(mi, mj));
  return rt<T>(__fmul_rn(rt<T>(__fmul_rn(yy, k1)), mm));
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

struct State {
  float* g;
  float* a;
  float* qd;
  float* ys;
  float* ms;
};

// kv[k] = K[i0 + k][j] for the live rows k of tile i0 (0 elsewhere,
// with no load).
template <typename T>
__device__ __forceinline__ void load_column(const T* __restrict__ Kj, int n,
                                            int i0, int j, unsigned live,
                                            float (&kv)[kTile]) {
#pragma unroll
  for (int k = 0; k < kTile; ++k)
    kv[k] = (live >> k) & 1u ? to_float(Kj[(size_t)(i0 + k) * n + j]) : 0.f;
}

// g_j of row j + the rank-kTile update of tile i0 (rows i0..i0+kTile−1,
// their (Δ, y, m) in D, Y, M; kv from load_column), k in order; rows
// with Δ = 0 are skipped.
template <typename T>
__device__ __forceinline__ float apply_column(const float (&kv)[kTile],
                                              float gj, float yj, float mj,
                                              const float* D, const float* Y,
                                              const float* M, unsigned live) {
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if ((live >> k) & 1u)
      gj = rt<T>(__fadd_rn(
          gj, rt<T>(__fmul_rn(D[k], q_entry<T>(kv[k], yj, Y[k], mj, M[k])))));
  }
  return gj;
}

// kq[k] = K[i0 + k][i0 + lane]: lane's column of the kTile × kTile
// block of tile i0 (0 outside [0, n)).
template <typename T>
__device__ __forceinline__ void load_block(const T* __restrict__ Kj, int n,
                                           int i0, float (&kq)[kTile]) {
  const int i = i0 + (threadIdx.x & 31);
#pragma unroll
  for (int k = 0; k < kTile; ++k)
    kq[k] = i < n && i0 + k < n ? to_float(Kj[(size_t)(i0 + k) * n + i])
                                : 0.f;
}

// The chain of tile i0 on one warp (lane k: row i0 + k, owned by this
// CTA at local index i0 + k − r0), from g_l, the lane's g, and kq, its
// column of the tile's block of K. Writes the tile's (Δ, y, m) into
// buffer `dl` of every CTA of the cluster and the tile's g and α back
// into shared memory; raises vmax.
template <typename T>
__device__ __forceinline__ void chain(cg::cluster_group& cluster, int c,
                                      int n, int i0, int r0, float g_l,
                                      float (&kq)[kTile], const State& s,
                                      float C, bool every, float* dl,
                                      float& vmax) {
  const int lane = threadIdx.x & 31;
  const int i = i0 + lane;
  const bool valid = i < n;
  const int li = i - r0;
  float a_l = valid ? s.a[li] : 0.f;
  const float q_l = valid ? s.qd[li] : 1.f;
  const float y_l = valid ? s.ys[li] : 0.f;
  const float m_l = valid ? s.ms[li] : 0.f;
  // Q's block first (it does not depend on Δ): kq[k] ← Q_{lane, k}
#pragma unroll
  for (int k = 0; k < kTile; ++k)
    kq[k] = q_entry<T>(kq[k], y_l, __shfl_sync(0xffffffffu, y_l, k), m_l,
                       __shfl_sync(0xffffffffu, m_l, k));
  float d_l = 0.f;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if (lane == k && valid) {
      const float pg = a_l <= 0.f ? min0(g_l)
                                  : (a_l >= C ? max0(g_l) : g_l);
      float an = rt<T>(__fsub_rn(a_l, rt<T>(__fdiv_rn(g_l, q_l))));
      an = clip0(an, C);
      d_l = rt<T>(__fmul_rn(rt<T>(__fsub_rn(an, a_l)), m_l));
      a_l = rt<T>(__fadd_rn(a_l, d_l));
      vmax = nan_max(vmax, rt<T>(__fmul_rn(fabsf(pg), m_l)));
    }
    const float dk = __shfl_sync(0xffffffffu, d_l, k);
    if (dk != 0.f || every)
      g_l = rt<T>(__fadd_rn(g_l, rt<T>(__fmul_rn(dk, kq[k]))));
  }
  for (int p = 0; p < c; ++p) {
    float* peer = cluster.map_shared_rank(dl, p);
    peer[lane] = d_l;
    peer[kTile + lane] = y_l;
    peer[2 * kTile + lane] = m_l;
  }
  if (valid) {
    s.g[li] = g_l;
    s.a[li] = a_l;
  }
}

__device__ __forceinline__ void prefetch_line(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The rows [r0, r0 + nown) of tile i0's live rows into L2, one 128-byte
// line a thread of `threads` from `first`: the rank update's loads that
// follow then find them there.
template <typename T>
__device__ __forceinline__ void prefetch_rows(const T* __restrict__ Kj, int n,
                                              int i0, int r0, int nown,
                                              unsigned live, int first,
                                              int threads) {
  if (nown <= 0) return;
  const size_t bytes = (size_t)nown * sizeof(T);
  const int lines = (int)((bytes + 127) / 128) + 1;   // + 1: misalignment
  for (int k = 0; k < kTile; ++k) {
    if (!((live >> k) & 1u)) continue;
    const char* row = reinterpret_cast<const char*>(
        Kj + (size_t)(i0 + k) * n + r0);
    for (int l = first; l < lines; l += threads)
      prefetch_line(row + min((size_t)l * 128, bytes - 1));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cd_solve_gram_kernel(const T* __restrict__ K, const T* __restrict__ y,
                     const T* __restrict__ m, int n, int W,
                     const float* __restrict__ Cs,
                     const float* __restrict__ tols,
                     const int* __restrict__ cutoffs,
                     const int* __restrict__ nonfinite,
                     T* __restrict__ alpha_out,
                     int* __restrict__ epochs_out, T* __restrict__ viol_out) {
  extern __shared__ float smem[];
  __shared__ float dl[2][3 * kTile];      // (Δ, y, m) of a tile, by parity
  __shared__ float vs[2][kMaxCluster];    // each CTA's violation, by epoch
  __shared__ float s_tol;                 // the job's tol and cutoff, read
  __shared__ int s_cutoff;                // once an epoch: no registers
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int job = blockIdx.x / c;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const State s{smem, smem + W, smem + 2 * W, smem + 3 * W, smem + 4 * W};
  const int r0 = rank * W;                  // first row this CTA owns
  const int nown = max(0, min(W, n - r0));  // rows it owns
  const int tiles = (n + kTile - 1) / kTile;
  const int tiles_per_cta = W / kTile;
  const T* Kj = K + (size_t)job * n * n;
  const float C = rt<T>(Cs[job]);
  // A job whose K holds a NaN or ±Inf adds every row's Δ·Q[:, i], Δ = 0
  // included, as the reference does (0 · Inf is NaN); a finite K skips
  // the Δ = 0 rows, which then add exact zeros.
  const bool every = nonfinite[job] != 0;
  if (tid == 0) {
    s_tol = rt<T>(tols[job]);
    s_cutoff = cutoffs[job];
  }

  for (int jl = tid; jl < nown; jl += nt) {
    const int j = r0 + jl;
    const float yj = to_float(y[(size_t)job * n + j]);
    const float mj = to_float(m[(size_t)job * n + j]);
    s.ys[jl] = yj;
    s.ms[jl] = mj;
    s.a[jl] = 0.f;
    s.g[jl] = rt<T>(__fmul_rn(-1.f, mj));
    s.qd[jl] = mj > 0.f
        ? q_entry<T>(to_float(Kj[(size_t)j * n + j]), yj, yj, mj, mj)
        : 1.f;
  }
  // Every CTA of the cluster runs (peers may write its shared memory),
  // and its state is visible to all its threads.
  cluster_barrier();

  float viol = INFINITY;
  int t = 0;
  while (t < s_cutoff && (t == 0 || viol > s_tol)) {
    float vmax = 0.f;   // warp 0: the violations of the rows it chained
    if (warp == 0 && rank == 0) {   // tile 0's owner
      float kq[kTile];
      load_block<T>(Kj, n, 0, kq);
      const float g0 = lane < nown ? s.g[lane] : 0.f;
      chain<T>(cluster, c, n, 0, 0, g0, kq, s, C, every, dl[0], vmax);
    }
    for (int tile = 0; tile < tiles; ++tile) {
      cluster_barrier();            // tile's (Δ, y, m) are everywhere
      const int i0 = tile * kTile;
      const float* D = dl[tile & 1];
      const float* Y = D + kTile;
      const float* M = D + 2 * kTile;
      unsigned live = 0;
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        live |= (D[k] != 0.f || (every && i0 + k < n) ? 1u : 0u) << k;
      const int next = tile + 1 < tiles ? tile + 1 : -1;
      const bool own_next = next >= 0 && next / tiles_per_cta == rank;
      if (warp == 0) {
        if (own_next) {
          // the next tile's rows first, then its chain at once
          const int i1 = next * kTile;
          const int j = i1 + lane;
          const int i2 = i1 + kTile;
          if (i2 < n && i2 / W == rank) {
            // what the next phase's chain reads first: K's rows of the
            // next tile and of the one after, at the latter's columns
            prefetch_line(Kj + (size_t)min(i1 + lane, n - 1) * n + i2);
            prefetch_line(Kj + (size_t)min(i2 + lane, n - 1) * n + i2);
          }
          float gj = 0.f;
          if (j < n) {
            const int jl = j - r0;
            gj = s.g[jl];
            if (live) {
              float kv[kTile];
              load_column<T>(Kj, n, i0, j, live, kv);
              gj = apply_column<T>(kv, gj, s.ys[jl], s.ms[jl], D, Y, M, live);
            }
          }
          float kq[kTile];   // loaded after the update: fewer live registers
          load_block<T>(Kj, n, i1, kq);
          chain<T>(cluster, c, n, i1, r0, gj, kq, s, C, every, dl[next & 1],
                   vmax);
        }
      } else if (live) {
        prefetch_rows<T>(Kj, n, i0, r0, nown, live, tid - 32, nt - 32);
        for (int jl = tid - 32; jl < nown; jl += nt - 32) {
          const int tj = (r0 + jl) / kTile;
          if (tj == tile || tj == next) continue;
          float kv[kTile];
          load_column<T>(Kj, n, i0, r0 + jl, live, kv);
          s.g[jl] = apply_column<T>(kv, s.g[jl], s.ys[jl], s.ms[jl], D, Y, M,
                                    live);
        }
      }
    }
    // the epoch's violation: every CTA's maximum, in every CTA
    if (warp == 0) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        vmax = nan_max(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
      if (lane < c) *cluster.map_shared_rank(&vs[t & 1][rank], lane) = vmax;
    }
    cluster_barrier();
    float v = 0.f;
    for (int p = 0; p < c; ++p) v = nan_max(v, vs[t & 1][p]);
    viol = v;
    ++t;
  }

  for (int jl = tid; jl < nown; jl += nt)
    alpha_out[(size_t)job * n + r0 + jl] = from_float<T>(s.a[jl]);
  if (rank == 0 && tid == 0) {
    epochs_out[job] = t;
    viol_out[job] = from_float<T>(viol);
  }
  // No CTA leaves while a peer may still address its shared memory.
  cluster_barrier();
}

// Rows each CTA owns for n rows over c CTAs: whole tiles.
int rows_per_cta(int n, int c) {
  const int per = (n + c - 1) / c;
  return (per + kTile - 1) / kTile * kTile;
}

template <typename T>
cudaError_t configure(int jobs, int n, int c, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (n < 1 || c < 1 || c > kMaxCluster) return cudaErrorInvalidValue;
  const int W = rows_per_cta(n, c);
  if (W > kMaxRowsPerCta) return cudaErrorInvalidValue;
  const size_t smem = (size_t)kStateArrays * W * sizeof(float);
  auto kernel = cd_solve_gram_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(jobs * c);
  cfg->blockDim = dim3(kThreads);
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
cudaError_t max_active(int n, int c, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<T>(1, n, c, 0, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, cd_solve_gram_kernel<T>,
                                        &cfg);
}

template <typename T>
cudaError_t launch(const void* K, const void* y, const void* m, int jobs,
                   int n, int c, const float* C, const float* tol,
                   const int* cutoff, const int* nonfinite, void* alpha,
                   int* epochs, void* viol, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<T>(jobs, n, c, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = max_active<T>(n, c, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, cd_solve_gram_kernel<T>,
                           static_cast<const T*>(K), static_cast<const T*>(y),
                           static_cast<const T*>(m), n, rows_per_cta(n, c), C,
                           tol, cutoff, nonfinite, static_cast<T*>(alpha),
                           epochs, static_cast<T*>(viol));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The kernel's limits, for the route rule (ops.cd_solve_gram_cluster_size):
// rows a tile, the largest cluster, rows of state a CTA holds.
extern "C" int cd_solve_gram_tile() { return kTile; }
extern "C" int cd_solve_gram_max_cluster() { return kMaxCluster; }
extern "C" int cd_solve_gram_max_rows_per_cta() { return kMaxRowsPerCta; }

// How many clusters of c CTAs for n rows a job can be resident at once
// (cudaOccupancyMaxActiveClusters) → *clusters.
extern "C" int cd_solve_gram_occupancy(int is_bf16, int n, int c,
                                       int* clusters) {
  return is_bf16 ? max_active<__nv_bfloat16>(n, c, clusters)
                 : max_active<float>(n, c, clusters);
}

// K (jobs, n, n) symmetric, y, m (jobs, n), all bf16 if is_bf16 else
// f32; c CTAs a job (1 ≤ c ≤ 16); C, tol (jobs,) f32 and cutoff (jobs,)
// int32, each job's own (C and tol rounded to the state type, as the
// reference casts them to the rows' dtype); nonfinite (jobs,) int32, 1
// where the job's K holds a NaN or ±Inf. Outputs alpha (jobs, n) and viol
// (jobs,) in the same type, epochs (jobs,) int32. Returns a cudaError_t
// (0 = ok; cudaErrorInvalidConfiguration when no cluster of c can be
// resident).
extern "C" int cd_solve_gram(const void* K, int is_bf16, const void* y,
                             const void* m, int jobs, int n, int c,
                             const float* C, const float* tol,
                             const int* cutoff, const int* nonfinite,
                             void* alpha, int* epochs, void* viol,
                             void* stream) {
  if (jobs <= 0 || n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(K, y, m, jobs, n, c, C, tol, cutoff,
                                 nonfinite, alpha, epochs, viol, s);
  return launch<float>(K, y, m, jobs, n, c, C, tol, cutoff, nonfinite, alpha,
                       epochs, viol, s);
}

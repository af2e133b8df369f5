// Gram-based dual coordinate-descent solve of L binary SVMs, one CTA
// per job.
//
// The JAX package has no TPU kernel for this loop: fit_binary_kernel
// (src/repro/core/svm.py:279-308) leaves the while_loop / fori_loop
// over rows to XLA. In eager PyTorch the row recurrence is about eight
// launches per row, so it gets a kernel, as cd_solve.cu took over the
// loop around the Pallas cd_epoch. The CTA runs the reference's whole
// solve with its stop rule (t == 0 or viol > tol, and t < max_epochs):
//     Q_ij = (y_i y_j) · (K_ij + 1) · (m_i m_j)    (bias augmentation)
//     Q_ii → 1 where m_i = 0
//     g = −m, α = 0; per row i in order:
//       pg  = projected g_i on the box [0, C]
//       α_i ← clip(α_i − g_i / Q_ii, 0, C), Δ = (α_new − α_old) · m_i
//       g  += Δ · Q[:, i];  viol = max(viol, |pg| · m_i)
// K excludes the +1: the kernel adds it where it forms Q.
//
// State type: the reference keeps K, y, m, α, g, C and tol in the rows'
// dtype (svm.py:248, :260-261, :305). The kernel is templated on float
// and bf16 state: it computes each operation in float32 and rounds the
// result to the state type where the reference's operation would
// produce it, with explicit _rn intrinsics so that no multiply-add is
// contracted.
//
// What bounds it on an H100: bytes, and the row recurrence. Per epoch
// the work is one read of row i of K for every row whose α moved
// (Q is symmetric, so row i — contiguous — stands for column i). Q is
// never materialized: it is formed from K, y and m on the fly, which
// saves L·n² elements of device memory and a pass over them. g, α,
// Q_ii, y and m live in shared memory (20 bytes a row, so n ≤ 11622).
// Thread t owns rows j ≡ t (mod blockDim): the owner of row i decides
// Δ_i from the g_i it updated itself, so a row costs one block barrier;
// rows with Δ = 0 skip the read of K's row. Only L of 132 SMs work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kStateArrays = 5;   // g, alpha, qdiag, y, m
constexpr size_t kMaxSmem = 232448 - 1024;

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

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cd_solve_gram_kernel(const T* __restrict__ K, const T* __restrict__ y,
                     const T* __restrict__ m, int n, float C_in,
                     float tol_in, int max_epochs, T* __restrict__ alpha_out,
                     int* __restrict__ epochs_out, T* __restrict__ viol_out) {
  extern __shared__ float smem[];
  float* g = smem;
  float* a = g + n;
  float* qd = a + n;
  float* ys = qd + n;
  float* ms = ys + n;
  __shared__ float s_delta[2];
  __shared__ float red[kMaxThreads / 32];
  __shared__ int s_go;

  const int job = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* Kj = K + (size_t)job * n * n;
  const float C = rt<T>(C_in);
  const float tol = rt<T>(tol_in);

  for (int j = tid; j < n; j += nt) {
    const float yj = to_float(y[(size_t)job * n + j]);
    const float mj = to_float(m[(size_t)job * n + j]);
    ys[j] = yj;
    ms[j] = mj;
    a[j] = 0.f;
    g[j] = rt<T>(__fmul_rn(-1.f, mj));
    qd[j] = mj > 0.f
        ? q_entry<T>(to_float(Kj[(size_t)j * n + j]), yj, yj, mj, mj)
        : 1.f;
  }
  float viol = INFINITY;   // thread 0 holds the job's stop state
  int t = 0;
  __syncthreads();

  while (true) {
    if (tid == 0) s_go = (t < max_epochs) && (t == 0 || viol > tol);
    __syncthreads();
    const int go = s_go;
    __syncthreads();
    if (!go) break;
    float vmax = 0.f;
    for (int i = 0; i < n; ++i) {
      if (tid == i % nt) {
        const float gi = g[i];
        const float ao = a[i];
        const float mi = ms[i];
        const float pg = ao <= 0.f ? fminf(gi, 0.f)
                                   : (ao >= C ? fmaxf(gi, 0.f) : gi);
        float an = rt<T>(__fsub_rn(ao, rt<T>(__fdiv_rn(gi, qd[i]))));
        an = fminf(fmaxf(an, 0.f), C);
        const float delta = rt<T>(__fmul_rn(rt<T>(__fsub_rn(an, ao)), mi));
        a[i] = rt<T>(__fadd_rn(ao, delta));
        vmax = fmaxf(vmax, rt<T>(__fmul_rn(fabsf(pg), mi)));
        s_delta[i & 1] = delta;
      }
      __syncthreads();
      const float delta = s_delta[i & 1];
      if (delta != 0.f) {
        const float yi = ys[i];
        const float mi = ms[i];
        const T* Ki = Kj + (size_t)i * n;
        for (int j = tid; j < n; j += nt) {
          const float q = q_entry<T>(to_float(Ki[j]), ys[j], yi, ms[j], mi);
          g[j] = rt<T>(__fadd_rn(g[j], rt<T>(__fmul_rn(delta, q))));
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    if (lane == 0) red[warp] = vmax;
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int w = 0; w < nt / 32; ++w) v = fmaxf(v, red[w]);
      viol = v;
      ++t;
    }
    __syncthreads();
  }

  for (int j = tid; j < n; j += nt)
    alpha_out[(size_t)job * n + j] = from_float<T>(a[j]);
  if (tid == 0) {
    epochs_out[job] = t;
    viol_out[job] = from_float<T>(viol);
  }
}

template <typename T>
cudaError_t launch(const void* K, const void* y, const void* m, int jobs,
                   int n, float C, float tol, int max_epochs, void* alpha,
                   int* epochs, void* viol, cudaStream_t stream) {
  const size_t smem = (size_t)kStateArrays * n * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = cd_solve_gram_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return err;
  int threads = ((n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  kernel<<<jobs, threads, smem, stream>>>(
      static_cast<const T*>(K), static_cast<const T*>(y),
      static_cast<const T*>(m), n, C, tol, max_epochs, static_cast<T*>(alpha),
      epochs, static_cast<T*>(viol));
  return cudaGetLastError();
}

}  // namespace

// Rows of the job state this kernel can hold in shared memory.
extern "C" int cd_solve_gram_max_rows() {
  return (int)(kMaxSmem / (kStateArrays * sizeof(float)));
}

// K (jobs, n, n) symmetric, y, m (jobs, n), all bf16 if is_bf16 else
// f32. Outputs alpha (jobs, n) and viol (jobs,) in the same type,
// epochs (jobs,) int32. Returns a cudaError_t (0 = ok).
extern "C" int cd_solve_gram(const void* K, int is_bf16, const void* y,
                             const void* m, int jobs, int n, float C,
                             float tol, int max_epochs, void* alpha,
                             int* epochs, void* viol, void* stream) {
  if (jobs <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(K, y, m, jobs, n, C, tol, max_epochs, alpha,
                                 epochs, viol, s);
  return launch<float>(K, y, m, jobs, n, C, tol, max_epochs, alpha, epochs,
                       viol, s);
}

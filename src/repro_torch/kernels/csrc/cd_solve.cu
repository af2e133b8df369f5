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
//
// What bounds it on an H100: the row recurrence. Each row needs the
// w of the row before, so one job is one chain of n dependent
// (dot, axpy) steps and only L SMs work. Each step reads the row
// (d·2 bytes in bf16) plus w (d·4 bytes) and ends in two block
// barriers. The least time for the work is the bytes of the rows read
// once per epoch at 3.35 TB/s; this kernel sits far above it because
// L of 132 SMs stream. What the design does about it: the block's
// 1024 threads split each row in 16-byte loads and reduce (w·x, x·x)
// in one pass; w stays in shared memory when d·4 bytes fit (≤ 200 KB)
// and otherwise in global memory, where the L·d·4 bytes of all jobs
// (4 MB at d = 131072, L = 8) stay in the 50 MB L2; the axpy is skipped
// when Δ = 0, which is most rows once α settles. Spreading a job over a
// cluster of CTAs (w in distributed shared memory) is later work.
//
// Sums are taken in another order than the reference's; α, w and b
// agree with the plain version to float32 rounding.
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
                int per, int n_shared, int d, float C, float tol,
                int max_epochs, int w_in_smem,
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
  const T* home = xh + (size_t)job * per * d;
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
                           : xs + (size_t)(i - per) * d;
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

template <typename T, bool kVectorized>
cudaError_t launch(const void* xh, const void* xs, const float* y,
                   const float* m, int jobs, int per, int n_shared, int d,
                   float C, float tol, int max_epochs, float* alpha,
                   float* w, float* b, int* epochs, float* viol,
                   cudaStream_t stream) {
  const size_t w_bytes = (size_t)d * sizeof(float);
  const int w_in_smem = w_bytes <= kMaxSmemW;
  const size_t smem = w_in_smem ? w_bytes : 0;
  auto kernel = cd_solve_kernel<T, kVectorized>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmemW);
  if (err != cudaSuccess) return err;
  kernel<<<jobs, kThreads, smem, stream>>>(
      static_cast<const T*>(xh), static_cast<const T*>(xs), y, m, per,
      n_shared, d, C, tol, max_epochs, w_in_smem, alpha, w, b, epochs, viol);
  return cudaGetLastError();
}

}  // namespace

// xh (jobs, per, d) and xs (n_shared, d) rows, bf16 if is_bf16 else
// f32; y, m (jobs, per + n_shared) f32. Outputs: alpha (jobs, n), w
// (jobs, d), b, epochs, viol (jobs,). Returns a cudaError_t (0 = ok).
extern "C" int cd_solve(const void* xh, const void* xs, int is_bf16,
                        const float* y, const float* m, int jobs, int per,
                        int n_shared, int d, float C, float tol,
                        int max_epochs, float* alpha, float* w, float* b,
                        int* epochs, float* viol, void* stream) {
  if (jobs <= 0) return cudaSuccess;
  const bool vec = d % kVec == 0 && aligned16(xh) && aligned16(w) &&
                   (n_shared == 0 || aligned16(xs));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return vec ? launch<__nv_bfloat16, true>(xh, xs, y, m, jobs, per, n_shared,
                                             d, C, tol, max_epochs, alpha, w,
                                             b, epochs, viol, s)
               : launch<__nv_bfloat16, false>(xh, xs, y, m, jobs, per,
                                              n_shared, d, C, tol, max_epochs,
                                              alpha, w, b, epochs, viol, s);
  }
  return vec ? launch<float, true>(xh, xs, y, m, jobs, per, n_shared, d, C,
                                   tol, max_epochs, alpha, w, b, epochs, viol,
                                   s)
             : launch<float, false>(xh, xs, y, m, jobs, per, n_shared, d, C,
                                    tol, max_epochs, alpha, w, b, epochs,
                                    viol, s);
}

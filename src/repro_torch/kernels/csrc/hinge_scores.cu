// Eq. 7 risk scoring: hinge losses of L linear hypotheses over n rows.
//
// Replaces the TPU kernel src/repro/kernels/hinge_score.py:
// hinge_scores (_hinge_kernel, pl.pallas_call at line 52):
//     losses[l] = Σ_i m_i · max(0, 1 − y_i (x_i·w_l + b_l)),  count = Σ_i m_i
//
// The Pallas kernel walks row tiles in order on one core and carries
// the sums in its output block. Here the row tiles are CTAs that run in
// parallel: pass 1 writes one partial (L losses + a count) per CTA,
// pass 2 adds the partials in a fixed order with one thread per
// hypothesis. No float atomics, so reruns are bit-identical.
//
// What bounds it on an H100: the bytes of X. Each row is read once
// (n·d·2 bytes in bf16: 17.2 GB at n = 65536, d = 131072, 5.1 ms at
// 3.35 TB/s); the 2·n·d·L FLOPs in f32 sit below that line. What the
// design does about it: 64 rows per CTA (4 per warp, 16 warps), each
// lane reading 16 bytes of a row at a time; W is staged chunk by chunk
// (L × 1024 f32) in shared memory and shared by the CTA's 64 rows, so
// W's re-reads from L2 cost 1/4 of X's bytes at L = 8 in bf16. The
// (row, hypothesis) dot products stay in registers; the score matrix
// never reaches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;  // 64 rows per CTA
constexpr int kChunk = 1024;                      // columns of W staged
constexpr int kMaxL = 8;                          // hypotheses per launch
constexpr int kVec = 8;

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
hinge_partial_kernel(const T* __restrict__ x, const float* __restrict__ W,
                     const float* __restrict__ bias,
                     const float* __restrict__ y,
                     const float* __restrict__ m, int n, int d, int L,
                     float* __restrict__ part_loss,
                     float* __restrict__ part_cnt) {
  __shared__ __align__(16) float ws[kMaxL * kChunk];
  __shared__ float s_loss[kWarps][kMaxL];
  __shared__ float s_cnt[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kTileRows + warp * kRowsPerWarp;

  float acc[kRowsPerWarp][kMaxL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) acc[r][l] = 0.f;

  for (int c0 = 0; c0 < d; c0 += kChunk) {
    const int cw = min(kChunk, d - c0);
    __syncthreads();  // the previous chunk of W is no longer read
    for (int idx = tid; idx < L * kChunk; idx += kThreads) {
      const int l = idx / kChunk;
      const int j = idx - l * kChunk;
      ws[idx] = j < cw ? W[(size_t)l * d + c0 + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      if (row >= n) continue;
      const T* xr = x + (size_t)row * d + c0;
      if (kVectorized) {
        for (int j = lane * kVec; j < cw; j += 32 * kVec) {
          float xv[kVec];
          load8(xr + j, xv);
#pragma unroll
          for (int l = 0; l < kMaxL; ++l) {
            if (l < L) {
              const float4 w0 =
                  *reinterpret_cast<const float4*>(ws + l * kChunk + j);
              const float4 w1 =
                  *reinterpret_cast<const float4*>(ws + l * kChunk + j + 4);
              acc[r][l] += w0.x * xv[0] + w0.y * xv[1] + w0.z * xv[2] +
                           w0.w * xv[3] + w1.x * xv[4] + w1.y * xv[5] +
                           w1.z * xv[6] + w1.w * xv[7];
            }
          }
        }
      } else {
        for (int j = lane; j < cw; j += 32) {
          const float xv = to_float(xr[j]);
#pragma unroll
          for (int l = 0; l < kMaxL; ++l)
            if (l < L) acc[r][l] += ws[l * kChunk + j] * xv;
        }
      }
    }
  }

  float loss[kMaxL];
#pragma unroll
  for (int l = 0; l < kMaxL; ++l) loss[l] = 0.f;
  float cnt = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[r][l] += __shfl_xor_sync(0xffffffffu, acc[r][l], o);
    }
    const int row = row0 + r;
    if (row < n) {
      const float yi = y[row];
      const float mi = m[row];
#pragma unroll
      for (int l = 0; l < kMaxL; ++l)
        if (l < L) loss[l] += fmaxf(0.f, 1.f - yi * (acc[r][l] + bias[l])) * mi;
      cnt += mi;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) s_loss[warp][l] = loss[l];
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (tid < L) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s += s_loss[k][tid];
    part_loss[(size_t)blockIdx.x * L + tid] = s;
  } else if (tid == kMaxL) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s += s_cnt[k];
    part_cnt[blockIdx.x] = s;
  }
}

// One thread per hypothesis (and one for the count) adds the partials
// of every CTA in CTA order.
__global__ void hinge_reduce_kernel(const float* __restrict__ part_loss,
                                    const float* __restrict__ part_cnt,
                                    int tiles, int L,
                                    float* __restrict__ loss,
                                    float* __restrict__ cnt) {
  const int tid = threadIdx.x;
  if (tid < L) {
    float s = 0.f;
    for (int g = 0; g < tiles; ++g) s += part_loss[(size_t)g * L + tid];
    loss[tid] = s;
  } else if (tid == kMaxL) {
    float s = 0.f;
    for (int g = 0; g < tiles; ++g) s += part_cnt[g];
    *cnt = s;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, bool kVectorized>
void launch_partial(const void* x, const float* W, const float* b,
                    const float* y, const float* m, int n, int d, int L,
                    int tiles, float* part_loss, float* part_cnt,
                    cudaStream_t stream) {
  hinge_partial_kernel<T, kVectorized><<<tiles, kThreads, 0, stream>>>(
      static_cast<const T*>(x), W, b, y, m, n, d, L, part_loss, part_cnt);
}

}  // namespace

extern "C" int hinge_tile_rows() { return kTileRows; }
extern "C" int hinge_max_hypotheses() { return kMaxL; }

// x (n, d) bf16 if is_bf16 else f32; W (L, d), b (L,), y, m (n,) f32;
// scratch part_loss (tiles, L), part_cnt (tiles,) with tiles =
// ceil(n / hinge_tile_rows()); L ≤ hinge_max_hypotheses(). Outputs
// loss (L,), cnt (). Returns a cudaError_t (0 = ok).
extern "C" int hinge_scores(const void* x, int is_bf16, const float* W,
                            const float* b, const float* y, const float* m,
                            int n, int d, int L, int tiles, float* part_loss,
                            float* part_cnt, float* loss, float* cnt,
                            void* stream) {
  if (L < 1 || L > kMaxL || tiles != (n + kTileRows - 1) / kTileRows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles > 0) {
    const bool vec = d % kVec == 0 && aligned16(x);
    if (is_bf16) {
      if (vec)
        launch_partial<__nv_bfloat16, true>(x, W, b, y, m, n, d, L, tiles,
                                            part_loss, part_cnt, s);
      else
        launch_partial<__nv_bfloat16, false>(x, W, b, y, m, n, d, L, tiles,
                                             part_loss, part_cnt, s);
    } else {
      if (vec)
        launch_partial<float, true>(x, W, b, y, m, n, d, L, tiles, part_loss,
                                    part_cnt, s);
      else
        launch_partial<float, false>(x, W, b, y, m, n, d, L, tiles,
                                     part_loss, part_cnt, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  hinge_reduce_kernel<<<1, 32, 0, s>>>(part_loss, part_cnt, tiles, L,
                                            loss, cnt);
  return cudaGetLastError();
}

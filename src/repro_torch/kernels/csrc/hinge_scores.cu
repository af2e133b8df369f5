// Eq. 7 risk scoring: hinge losses of L linear hypotheses over n rows,
// three routes: dense rows by their dtype (bf16, f32), and blocked-CSR
// rows.
//
// Replaces the TPU kernel src/repro/kernels/hinge_score.py:
// hinge_scores (_hinge_kernel, pl.pallas_call at line 52):
//     losses[l] = Σ_i m_i · max(0, 1 − y_i (x_i·w_l + b_l)),  count = Σ_i m_i
//
// The Pallas kernel walks row tiles in order on one core and carries
// the sums in its output block. Here tiles are CTAs that run in
// parallel and write partials, and later passes add them in a fixed
// order. No float atomics, so reruns are bit-identical.
//
// What bounds it on an H100: the bytes of X. Each row is read once
// (n·d·2 bytes in bf16: 17.2 GB at n = 65536, d = 131072, 5.1 ms at
// 3.35 TB/s); the 2·n·d·L flop sit far below that line.
//
// bf16 rows: the tensor cores (hinge_scores_tc), with L ≤ 8 as the n of
// mma.sync.m16n8k16. W is float32 and is not rounded: a first kernel
// (hinge_tc_planes) splits it into three bf16 planes, W = W_hi + W_mid +
// W_lo exactly, and each 16-column step runs one MMA per plane, whose products are
// exact in float32 and summed in float32. X never passes through shared
// memory: lane (g, t) of a warp loads 16 bytes, columns 8t .. 8t + 7 of
// a 32-column step, of rows g and g + 8 of a 16-row tile straight from
// global memory, and those registers are the A fragments of the step's
// two MMAs. Its B fragments are the same 8 columns of W's row g, so the
// order of k inside a step is permuted alike on both sides and no
// reordering of W is needed. Each warp keeps 4 steps × 2 rows of
// 16-byte loads in flight (8 KB a warp, 16 warps an SM) and reads its W
// fragments from shared memory: 1.5 bytes of shared memory per byte of
// X, where the SIMT kernel read 16. Split-K: a CTA holds one 2048-column slab
// of the three planes in shared memory (96 KB, read from L2 once) for
// 1024 rows and writes the n × 8 partial scores of its slab (f32, 0.8 %
// of X's bytes at d = 131072); a second pass sums each row's slabs in
// order, adds the bias, applies the hinge (which is not linear, so the
// slabs are summed first) and reduces the rows of a block in a fixed
// order; a third adds the blocks in order.
//
// float32 rows: SIMT FMAs (hinge_scores), 64 rows per CTA (4 per warp,
// 16 warps), each lane reading 16 bytes of a row at a time; W staged
// chunk by chunk (L × 1024 f32) in shared memory and shared by the
// CTA's 64 rows; one partial (L losses + a count) per CTA.
//
// Blocked-CSR rows (hinge_scores_sparse, the hinge_scores/sparse route).
// The reference has no Pallas kernel for these: its eq. 7 on SparseRows
// is `Xflat @ res.w.T + res.b` through SparseRows.__matmul__, XLA
// gathers (src/repro/core/mapreduce_svm.py:243-247,
// src/repro/sparse.py:104-114); this computes the same function, with
// x_i·w_l = Σ_s v_s W[l, id_s] over the row's nnz_cap slots (values f32
// or bf16, computed in f32). Bound: the rows' slots read once (65536
// rows × 256 slots × 6 bytes in bf16 = 100 MB) and W (L × d f32, 4 MB
// at d = 131072, which stays in L2): 0.031 ms at 3.35 TB/s. Each live
// slot also gathers its column's 8 weights from L2, 32 bytes, which no
// bound of HBM bytes counts. W comes packed, its hypotheses adjacent
// and its columns 16-byte aligned (the cd_solve/sparse kernel's output,
// a (d, 8k) array seen as (L, d); hinge_score.py packs any other W once
// a call), so a column's 8 weights are one 32-byte sector read as two
// 16-byte loads. One warp a row: lane l takes the slots c + 8l .. c + 8l + 7 of
// each 256-slot chunk c, loaded as 16-byte vectors of ids and values
// (scalar loads when nnz_cap % 8 ≠ 0), issues every gather of W for them
// before its first product, and keeps 8 partial dots; value-0 slots are
// skipped. A reduce-scatter over the warp (xor 16: 4 values, 8: 2, 4: 1,
// then xor 2 and 1: 9 shuffles) leaves lane 4h with hypothesis h's dot,
// the same pairwise tree as a full xor butterfly; it adds the bias,
// applies the hinge and the mask and keeps its running sum. A CTA of 8
// warps takes 64 rows and writes one partial (warps added in order);
// the last CTA to finish (a counter the launcher zeroes, with fences)
// adds the partials in a fixed order (lane j of warp h sums tiles j,
// j + 32, ..., then xor shuffles), in the same launch. Products and
// sums are rounded as written (no fma): hinge_score.emulate_sparse
// repeats the arithmetic bit for bit, and reruns are bit-identical.
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

// ---------------------------------------------------------------------------
// Blocked-CSR rows: a warp a row, gathering W at the row's ids.
namespace sp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTileRows = kWarps * kRowsPerWarp;  // 64 rows per CTA
constexpr int kSlots = 8;                          // slots a lane a chunk
constexpr int kChunkSlots = 32 * kSlots;           // 256
constexpr int kCols = kMaxL + 1;                   // a partial: losses, count

// Lane's 8 slots (ids, values as f32) at slot `base` of a row; slots at
// or past cap read as padding (id 0, value 0).
template <typename T, bool kVec>
__device__ __forceinline__ void load_slots(const int* ri, const T* rv,
                                           int base, int cap, int* id,
                                           float* v) {
  if (kVec) {
    if (base < cap) {
      const int4 i0 = *reinterpret_cast<const int4*>(ri + base);
      const int4 i1 = *reinterpret_cast<const int4*>(ri + base + 4);
      id[0] = i0.x; id[1] = i0.y; id[2] = i0.z; id[3] = i0.w;
      id[4] = i1.x; id[5] = i1.y; id[6] = i1.z; id[7] = i1.w;
      if (sizeof(T) == 2) {
        const uint4 raw = *reinterpret_cast<const uint4*>(rv + base);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < kSlots; ++j) v[j] = __bfloat162float(e[j]);
      } else {
        const float4 a = *reinterpret_cast<const float4*>(rv + base);
        const float4 c = *reinterpret_cast<const float4*>(rv + base + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) { id[j] = 0; v[j] = 0.f; }
    return;
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = base + j;
    id[j] = s < cap ? ri[s] : 0;
    v[j] = s < cap ? to_float(rv[s]) : 0.f;
  }
}

// x with lanes l and l ^ o exchanged: the lane keeps `keep`, sends
// `send`, and gets back its partner's `send` for the value it keeps.
__device__ __forceinline__ float swap_add(float keep, float send, int o) {
  return __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
hinge_sparse_kernel(const int* __restrict__ idx, const T* __restrict__ val,
                    int cap, const float* __restrict__ W, long long sd,
                    const float* __restrict__ bias,
                    const float* __restrict__ y,
                    const float* __restrict__ m, int n, int L,
                    float* __restrict__ part, unsigned* counter,
                    float* __restrict__ loss_out,
                    float* __restrict__ cnt_out) {
  __shared__ float s_part[kWarps][kCols];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mine = lane >> 2;           // the hypothesis this lane finishes
  float loss = 0.f, cnt = 0.f;
  const float bh = mine < L ? bias[mine] : 0.f;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = blockIdx.x * kTileRows + r * kWarps + warp;
    if (row >= n) break;
    const int* ri = idx + (size_t)row * cap;
    const T* rv = val + (size_t)row * cap;
    float acc[kMaxL];
#pragma unroll
    for (int h = 0; h < kMaxL; ++h) acc[h] = 0.f;
    for (int c = 0; c < cap; c += kChunkSlots) {
      int id[kSlots];
      float v[kSlots];
      load_slots<T, kVec>(ri, rv, c + kSlots * lane, cap, id, v);
      float wv[kSlots][kMaxL];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), e = a;
        if (v[j] != 0.f) {
          const float4* p =
              reinterpret_cast<const float4*>(W + (size_t)id[j] * sd);
          a = __ldg(p);
          e = __ldg(p + 1);
        }
        wv[j][0] = a.x; wv[j][1] = a.y; wv[j][2] = a.z; wv[j][3] = a.w;
        wv[j][4] = e.x; wv[j][5] = e.y; wv[j][6] = e.z; wv[j][7] = e.w;
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        if (v[j] != 0.f) {
#pragma unroll
          for (int h = 0; h < kMaxL; ++h)
            acc[h] = __fadd_rn(acc[h], __fmul_rn(v[j], wv[j][h]));
        }
    }
    // reduce-scatter: after xor 16, 8 and 4 lane l holds hypothesis
    // (l >> 2)'s sum over the 8 lanes that share its bits 1 and 0
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    float k4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      k4[q] = swap_add(b4 ? acc[q + 4] : acc[q], b4 ? acc[q] : acc[q + 4], 16);
    float k2[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      k2[q] = swap_add(b3 ? k4[q + 2] : k4[q], b3 ? k4[q] : k4[q + 2], 8);
    float dot = swap_add(b2 ? k2[1] : k2[0], b2 ? k2[0] : k2[1], 4);
    dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 2));
    dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 1));
    const float yi = y[row];
    const float mi = m[row];
    const float hinge =
        fmaxf(0.f, __fsub_rn(1.f, __fmul_rn(yi, __fadd_rn(dot, bh))));
    loss = __fadd_rn(loss, __fmul_rn(hinge, mi));
    cnt = __fadd_rn(cnt, mi);
  }
  if ((lane & 3) == 0) s_part[warp][mine] = loss;
  if (lane == 0) s_part[warp][kMaxL] = cnt;
  __syncthreads();
  if (tid < kCols) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s = __fadd_rn(s, s_part[k][tid]);
    part[(size_t)blockIdx.x * kCols + tid] = s;
  }
  // The last CTA to finish adds every CTA's partial.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int col = warp; col < kCols; col += kWarps) {
    if (col < kMaxL && col >= L) continue;
    float s = 0.f;
    for (int t = lane; t < (int)gridDim.x; t += 32)
      s = __fadd_rn(s, __ldcg(part + (size_t)t * kCols + col));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) {
      if (col < kMaxL)
        loss_out[col] = s;
      else
        *cnt_out = s;
    }
  }
}

}  // namespace sp



// ---------------------------------------------------------------------------
// bf16 rows: mma.sync on the tensor cores, split-K over column slabs.
namespace tc {

constexpr int kSlab = 2048;               // columns of W a CTA holds
constexpr int kWRow = kSlab + 8;          // bf16 a shared row (16-byte pad)
constexpr int kPlanes = 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerCta = 1024;
constexpr int kTiles = 1;                 // 16-row tiles a warp carries
constexpr int kUnroll = 4;                // 32-column steps in flight
constexpr int kSmemBytes = kPlanes * kMaxL * kWRow * 2;
constexpr int kFinishRows = 256;          // rows of a finishing block

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 8 bf16 of row `r` (nullptr: a dead row) from column k of the slab;
// columns at or past `live` read as 0.
template <bool kVec>
__device__ __forceinline__ uint4 load_x(const __nv_bfloat16* r, int k,
                                        int live) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r == nullptr || k >= live) return v;
  if (kVec) return *reinterpret_cast<const uint4*>(r + k);
  __align__(16) __nv_bfloat16 e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = k + i < live ? r[k + i] : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint4*>(e);
}

// part[slab][row][l]: x_row · w_l over the slab's columns (l < 8).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
hinge_tc_partial_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ planes, int n,
                        int d, int dp, float* __restrict__ part) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  const int slab = blockIdx.y;
  const int k0 = slab * kSlab;
  const int live = min(kSlab, d - k0);
  constexpr int kChunks = kSlab / 8;
  for (int q = threadIdx.x; q < kPlanes * kMaxL * kChunks; q += kThreads) {
    const int row = q / kChunks, c = q % kChunks;
    *reinterpret_cast<uint4*>(ws + row * kWRow + 8 * c) =
        *reinterpret_cast<const uint4*>(planes + (size_t)row * dp + k0 +
                                        8 * c);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_end = min(n, (blockIdx.x + 1) * kRowsPerCta);
  const int steps = (live + 31) / 32;
  const __nv_bfloat16* wrow = ws + g * kWRow + 8 * t;
  for (int tile0 = blockIdx.x * kRowsPerCta + warp * 16 * kTiles;
       tile0 < r_end; tile0 += kWarps * 16 * kTiles) {
    const __nv_bfloat16* xr[kTiles][2];
    float acc[kTiles][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile0 + 16 * i + 8 * h + g;
        xr[i][h] = row < r_end ? x + (size_t)row * d + k0 : nullptr;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    }
    for (int s0 = 0; s0 < steps; s0 += kUnroll) {
      uint4 xv[kUnroll][kTiles][2];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < kTiles; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xv[u][i][h] = load_x<kVec>(xr[i][h], (s0 + u) * 32 + 8 * t, live);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s0 + u >= steps) break;
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              wrow + p * kMaxL * kWRow + (s0 + u) * 32);
#pragma unroll
          for (int i = 0; i < kTiles; ++i) {
            const uint4 lo = xv[u][i][0], hi = xv[u][i][1];
            mma_bf16(acc[i], lo.x, hi.x, lo.y, hi.y, w.x, w.y);
            mma_bf16(acc[i], lo.z, hi.z, lo.w, hi.w, w.z, w.w);
          }
        }
      }
    }
    // acc[i][2h + e]: row tile0 + 16i + g + 8h, hypothesis 2t + e
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile0 + 16 * i + 8 * h + g;
        if (row < r_end)
          *reinterpret_cast<float2*>(part + ((size_t)slab * n + row) * kMaxL +
                                     2 * t) =
              make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
      }
  }
}

// planes (3, 8, dp) bf16: W's hi, mid and lo planes, each the bf16
// rounding of what the planes before it leave; zero past L rows and d
// columns.
__global__ void hinge_tc_planes_kernel(const float* __restrict__ W, int L,
                                       int d, int dp,
                                       __nv_bfloat16* __restrict__ planes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)kMaxL * dp;
  if (i >= plane) return;
  const int l = (int)(i / dp), k = (int)(i % dp);
  float rest = l < L && k < d ? W[(size_t)l * d + k] : 0.f;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const __nv_bfloat16 h = __float2bfloat16_rn(rest);
    planes[p * plane + i] = h;
    rest = __fsub_rn(rest, __bfloat162float(h));
  }
}

// One thread a row: its slabs summed in order, the bias and the hinge;
// then the block's rows reduced in a fixed order into one partial.
__global__ void __launch_bounds__(kFinishRows)
hinge_tc_finish_kernel(const float* __restrict__ part, int slabs, int n,
                       int L, const float* __restrict__ bias,
                       const float* __restrict__ y,
                       const float* __restrict__ m,
                       float* __restrict__ part_loss,
                       float* __restrict__ part_cnt) {
  __shared__ float s_loss[kFinishRows / 32][kMaxL];
  __shared__ float s_cnt[kFinishRows / 32];
  const int row = blockIdx.x * kFinishRows + threadIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float loss[kMaxL], cnt = 0.f;
#pragma unroll
  for (int l = 0; l < kMaxL; ++l) loss[l] = 0.f;
  if (row < n) {
    float s[kMaxL];
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) s[l] = 0.f;
    for (int k = 0; k < slabs; ++k) {
      const float4* p =
          reinterpret_cast<const float4*>(part + ((size_t)k * n + row) * kMaxL);
      const float4 a = p[0], c = p[1];
      s[0] += a.x; s[1] += a.y; s[2] += a.z; s[3] += a.w;
      s[4] += c.x; s[5] += c.y; s[6] += c.z; s[7] += c.w;
    }
    const float yi = y[row], mi = m[row];
#pragma unroll
    for (int l = 0; l < kMaxL; ++l)
      if (l < L) loss[l] = fmaxf(0.f, 1.f - yi * (s[l] + bias[l])) * mi;
    cnt = mi;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int l = 0; l < kMaxL; ++l)
      loss[l] += __shfl_xor_sync(0xffffffffu, loss[l], o);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  }
  if (lane == 0) {
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) s_loss[warp][l] = loss[l];
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x < L) {
    float a = 0.f;
    for (int w = 0; w < kFinishRows / 32; ++w) a += s_loss[w][threadIdx.x];
    part_loss[(size_t)blockIdx.x * L + threadIdx.x] = a;
  } else if (threadIdx.x == kMaxL) {
    float a = 0.f;
    for (int w = 0; w < kFinishRows / 32; ++w) a += s_cnt[w];
    part_cnt[blockIdx.x] = a;
  }
}

}  // namespace tc

}  // namespace


extern "C" int hinge_tile_rows() { return kTileRows; }
extern "C" int hinge_max_hypotheses() { return kMaxL; }
extern "C" int hinge_tc_slab_cols() { return tc::kSlab; }
extern "C" int hinge_tc_finish_rows() { return tc::kFinishRows; }

// The bf16 planes of W (L, d) f32 for hinge_scores_tc: planes (3, 8, dp)
// bf16 with dp = ceil(d / hinge_tc_slab_cols()) · hinge_tc_slab_cols().
// Returns a cudaError_t (0 = ok).
extern "C" int hinge_tc_planes(const float* W, int L, int d, int dp,
                               void* planes, void* stream) {
  if (L < 1 || L > kMaxL || d < 1 ||
      dp != (d + tc::kSlab - 1) / tc::kSlab * tc::kSlab)
    return cudaErrorInvalidValue;
  const long long total = (long long)kMaxL * dp;
  tc::hinge_tc_planes_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      W, L, d, dp, static_cast<__nv_bfloat16*>(planes));
  return cudaGetLastError();
}

// The float32 route. x (n, d) f32; W (L, d), b (L,), y, m (n,) f32;
// scratch part_loss (tiles, L), part_cnt (tiles,) with tiles =
// ceil(n / hinge_tile_rows()); L ≤ hinge_max_hypotheses(). Outputs
// loss (L,), cnt (). Returns a cudaError_t (0 = ok).
extern "C" int hinge_scores(const float* x, const float* W, const float* b,
                            const float* y, const float* m, int n, int d,
                            int L, int tiles, float* part_loss,
                            float* part_cnt, float* loss, float* cnt,
                            void* stream) {
  if (L < 1 || L > kMaxL || tiles != (n + kTileRows - 1) / kTileRows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles > 0) {
    if (d % kVec == 0 && aligned16(x))
      hinge_partial_kernel<float, true><<<tiles, kThreads, 0, s>>>(
          x, W, b, y, m, n, d, L, part_loss, part_cnt);
    else
      hinge_partial_kernel<float, false><<<tiles, kThreads, 0, s>>>(
          x, W, b, y, m, n, d, L, part_loss, part_cnt);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  hinge_reduce_kernel<<<1, 32, 0, s>>>(part_loss, part_cnt, tiles, L, loss,
                                       cnt);
  return cudaGetLastError();
}

// The bf16 tensor-core route. x (n, d) bf16; planes (3, 8, dp) bf16 from
// hinge_tc_planes; b (L,), y, m (n,) f32. Scratch: part
// (slabs, n, 8) f32; part_loss (blocks, L), part_cnt (blocks,) with
// blocks = ceil(n / hinge_tc_finish_rows()). Outputs loss (L,), cnt ().
// Returns a cudaError_t (0 = ok).
extern "C" int hinge_scores_tc(const void* x, const void* planes, int dp,
                               const float* b, const float* y,
                               const float* m, int n, int d, int L,
                               float* part, int blocks, float* part_loss,
                               float* part_cnt, float* loss, float* cnt,
                               void* stream) {
  const int slabs = (d + tc::kSlab - 1) / tc::kSlab;
  if (L < 1 || L > kMaxL || d < 1 || dp != slabs * tc::kSlab ||
      blocks != (n + tc::kFinishRows - 1) / tc::kFinishRows ||
      !aligned16(planes) || !aligned16(part))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const dim3 grid((n + tc::kRowsPerCta - 1) / tc::kRowsPerCta, slabs);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* pb = static_cast<const __nv_bfloat16*>(planes);
    auto kernel = d % 8 == 0 && aligned16(x)
                      ? tc::hinge_tc_partial_kernel<true>
                      : tc::hinge_tc_partial_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmemBytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, tc::kThreads, tc::kSmemBytes, s>>>(xb, pb, n, d, dp, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    tc::hinge_tc_finish_kernel<<<blocks, tc::kFinishRows, 0, s>>>(
        part, slabs, n, L, b, y, m, part_loss, part_cnt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  hinge_reduce_kernel<<<1, 32, 0, s>>>(part_loss, part_cnt, blocks, L, loss,
                                       cnt);
  return cudaGetLastError();
}

extern "C" int hinge_sparse_tile_rows() { return sp::kTileRows; }
extern "C" int hinge_sparse_partial_cols() { return sp::kCols; }

// idx (n, cap) int32, val (n, cap) f32 (bf16 = 0) or bf16 (bf16 = 1);
// W: L hypotheses of d f32 packed, W[l, j] at W + l + j·sd (elements),
// read as two 16-byte loads a column: sd % 4 = 0, W 16-byte aligned and
// 8 readable floats at every column (cd_solve_sparse's w); b (L,), y, m
// (n,) f32; scratch part
// (tiles, hinge_sparse_partial_cols()) f32 with tiles = max(1,
// ceil(n / hinge_sparse_tile_rows())) and a 4-byte counter (set to 0
// here, before the launch); L ≤ 8. Outputs loss (L,), cnt ().
// Returns a cudaError_t (0 = ok).
extern "C" int hinge_scores_sparse(const void* idx, const void* val, int bf16,
                                   int cap, const float* W, long long sd,
                                   const float* b,
                                   const float* y, const float* m, int n,
                                   int L, int tiles, float* part,
                                   unsigned* counter, float* loss, float* cnt,
                                   void* stream) {
  const int want = n > 0 ? (n + sp::kTileRows - 1) / sp::kTileRows : 1;
  if (L < 1 || L > kMaxL || cap < 1 || tiles != want || sd % 4 != 0 ||
      !aligned16(W))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  const auto* ii = static_cast<const int*>(idx);
  const bool vec = cap % 8 == 0 && aligned16(idx) && aligned16(val);
#define HS_LAUNCH(T, VEC)                                                    \
  sp::hinge_sparse_kernel<T, VEC><<<tiles, sp::kThreads, 0, s>>>(           \
      ii, static_cast<const T*>(val), cap, W, sd, b, y, m, n, L, part,      \
      counter, loss, cnt)
#define HS_LAUNCH_T(T)                                                       \
  if (vec)                                                                   \
    HS_LAUNCH(T, true);                                                      \
  else                                                                       \
    HS_LAUNCH(T, false)
  if (bf16) {
    HS_LAUNCH_T(__nv_bfloat16);
  } else {
    HS_LAUNCH_T(float);
  }
#undef HS_LAUNCH_T
#undef HS_LAUNCH
  return cudaGetLastError();
}

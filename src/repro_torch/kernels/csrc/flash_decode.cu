// Flash-decode: one query token per sequence against the KV cache, GQA.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// flash_decode (_flash_decode_kernel, pl.pallas_call at line 70):
//     out[b, h] = softmax_t(q[b, h]·k[b, kv, t] / √hd, t < valid_len) · v[b, kv]
// with h = kv·G + g (G = H / KV query heads share one KV head),
// positions ≥ valid_len scored −1e30, the softmax and the sums in f32,
// the result cast to q's dtype. valid_len ≤ 0 masks every position, so
// every score is −1e30 and the result is the mean of V over all S slots,
// as in the reference.
//
// What bounds it on an H100: bytes. Each call reads the K and V rows
// below valid_len once: 2 · B · KV · S · hd · 2 bytes in bf16, 1.074 GB
// at B 32, KV 4, S 32768, hd 64, 0.320 ms at 3.35 TB/s. It does
// 4 · G · hd flop per 4 · hd bytes of K and V (8 flop/byte at G = 8),
// far below the ~295 flop/byte of the bf16 tensor cores.
//
// What the design does about it. The Pallas kernel walks the sequence
// axis in order on one core and carries (m, l, acc) across grid steps;
// (B, KV) alone gives 128 CTAs at full width. Here the sequence axis is
// split (flash-decoding): one CTA per (sequence chunk of 512 positions,
// KV head, up to 8 query heads of its group, b) keeps a partial
// (m, l, acc) for its chunk; a second small kernel combines the
// partials of each (b, h) in chunk order, so reruns are bit-identical
// (no atomics). Inside a CTA, TPR neighbouring threads share one cache
// row's head dim, each loading 16 bytes of K and of V (hd 64 bf16: 8
// threads of 8 values, 128 contiguous bytes a row), and two such groups
// take 4 query heads each, so a thread holds 4 heads' q and output in
// registers (≤ 128 registers: 4 CTAs of 128 threads per SM). A thread
// takes 4 rows a batch and updates its online softmax once per batch,
// branch-free (a first version branched per row on a new maximum, and
// a variant held 8 heads a thread at 255 registers and 2 CTAs per SM:
// both ran slower on the card; PERF.md §6, PR 13). Each row slot of
// the CTA keeps its own (m, l, acc); the slots merge in shared memory
// at the end. Chunks past valid_len are not read. The (G, S) score row
// never reaches device memory. Tensor cores and cp.async/TMA pipelining
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;      // query heads per CTA
constexpr int kChunk = 512;   // cache positions per CTA
constexpr int kGPT = 4;       // query heads per thread
constexpr int kHS = kMaxG / kGPT;  // thread groups sharing a row
constexpr int kUnroll = 4;    // rows per thread per batch
constexpr int kMinBlocks = 4; // CTAs per SM: ≤ 128 registers a thread
constexpr float kMask = -1e30f;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;  // values in 16 bytes
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

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
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Loads the K and V vectors of the thread for rows base + u·RP + slot,
// u < kUnroll; rows at or past t1 (and lanes past hd) get zeros. K is
// not read when every position is masked.
template <typename T, int RP>
__device__ __forceinline__ void load_rows(const T* kb, const T* vb, int hd,
                                          int base, int slot, int t1,
                                          bool active, bool all_masked,
                                          uint4* kr, uint4* vr) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = base + u * RP + slot;
    kr[u] = make_uint4(0u, 0u, 0u, 0u);
    vr[u] = make_uint4(0u, 0u, 0u, 0u);
    if (t < t1 && active) {
      if (!all_masked)
        kr[u] = *reinterpret_cast<const uint4*>(kb + (size_t)t * hd);
      vr[u] = *reinterpret_cast<const uint4*>(vb + (size_t)t * hd);
    }
  }
}

// One CTA: positions [split·kChunk, min((split+1)·kChunk, hi)) of KV head
// kvh of sequence b, for query heads g0 .. g0 + Gc − 1 of its group.
// TPR threads share a row's head dim; kHS groups of them take kGPT
// heads each (their loads of the same row coalesce). Writes the chunk's
// partial max pm, sum pl (B, H, nsplit) and unnormed output pacc
// (B, H, nsplit, hd).
template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ valid_len, int H, int KV,
                     int S, int hd, int ngroups, int nsplit, float scale,
                     float* __restrict__ pm, float* __restrict__ pl,
                     float* __restrict__ pacc) {
  constexpr int N = Vec<T>::N;
  constexpr int GPT = kGPT, HS = kHS, U = kUnroll;
  constexpr int RP = kThreads / (TPR * HS);  // row slots of the CTA
  constexpr int W = TPR * N;                 // padded row width
  __shared__ __align__(16) float s_acc[RP * kMaxG * W];
  __shared__ float s_m[RP * kMaxG];
  __shared__ float s_l[RP * kMaxG];
  __shared__ float s_w[RP * kMaxG];  // e^(m_slot − M) per slot and head

  const int tid = threadIdx.x;
  const int r = tid % TPR;                  // position in its row
  const int hg = (tid / TPR) % HS * GPT;    // first head of the thread
  const int slot = tid / (TPR * HS);        // row slot
  const int e0 = r * N;                     // first head-dim element
  const bool active = e0 < hd;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / ngroups;
  const int G = H / KV;
  const int g0 = (blockIdx.y % ngroups) * kMaxG;
  const int Gc = min(kMaxG, G - g0);
  const int b = blockIdx.z;

  float qf[GPT][N];
#pragma unroll
  for (int j = 0; j < GPT; ++j) {
#pragma unroll
    for (int i = 0; i < N; ++i) qf[j][i] = 0.f;
    if (hg + j < Gc && active) {
      const T* qr = q + ((size_t)b * H + kvh * G + g0 + hg + j) * hd + e0;
#pragma unroll
      for (int i = 0; i < N; ++i) qf[j][i] = to_float(qr[i]) * scale;
    }
  }

  const int vlen = *valid_len;
  const bool all_masked = vlen <= 0;
  const int hi = all_masked ? S : min(vlen, S);
  const int t0 = split * kChunk;
  const int t1 = min(t0 + kChunk, hi);
  const size_t row0 = ((size_t)b * KV + kvh) * S;
  const T* kb = k + row0 * hd + e0;
  const T* vb = v + row0 * hd + e0;

  float m[GPT], l[GPT], acc[GPT][N];
#pragma unroll
  for (int j = 0; j < GPT; ++j) {
    m[j] = kMask;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[j][i] = 0.f;
  }

  // The loop bounds are the same for the whole CTA, so every lane of a
  // warp reaches the shuffles; rows past t1 score −inf and weigh 0.
  for (int base = t0; base < t1; base += RP * U) {
    uint4 kr[U], vr[U];
    load_rows<T, RP>(kb, vb, hd, base, slot, t1, active, all_masked, kr, vr);
    float sc[U][GPT];
    float vf[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[N];
      unpack(kr[u], kf, T());
      unpack(vr[u], vf[u], T());
      const bool valid = base + u * RP + slot < t1;
#pragma unroll
      for (int j = 0; j < GPT; ++j) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) s += qf[j][i] * kf[i];
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        sc[u][j] = !valid ? -INFINITY : (all_masked ? kMask : s);
      }
    }
    // Online softmax over the batch: one rescale per head. Masked rows
    // score −1e30 = m and weigh e^0 = 1, as in the Pallas kernel.
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
      float mx = m[j];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][j]);
      const float alpha = __expf(m[j] - mx);
      m[j] = mx;
      l[j] *= alpha;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[j][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = __expf(sc[u][j] - mx);
        l[j] += p;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[j][i] += p * vf[u][i];
      }
    }
  }

  // Merge the row slots: M = max m, L = Σ l·e^(m − M), acc likewise.
#pragma unroll
  for (int j = 0; j < GPT; ++j) {
    const int g = hg + j;
    if (r == 0) {
      s_m[slot * kMaxG + g] = m[j];
      s_l[slot * kMaxG + g] = l[j];
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      s_acc[(slot * kMaxG + g) * W + e0 + i] = acc[j][i];
  }
  __syncthreads();
  const size_t part = ((size_t)b * H + kvh * G + g0) * nsplit + split;
  if (tid < Gc) {
    const int g = tid;
    float M = kMask;
    for (int s = 0; s < RP; ++s) M = fmaxf(M, s_m[s * kMaxG + g]);
    float L = 0.f;
    for (int s = 0; s < RP; ++s) {
      const float w = __expf(s_m[s * kMaxG + g] - M);
      s_w[s * kMaxG + g] = w;
      L += s_l[s * kMaxG + g] * w;
    }
    pm[part + (size_t)g * nsplit] = M;
    pl[part + (size_t)g * nsplit] = L;
  }
  __syncthreads();
  for (int idx = tid; idx < Gc * hd; idx += kThreads) {
    const int g = idx / hd;
    const int e = idx - g * hd;
    float o = 0.f;
    for (int s = 0; s < RP; ++s)
      o += s_acc[(s * kMaxG + g) * W + e] * s_w[s * kMaxG + g];
    pacc[(part + (size_t)g * nsplit) * hd + e] = o;
  }
}

// One CTA per (b, h): the chunks' partials in chunk order → out (B, H, hd).
template <typename T>
__global__ void flash_decode_combine(const float* __restrict__ pm,
                                     const float* __restrict__ pl,
                                     const float* __restrict__ pacc,
                                     int nsplit, int hd,
                                     T* __restrict__ out) {
  const size_t bh = blockIdx.x;
  const float* m = pm + bh * nsplit;
  float M = kMask;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, m[s]);
  float L = 0.f;
  for (int s = 0; s < nsplit; ++s) L += pl[bh * nsplit + s] * __expf(m[s] - M);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int e = threadIdx.x; e < hd; e += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < nsplit; ++s)
      o += pacc[(bh * nsplit + s) * hd + e] * __expf(m[s] - M);
    store(out + bh * hd + e, o * inv);
  }
}

template <typename T, int TPR>
void launch_partial(dim3 grid, cudaStream_t s, const void* q, const void* k,
                    const void* v, const int* vlen, int H, int KV, int S,
                    int hd, int ngroups, int nsplit, float scale, float* pm,
                    float* pl, float* pacc) {
  flash_decode_partial<T, TPR><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), vlen, H, KV, S, hd, ngroups, nsplit, scale,
      pm, pl, pacc);
}

template <typename T>
int launch_all(const void* q, const void* k, const void* v, const int* vlen,
               int B, int H, int KV, int S, int hd, float scale, float* pm,
               float* pl, float* pacc, void* out, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  int tpr = 1;
  while (tpr * N < hd) tpr *= 2;
  const int G = H / KV;
  const int ngroups = (G + kMaxG - 1) / kMaxG;
  const int nsplit = (S + kChunk - 1) / kChunk;
  const dim3 grid(nsplit, KV * ngroups, B);
#define FD_CASE(TP)                                                        \
  case TP:                                                                 \
    launch_partial<T, TP>(grid, s, q, k, v, vlen, H, KV, S, hd, ngroups,   \
                          nsplit, scale, pm, pl, pacc);                    \
    break;
  switch (tpr) {
    FD_CASE(1)
    FD_CASE(2)
    FD_CASE(4)
    FD_CASE(8)
    FD_CASE(16)
    FD_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef FD_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine<T><<<B * H, 64, 0, s>>>(pm, pl, pacc, nsplit, hd,
                                                static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// Chunks of the sequence axis: the partials are (B, H, splits) and
// (B, H, splits, hd) float32.
extern "C" int flash_decode_splits(int S) { return (S + kChunk - 1) / kChunk; }

// Largest head dim one thread row covers (32 lanes × 16 bytes).
extern "C" int flash_decode_max_hd(int is_bf16) {
  return 32 * (is_bf16 ? Vec<__nv_bfloat16>::N : Vec<float>::N);
}

// q (B, H, hd), k, v (B, KV, S, hd), all bf16 if is_bf16 else f32,
// contiguous, 16-byte aligned; valid_len () int32 on the device;
// scratch pm, pl (B, H, splits), pacc (B, H, splits, hd) f32 with
// splits = flash_decode_splits(S); out (B, H, hd) in q's dtype.
// hd a multiple of 16 bytes' worth of values and ≤ flash_decode_max_hd.
// Returns a cudaError_t (0 = ok).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* valid_len, int is_bf16, int B, int H,
                            int KV, int S, int hd, float scale, float* pm,
                            float* pl, float* pacc, void* out,
                            void* stream) {
  const int N = is_bf16 ? Vec<__nv_bfloat16>::N : Vec<float>::N;
  if (B < 1 || KV < 1 || S < 1 || H % KV != 0 || hd % N != 0 ||
      hd > flash_decode_max_hd(is_bf16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_all<__nv_bfloat16>(q, k, v, valid_len, B, H, KV, S, hd,
                                     scale, pm, pl, pacc, out, s);
  return launch_all<float>(q, k, v, valid_len, B, H, KV, S, hd, scale, pm,
                           pl, pacc, out, s);
}

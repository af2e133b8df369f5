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
// far below the ~295 flop/byte of the bf16 tensor cores, so the kernel
// must stream K and V at the HBM rate while issuing few instructions.
//
// Shared by both routes. The Pallas kernel walks the sequence axis in
// order on one core and carries (m, l, acc) across grid steps; (B, KV)
// alone gives 128 CTAs at full width. Here the sequence axis is split
// (flash-decoding): one CTA per (sequence chunk, KV head, up to 8 query
// heads of its group, b) keeps a partial (m, l, acc) for its chunk; a
// second small kernel combines the partials of each (b, h) in chunk
// order, so reruns are bit-identical (no atomics). It is launched as a
// programmatic dependent, so its launch hides under the partial
// kernel's last wave, and loads up to 8 chunks' partials in one round
// trip. Chunks past valid_len are not read; the (G, S) score row never
// reaches device memory. The route is chosen in Python
// (ops.decode_route).
//
// bf16 rows, hd % 16 == 0, hd ≤ 128: the tensor cores
// (flash_decode_tc_partial). The SIMT kernel below issues ~2 · G · hd
// FMAs, shuffle reductions and two bf16 → f32 conversions per cache row
// and read at 54 % of the HBM rate (PERF.md §6). Here a CTA of 8 warps
// takes a chunk of up to kChunkTc = 4096 rows (halved while the grid
// would hold fewer than two CTAs an SM); warp w takes its 16-row stages
// (stage j: rows t0 + (8j + w) · 16) through a warp-private cp.async
// ring in shared memory, 4 stages deep (3 at hd ≥ 112), with the L2
// told to fetch 256 bytes around each miss; rows are padded by 16
// bytes, so ldmatrix is free of bank conflicts. Both products run as
// mma.sync.m16n8k16 (bf16 in, f32 accumulate):
//   QKᵀ: A = the CTA's ≤ 8 query heads, padded to 16 rows with zeros
//        (registers, loaded once), B = 16 cache rows of K (ldmatrix).
//        bf16 × bf16 products are exact in f32, so the scores match the
//        f32 plain version up to summation order; the scale goes on
//        after the dot (exact for hd = 64).
//   PV:  A = the probabilities, B = 16 rows of V (ldmatrix.trans). The
//        score accumulator's layout is the A operand's layout, so P
//        never leaves registers. P is f32 in [0, 1] and goes in as two
//        bf16 planes, hi = bf16(p) and lo = bf16(p − hi), in two MMAs:
//        |p − hi − lo| ≤ 2⁻¹⁶ p, so the f32 semantics hold (the tensor
//        cores have ~30× headroom here; the second plane costs no
//        measurable time).
// The online softmax runs once per stage: a quad of lanes holds one
// head's 4 of the stage's 16 scores, so a row maximum is two shuffles.
// The padded head rows waste half of each MMA, which the headroom pays
// for. The warps' partials merge in shared memory, in warp order, in
// the space of the drained rings.
//
// f32 rows (and bf16 head dims the tensor-core route does not take):
// SIMT FMAs (flash_decode_partial). TPR neighbouring threads share one
// cache row's head dim, each loading 16 bytes of K and of V, and two
// such groups take 4 query heads each, so a thread holds 4 heads' q and
// output in registers (≤ 128 registers: 4 CTAs of 128 threads per SM).
// A thread takes 4 rows a batch and updates its online softmax once per
// batch, branch-free (PERF.md §6). Each row slot of the CTA keeps
// its own (m, l, acc); the slots merge in shared memory at the end.
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
  // The combine kernel may launch once every CTA of this grid started.
  asm volatile("griddepcontrol.launch_dependents;");

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

// One CTA per (b, h), one thread per output element: the chunks'
// partials in chunk order → out (B, H, hd). Up to kCombineBatch chunks
// are loaded in one round trip.
constexpr int kCombineBatch = 8;

template <typename T>
__global__ void flash_decode_combine(const float* __restrict__ pm,
                                     const float* __restrict__ pl,
                                     const float* __restrict__ pacc,
                                     int nsplit, int hd,
                                     T* __restrict__ out) {
  // Launched as a programmatic dependent of the partial kernel: its CTAs
  // may be resident before the partials are written; wait for them.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const size_t bh = blockIdx.x;
  const int e = threadIdx.x;
  const float* m = pm + bh * nsplit;
  const float* l = pl + bh * nsplit;
  const float* a = pacc + bh * nsplit * hd + e;
  float M = kMask, L = 0.f, o = 0.f;
  if (nsplit <= kCombineBatch) {
    float mv[kCombineBatch], lv[kCombineBatch], av[kCombineBatch];
#pragma unroll
    for (int s = 0; s < kCombineBatch; ++s) {
      if (s < nsplit) {
        mv[s] = m[s];
        lv[s] = l[s];
        av[s] = a[(size_t)s * hd];
      }
    }
#pragma unroll
    for (int s = 0; s < kCombineBatch; ++s)
      if (s < nsplit) M = fmaxf(M, mv[s]);
#pragma unroll
    for (int s = 0; s < kCombineBatch; ++s) {
      if (s < nsplit) {
        const float w = __expf(mv[s] - M);
        L += lv[s] * w;
        o += av[s] * w;
      }
    }
  } else {
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, m[s]);
    for (int s = 0; s < nsplit; ++s) {
      const float w = __expf(m[s] - M);
      L += l[s] * w;
      o += a[(size_t)s * hd] * w;
    }
  }
  store(out + bh * hd + e, o * (1.f / fmaxf(L, 1e-30f)));
}

// The combine kernel on `s`, allowed to launch before the partial
// kernel ahead of it ends (its CTAs wait in griddepcontrol.wait), so
// its launch and ramp hide under the partial kernel's last wave.
template <typename T>
cudaError_t launch_combine(int BH, const float* pm, const float* pl,
                           const float* pacc, int nsplit, int hd, void* out,
                           cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH);
  cfg.blockDim = dim3(hd);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_combine<T>, pm, pl, pacc,
                            nsplit, hd, static_cast<T*>(out));
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
  err = launch_combine<T>(B * H, pm, pl, pacc, nsplit, hd, out, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 rows, hd % 16 == 0, hd ≤ 128: mma.sync on the tensor cores.
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;             // ring stages per warp, at most
constexpr int kRows = 16;              // cache rows per stage
constexpr int kChunkTc = 4096;         // cache positions per CTA, at most
constexpr int kMinChunkTc = 512;       // … and at least
constexpr int kMaxHd = 128;
constexpr size_t kSmemMax = 232448;    // dynamic shared memory a CTA

// Ring stages per warp at head dim hd: kStages, fewer where the CTA's
// rings would not fit its shared memory (3 at hd ≥ 112).
__host__ __device__ constexpr int stages_for(int hd) {
  return (size_t)kStages * kWarps * 2 * kRows * (hd + 8) * 2 <= kSmemMax
             ? kStages
             : (int)(kSmemMax / ((size_t)kWarps * 2 * kRows * (hd + 8) * 2));
}
// CTAs an SM must hold at hd: 2 (≤ 128 registers) while two fit.
__host__ __device__ constexpr int min_blocks_for(int hd) {
  return kWarps < 16 && 2 * (size_t)stages_for(hd) * kWarps * 2 * kRows *
                                (hd + 8) * 2 <= kSmemMax ? 2 : 1;
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// L2 fetches 256 bytes around each miss: K/V rows stream in order.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, 16;"
               ::"r"(dst), "l"(src)
               : "memory");
}

// 16 zero bytes into shared memory, for rows past the chunk's end.
__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The thread's copies of all but the newest N groups landed.
template <int N>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += A·B, m16n8k16, A rows 8..15 zero (a1 = a3 = 0).
__device__ __forceinline__ void mma_half(float* c, uint32_t a0, uint32_t a2,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo_elem, float hi_elem) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_elem, hi_elem);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Shared memory of a CTA: each warp's ring (stages_for(hd) stages of
// kRows K rows then kRows V rows, hd + 8 bf16 a row); the warps'
// partials reuse it for the merge once every ring is drained.
__host__ __device__ constexpr size_t ring_bytes(int hd) {
  return (size_t)kWarps * stages_for(hd) * 2 * kRows * (hd + 8) * 2;
}
__host__ __device__ constexpr size_t merge_bytes(int hd) {
  return ((size_t)kWarps * kMaxG * hd + 3 * kWarps * kMaxG) * 4;
}
__host__ __device__ constexpr size_t smem_bytes(int hd) {
  return ring_bytes(hd) > merge_bytes(hd) ? ring_bytes(hd) : merge_bytes(hd);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, min_blocks_for(HD))
flash_decode_tc_partial(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int* __restrict__ valid_len, int H, int KV,
                        int S, int ngroups, int nsplit, int chunk,
                        float scale, float* __restrict__ pm,
                        float* __restrict__ pl, float* __restrict__ pacc) {
  constexpr int KS = HD / 16;     // k-steps of QKᵀ
  constexpr int NT = HD / 8;      // 8-column output tiles of PV
  constexpr int RS = HD + 8;      // shared row stride, bf16
  constexpr int CH = HD / 8;      // 16-byte chunks a row
  constexpr int STAGE = 2 * kRows * RS;
  constexpr int kStages = stages_for(HD);
  extern __shared__ uint4 smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;        // the lane's head (A and C row)
  const int t4 = lane & 3;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / ngroups;
  const int G = H / KV;
  const int g0 = (blockIdx.y % ngroups) * kMaxG;
  const int Gc = min(kMaxG, G - g0);
  const int b = blockIdx.z;

  // The combine kernel may launch once every CTA of this grid started.
  asm volatile("griddepcontrol.launch_dependents;");
  bf16* ring = smem + (size_t)warp * kStages * STAGE;
  float* s_acc = reinterpret_cast<float*>(smem);  // after the rings drain
  float* s_m = s_acc + kWarps * kMaxG * HD;
  float* s_l = s_m + kWarps * kMaxG;
  float* s_w = s_l + kWarps * kMaxG;

  // Q as the A operand: head g's row; rows 8..15 of A are zero.
  uint32_t qa[KS][2];
  {
    const bool live = g < Gc;
    const bf16* qr = q + ((size_t)b * H + kvh * G + g0 + (live ? g : 0)) * HD;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = live ? *reinterpret_cast<const uint32_t*>(
                             qr + ks * 16 + 2 * t4) : 0u;
      qa[ks][1] = live ? *reinterpret_cast<const uint32_t*>(
                             qr + ks * 16 + 8 + 2 * t4) : 0u;
    }
  }

  const int vlen = *valid_len;
  const bool all_masked = vlen <= 0;
  const int hi = all_masked ? S : min(vlen, S);
  const int t0 = split * chunk;
  const int t1 = min(t0 + chunk, hi);
  const size_t row0 = ((size_t)b * KV + kvh) * S;
  const bf16* kb = k + row0 * HD;
  const bf16* vb = v + row0 * HD;
  const int span = kRows * kWarps;
  const int nstage = t1 > t0 ? (t1 - t0 + span - 1) / span : 0;

  // Stage j of this warp: rows t0 + (j·kWarps + warp)·kRows + 0..15.
  auto issue = [&](int j) {
    if (j < nstage) {
      bf16* st = ring + (j % kStages) * STAGE;
      const int base = t0 + (j * kWarps + warp) * kRows;
#pragma unroll
      for (int qd = lane; qd < kRows * CH; qd += 32) {
        const int r = qd / CH, c = qd % CH;
        bf16* dk = st + r * RS + c * 8;
        bf16* dv = st + (kRows + r) * RS + c * 8;
        if (base + r < t1) {
          const size_t off = (size_t)(base + r) * HD + c * 8;
          cp16(smem_addr(dk), kb + off);
          cp16(smem_addr(dv), vb + off);
        } else {
          zero16(dk);
          zero16(dv);
        }
      }
    }
    cp_commit();
  };

  float m_run = kMask, l_run = 0.f;   // head g; l over this lane's rows
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  for (int j = 0; j < nstage; ++j) {
    __syncwarp();  // every lane is done with the slot refilled next
    issue(j + kStages - 1);
    cp_wait_group<kStages - 1>();
    __syncwarp();  // the other lanes' copies of stage j are visible
    const bf16* st = ring + (j % kStages) * STAGE;
    const int base = t0 + (j * kWarps + warp) * kRows;

    // Scores of head g for rows 2·t4 + {0, 1} (tile 0) and 8 + … (tile 1).
    float c[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
    {
      const int mi = lane >> 3;
      const int row = (mi >> 1) * 8 + (lane & 7);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_addr(st + row * RS + ks * 16 + (mi & 1) * 8));
        mma_half(c[0], qa[ks][0], qa[ks][1], kf[0], kf[1]);
        mma_half(c[1], qa[ks][0], qa[ks][1], kf[2], kf[3]);
      }
    }
    float sc[2][2];
    float mx = m_run;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = base + n * 8 + 2 * t4 + e;
        sc[n][e] = t >= t1 ? -INFINITY
                           : (all_masked ? kMask : c[n][e] * scale);
        mx = fmaxf(mx, sc[n][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // Masked rows score −1e30 = m and weigh e^0 = 1, as in the Pallas
    // kernel; rows past the chunk score −inf and weigh 0.
    const float alpha = __expf(m_run - mx);
    m_run = mx;
    l_run *= alpha;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha;
      acc[nt][1] *= alpha;
    }
    float p[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[n][e] = __expf(sc[n][e] - mx);
        l_run += p[n][e];
      }
    // P as two bf16 planes: A's k = 2·t4 + {0, 1} is tile 0, + 8 tile 1.
    const uint32_t hi0 = pack(p[0][0], p[0][1]);
    const uint32_t hi1 = pack(p[1][0], p[1][1]);
    const float2 h0 = unpack2(hi0), h1 = unpack2(hi1);
    const uint32_t lo0 = pack(p[0][0] - h0.x, p[0][1] - h0.y);
    const uint32_t lo1 = pack(p[1][0] - h1.x, p[1][1] - h1.y);
    {
      const int mi = lane >> 3;
      const int row = kRows + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, smem_addr(st + row * RS + np * 16 + (mi >> 1) * 8));
        mma_half(acc[2 * np], hi0, hi1, vf[0], vf[1]);
        mma_half(acc[2 * np], lo0, lo1, vf[0], vf[1]);
        mma_half(acc[2 * np + 1], hi0, hi1, vf[2], vf[3]);
        mma_half(acc[2 * np + 1], lo0, lo1, vf[2], vf[3]);
      }
    }
  }
  cp_wait_all();
  __syncthreads();  // every ring is drained: the merge buffers reuse them

  // The quad's lanes hold disjoint rows of head g: sum their l.
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  if (t4 == 0) {
    s_m[warp * kMaxG + g] = m_run;
    s_l[warp * kMaxG + g] = l_run;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* dst = s_acc + (warp * kMaxG + g) * HD + nt * 8 + 2 * t4;
    dst[0] = acc[nt][0];
    dst[1] = acc[nt][1];
  }
  __syncthreads();
  // Merge the warps in warp order: M = max m, L = Σ l·e^(m − M), acc alike.
  const size_t part = ((size_t)b * H + kvh * G + g0) * nsplit + split;
  if (tid < Gc) {
    float M = kMask;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w * kMaxG + tid]);
    float L = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = __expf(s_m[w * kMaxG + tid] - M);
      s_w[w * kMaxG + tid] = wt;
      L += s_l[w * kMaxG + tid] * wt;
    }
    pm[part + (size_t)tid * nsplit] = M;
    pl[part + (size_t)tid * nsplit] = L;
  }
  __syncthreads();
  for (int idx = tid; idx < Gc * HD; idx += kThreads) {
    const int hg = idx / HD;
    const int e = idx - hg * HD;
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w)
      o += s_acc[(w * kMaxG + hg) * HD + e] * s_w[w * kMaxG + hg];
    pacc[(part + (size_t)hg * nsplit) * HD + e] = o;
  }
}

template <int HD>
cudaError_t launch_partial(dim3 grid, cudaStream_t s, const void* q,
                           const void* k, const void* v, const int* vlen,
                           int H, int KV, int S, int ngroups, int nsplit,
                           int chunk, float scale, float* pm, float* pl,
                           float* pacc) {
  auto kernel = flash_decode_tc_partial<HD>;
  const size_t smem = smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), vlen, H, KV, S, ngroups, nsplit, chunk,
      scale, pm, pl, pacc);
  return cudaGetLastError();
}

// Cache positions a CTA reads: kChunkTc, halved (down to kMinChunkTc)
// while the grid would hold fewer than two CTAs per SM.
int chunk_for(int B, int H, int KV, int S) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const long long pairs = (long long)B * KV * ((H / KV + kMaxG - 1) / kMaxG);
  int chunk = kChunkTc;
  while (chunk > kMinChunkTc && pairs * ((S + chunk - 1) / chunk) < 2 * sms)
    chunk /= 2;
  return chunk;
}

}  // namespace tc
}  // namespace

// Cache positions one CTA of the route (tc: the tensor-core route)
// reads at this shape; the partials are (B, H, splits) and (B, H,
// splits, hd) float32 with splits = ⌈S / chunk⌉.
extern "C" int flash_decode_chunk(int tc, int B, int H, int KV, int S) {
  return tc ? tc::chunk_for(B, H, KV, S) : kChunk;
}

// Largest head dim one thread row covers (32 lanes × 16 bytes).
extern "C" int flash_decode_max_hd(int is_bf16) {
  return 32 * (is_bf16 ? Vec<__nv_bfloat16>::N : Vec<float>::N);
}

// q (B, H, hd), k, v (B, KV, S, hd), all bf16 if is_bf16 else f32,
// contiguous, 16-byte aligned; valid_len () int32 on the device;
// scratch pm, pl (B, H, splits), pacc (B, H, splits, hd) f32 with
// splits = ⌈S / flash_decode_chunk(0, …)⌉; out (B, H, hd) in q's dtype.
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

// Tensor-core route: as flash_decode, for bf16 q, k, v with hd a
// multiple of 16 up to flash_decode_tc_max_hd().
extern "C" int flash_decode_tc_max_hd() { return tc::kMaxHd; }

extern "C" int flash_decode_tc(const void* q, const void* k, const void* v,
                               const int* valid_len, int B, int H, int KV,
                               int S, int hd, float scale, float* pm,
                               float* pl, float* pacc, void* out,
                               void* stream) {
  if (B < 1 || KV < 1 || S < 1 || H % KV != 0 || hd % 16 != 0 || hd < 16 ||
      hd > tc::kMaxHd)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  const int ngroups = (G + kMaxG - 1) / kMaxG;
  const int chunk = tc::chunk_for(B, H, KV, S);
  const int nsplit = (S + chunk - 1) / chunk;
  const dim3 grid(nsplit, KV * ngroups, B);
  cudaError_t err;
#define FD_TC_CASE(D)                                                      \
  case D:                                                                  \
    err = tc::launch_partial<D>(grid, s, q, k, v, valid_len, H, KV, S,     \
                                ngroups, nsplit, chunk, scale, pm, pl,     \
                                pacc);                                     \
    break;
  switch (hd) {
    FD_TC_CASE(16)
    FD_TC_CASE(32)
    FD_TC_CASE(48)
    FD_TC_CASE(64)
    FD_TC_CASE(80)
    FD_TC_CASE(96)
    FD_TC_CASE(112)
    FD_TC_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FD_TC_CASE
  if (err != cudaSuccess) return err;
  err = launch_combine<__nv_bfloat16>(B * H, pm, pl, pacc, nsplit, hd, out,
                                      s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

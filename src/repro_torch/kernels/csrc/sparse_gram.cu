// Gram matrix K = k(X, Zᵀ) of blocked-CSR rows (fixed nnz_cap slots of
// column id / value, (0, 0) on padding), of one or more jobs, with the
// fused linear / poly / rbf epilogue of gram.cu; and the fused decision
// scores S = k(X, Zᵀ)·coefᵀ + b of the same rows, which never writes K.
//
// Replaces the TPU kernel src/repro/kernels/gram.py: sparse_gram
// (_sparse_gram_kernel, pl.pallas_call at line 201). It computes the
// same function: K_ij = Σ over slot pairs with equal column ids of
// x_v · z_v (duplicate ids sum, padding adds 0), f32 sums from f32-cast
// values, norms Σ v², the same transforms, with γ and coef0 read from
// the card, one of each a job. Rows of job l are those of home block
// l % n_home, then those of shared block l / jobs_per_shared, as in
// gram.cu, so a sweep's S·L augmented partitions go in one launch.
//
// It does NOT carry over the TPU's index match, which spends px·pz
// compare-selects on every pair (65536 at nnz_cap 256) to find the
// ~0.5 column ids two TF×IDF rows share at d = 131072. Instead Z's
// nonzero slots are handed in a CSC view keyed by (job, Z tile,
// column), built once per call by the wrapper with a stable sort: for
// Z tile T (up to kMaxTile consecutive Z rows) and column c, the Z rows
// of the tile that hold c and their values, in row order.
//
// One warp owns one (query row i, Z tile T, job): it accumulates row
// i's dot products against the tile in its own segment of shared
// memory. Each lane holds 8 of x_i's nonzero slots (c, v) and the
// bounds of their columns' lists in the tile. For each 32 slots, their
// lists in slot order form one flat sequence of entries (about 128 at
// full width); its lanes take 32 consecutive entries a round (a list
// marks where it starts, a prefix maximum over the lanes finds each
// entry's list) and add v · z_v into the segment, the entries of 2
// rounds loaded before their adds. So lanes stay busy whatever the
// lists' lengths, and a warp waits for about one round trip per 64
// entries. The adds go in a fixed order: rounds in sequence, and where
// two lanes of a round hit the same Z row (a stamp byte a column finds
// it), in lane order, a warp barrier apart; so reruns are
// bit-identical. Then the transform runs on the segment, and:
//   * the Gram route writes the tile's slice of K's row once,
//     coalesced;
//   * the scores route rounds each k to coef's dtype (as the plain
//     K.to(coef.dtype) @ coef does), reduces the segment against each
//     hypothesis's coefficients of the tile in float32 and writes one
//     partial per (row, hypothesis, tile); a second kernel adds the
//     tiles' partials in tile order and the bias. K never goes to
//     memory. A hypothesis whose coefficients of a tile are all 0 skips
//     the tile, and a tile that none reads is not computed: in eq. 7,
//     where hypothesis l's coefficients are 0 off its job's rows, a
//     partition's tiles feed one hypothesis and the SV tiles all.
// What bounds it on an H100: by the count, bytes (the Gram route writes
// K, n·m·4 bytes) and, for the scores route, the exps (one a pair for
// rbf); as measured (PERF.md §6), the warp's work a (row, tile) — the
// list bounds' loads, the rounds' shuffles, stamps and adds, then the
// transform — of which the index matches take the most. The list
// entries come from L2: the grid's fastest dimension is the query row,
// so one (job, tile)'s lists stay hot.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // warps a CTA
constexpr int kMaxTile = 2048;     // Z rows a tile
constexpr int kChunk = 256;        // slots a lane's registers hold 8 of
constexpr int kAhead = 2;          // rounds of 32 entries loaded at once

enum Kind { kLinear = 0, kPoly = 1, kRbf = 2 };

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

// Σ float(v)² over the slots of `rows` rows; one thread per row.
template <typename T>
__global__ void slot_sq_norms_kernel(const T* __restrict__ v, long long rows,
                                     int cap, float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* p = v + (size_t)r * cap;
  float s = 0.f;
  for (int k = 0; k < cap; ++k) {
    const float f = to_float(p[k]);
    s = fmaf(f, f, s);
  }
  out[r] = s;
}

// Index of row i of job `job` among all home rows (i < per) or among
// all shared rows (i ≥ per): home block job % n_home, shared block
// job / jps.
__device__ __forceinline__ long long block_row(int n_home, int per, int jps,
                                               int n_shared, int job, int i) {
  return i < per ? (long long)(job % n_home) * per + i
                 : (long long)(job / jps) * n_shared + (i - per);
}

struct XRows {
  const int* hi;          // home indices (n_home · per, cap)
  const void* hv;         // home values
  int n_home;             // home blocks
  int per;
  const int* si;          // shared indices (shared blocks · S, cap)
  const void* sv;
  int n_shared;           // rows a shared block
  int jps;                // jobs a shared block
  int n;                  // per + S
  long long home_total;   // norm index of the first shared row
};

struct ZView {
  int n;                  // Z rows a job
  int tile;               // Z rows a tile
  int tiles;
  const int* start;       // CSC list bounds by (job, tile, column)
  const int* end;
  long long off_job_stride;   // tiles · d, or 0 when Z has one job
  const int2* ent;        // (Z row in its job, float bits of its value)
  int n_home;             // Z norms: as XRows
  int per;
  int n_shared;
  int jps;
  long long home_total;
};

// The transform's arguments: γ and coef0 of every job, on the card (a
// kernel reads its job's pair once into registers).
struct Transform {
  int kind;
  const float* gamma;
  const float* coef0;
  int degree;
  const float* xnorm;
  const float* znorm;
};

// acc[zr] += pv for each lane with zr ≥ 0, in a fixed order. Each such
// lane writes its id into stamp[zr]; where every lane reads its own id
// back, the targets differ and all add at once. Otherwise (rare: two
// slots of a row, one Z row) lanes that share a target add in lane
// order, one warp barrier apart. So the order of the adds into each
// entry is fixed, and reruns are bit-identical.
__device__ __forceinline__ void add_round(float* acc, unsigned char* stamp,
                                          int zr, float pv) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (zr >= 0) stamp[zr] = (unsigned char)lane;
  __syncwarp();
  if (__all_sync(all, zr < 0 || stamp[zr] == lane)) {
    if (zr >= 0) acc[zr] += pv;
  } else {
    const unsigned peers = __match_any_sync(all, zr >= 0 ? zr : -1 - lane);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const int last = __reduce_max_sync(all, (unsigned)rank);
    for (int k = 0; k <= last; ++k) {
      if (zr >= 0 && rank == k) acc[zr] += pv;
      __syncwarp();
    }
  }
  __syncwarp();
}

// Shared memory of a warp, in floats: the tile's sums, one stamp byte a
// tile column, the list starts of kAhead rounds.
__host__ __device__ constexpr int warp_floats(int tile) {
  return tile + tile / 4 + 32 * kAhead;
}

// Row i of X (job `job`) against Z tile `tile` of job `job` into acc
// (the warp's segment, warp_floats(tile) wide), untransformed.
template <typename T>
__device__ __forceinline__ void accumulate(const XRows& x, int cap, int d,
                                           const ZView& z, int job, int tile,
                                           int i, float* acc, int width) {
  const int lane = threadIdx.x & 31;
  const long long xr = block_row(x.n_home, x.per, x.jps, x.n_shared, job, i);
  const int* xi = (i < x.per ? x.hi : x.si) + (size_t)xr * cap;
  const T* xv = static_cast<const T*>(i < x.per ? x.hv : x.sv) +
                (size_t)xr * cap;
  const long long o0 = job * z.off_job_stride + (long long)tile * d;
  const int* starts = z.start + o0;
  const int* ends = z.end + o0;
  const int c0 = tile * z.tile;
  unsigned char* stamp = reinterpret_cast<unsigned char*>(acc + z.tile);
  int* mark = reinterpret_cast<int*>(acc + z.tile + z.tile / 4);

  for (int c = lane; c < width; c += 32) acc[c] = 0.f;
  constexpr int G = kChunk / 32;
  for (int p00 = 0; p00 < cap; p00 += kChunk) {
    // lane q of group g holds slot p00 + 32g + q: its value and the
    // tile's list [lo, lo + len), all loaded before the first add
    float v[G];
    int col[G], lo[G], len[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int p = p00 + 32 * g + lane;
      v[g] = p < cap ? to_float(xv[p]) : 0.f;
      col[g] = p < cap ? xi[p] : 0;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      lo[g] = v[g] != 0.f ? starts[col[g]] : 0;
      len[g] = v[g] != 0.f ? ends[col[g]] - lo[g] : 0;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // the group's lists in slot order form one flat sequence; lane
      // q's starts at `start`
      int incl = len[g];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const int start = incl - len[g];
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      int carry = 0;
      for (int base = 0; base < total; base += 32 * kAhead) {
        // each list starting in the window marks its position; a
        // position's list is the last mark at or before it
#pragma unroll
        for (int a = 0; a < kAhead; ++a) mark[32 * a + lane] = -1;
        __syncwarp();
        if (len[g] > 0 && start >= base && start < base + 32 * kAhead)
          mark[start - base] = lane;
        __syncwarp();
        int zr[kAhead];
        float pv[kAhead];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          int q = mark[32 * a + lane];
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, q, o);
            if (lane >= o) q = max(q, t);
          }
          q = max(q, carry);
          carry = __shfl_sync(0xffffffffu, q, 31);
          const int f = base + 32 * a + lane;
          const int e = __shfl_sync(0xffffffffu, lo[g], q) + f -
                        __shfl_sync(0xffffffffu, start, q);
          const float vq = __shfl_sync(0xffffffffu, v[g], q);
          zr[a] = -1;
          pv[a] = 0.f;
          if (f < total) {
            const int2 en = z.ent[e];
            zr[a] = en.x - c0;
            pv[a] = __fmul_rn(vq, __int_as_float(en.y));
          }
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) add_round(acc, stamp, zr[a], pv[a]);
      }
    }
  }
}

// Row norms for one job: row i's is home[i] for i < per, else shared[i];
// the block offsets are taken once a (row, tile), not once a pair.
struct JobNorms {
  const float* home;
  const float* shared;
  int per;

  __device__ __forceinline__ float operator[](int i) const {
    return i < per ? home[i] : shared[i];
  }
};

__device__ __forceinline__ JobNorms job_norms(const float* norms, int n_home,
                                              int per, int jps, int n_shared,
                                              long long home_total, int job) {
  return JobNorms{norms + (long long)(job % n_home) * per,
                  norms + home_total + (long long)(job / jps) * n_shared - per,
                  per};
}

// k(x_i, z_c) from the dot product `acc` of tile column c, with the
// job's γ and coef0 and Z's norms (zn, read for rbf).
__device__ __forceinline__ float transform(const Transform& f, float gamma,
                                           float coef0, float xn,
                                           const JobNorms& zn, int zc,
                                           float acc) {
  if (f.kind == kPoly) {
    const float base = __fadd_rn(__fmul_rn(gamma, acc), coef0);
    float out = 1.f;
    for (int e = 0; e < f.degree; ++e) out = __fmul_rn(out, base);
    return out;
  }
  if (f.kind == kRbf) {
    const float sq = __fsub_rn(__fadd_rn(xn, zn[zc]), __fmul_rn(2.f, acc));
    return expf(__fmul_rn(-gamma, fmaxf(sq, 0.f)));
  }
  return acc;
}

__device__ __forceinline__ float x_norm(const XRows& x, const Transform& f,
                                        int job, int i) {
  if (f.kind != kRbf) return 0.f;
  return job_norms(f.xnorm, x.n_home, x.per, x.jps, x.n_shared, x.home_total,
                   job)[i];
}

__device__ __forceinline__ JobNorms z_norms(const ZView& z,
                                            const Transform& f, int job) {
  return job_norms(f.znorm, z.n_home, z.per, z.jps, z.n_shared, z.home_total,
                   job);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
sparse_gram_kernel(XRows x, int cap, int d, ZView z, Transform f,
                   float* __restrict__ K) {
  extern __shared__ float seg[];
  const int job = blockIdx.z;
  const int tile = blockIdx.y;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= x.n) return;
  // the job's γ and coef0, loaded while the row accumulates
  const float gamma = f.gamma[job], coef0 = f.coef0[job];
  float* acc = seg + (threadIdx.x / 32) * warp_floats(z.tile);
  const int c0 = tile * z.tile;
  const int width = min(z.tile, z.n - c0);
  accumulate<T>(x, cap, d, z, job, tile, i, acc, width);
  __syncwarp();
  const float xn = x_norm(x, f, job, i);
  const JobNorms zn = z_norms(z, f, job);
  float* Krow = K + ((size_t)job * x.n + i) * z.n + c0;
  for (int c = lane; c < width; c += 32)
    Krow[c] = transform(f, gamma, coef0, xn, zn, c0 + c, acc[c]);
}

// X and Z are one job each. live[h·tiles + T] is 0 where hypothesis
// h's coefficients of tile T are all 0: its partial is 0, which is
// what those products add (k is finite), and a tile that no hypothesis
// reads is not computed.
template <typename T, typename TC>
__global__ void __launch_bounds__(32 * kWarps)
sparse_scores_kernel(XRows x, int cap, int d, ZView z, Transform f,
                     const TC* __restrict__ coef,
                     const unsigned char* __restrict__ live, int hyps,
                     float* __restrict__ partial) {
  extern __shared__ float seg[];
  const int tile = blockIdx.y;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= x.n) return;
  float* out = partial + (size_t)i * hyps * z.tiles + tile;
  bool any = false;
  for (int h = 0; h < hyps; ++h) any |= live[h * z.tiles + tile] != 0;
  if (!any) {
    for (int h = lane; h < hyps; h += 32) out[h * z.tiles] = 0.f;
    return;
  }
  const float gamma = f.gamma[0], coef0 = f.coef0[0];
  float* acc = seg + (threadIdx.x / 32) * warp_floats(z.tile);
  const int c0 = tile * z.tile;
  const int width = min(z.tile, z.n - c0);
  accumulate<T>(x, cap, d, z, 0, tile, i, acc, width);
  __syncwarp();
  const float xn = x_norm(x, f, 0, i);
  const JobNorms zn = z_norms(z, f, 0);
  for (int c = lane; c < width; c += 32)
    acc[c] = rt<TC>(transform(f, gamma, coef0, xn, zn, c0 + c, acc[c]));
  __syncwarp();
  for (int h = 0; h < hyps; ++h) {
    float s = 0.f;
    if (live[h * z.tiles + tile]) {
      const TC* ch = coef + (size_t)h * z.n + c0;
      for (int c = lane; c < width; c += 32)
        s = fmaf(acc[c], to_float(ch[c]), s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
    }
    if (lane == 0) out[h * z.tiles] = s;
  }
}

// out[i, h] = rt(rt(Σ_T partial[i, h, T]) + b_h), tiles in order.
template <typename TC>
__global__ void combine_kernel(const float* __restrict__ partial,
                               long long outputs, int tiles,
                               const TC* __restrict__ b, int hyps,
                               TC* __restrict__ out) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= outputs) return;
  const float* p = partial + o * tiles;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s = __fadd_rn(s, p[t]);
  out[o] = from_float<TC>(
      rt<TC>(__fadd_rn(rt<TC>(s), to_float(b[o % hyps]))));
}

template <typename T>
cudaError_t norms(const void* v, long long rows, int cap, float* out,
                  cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  const int threads = 256;
  slot_sq_norms_kernel<T><<<(unsigned)((rows + threads - 1) / threads),
                            threads, 0, stream>>>(static_cast<const T*>(v),
                                                  rows, cap, out);
  return cudaGetLastError();
}

struct ZSlots {   // Z's slot values, read only for the rbf norms
  const void* hv;
  long long home_total;
  const void* sv;
  long long shared;
};

template <typename T>
cudaError_t prepare(const XRows& x, long long x_shared, int cap,
                    const ZSlots& zs, const Transform& f,
                    cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (f.kind != kRbf) return err;
  float* xn = const_cast<float*>(f.xnorm);
  float* zn = const_cast<float*>(f.znorm);
  if ((err = norms<T>(x.hv, x.home_total, cap, xn, stream))) return err;
  if ((err = norms<T>(x.sv, x_shared, cap, xn + x.home_total, stream)))
    return err;
  if ((err = norms<T>(zs.hv, zs.home_total, cap, zn, stream))) return err;
  return norms<T>(zs.sv, zs.shared, cap, zn + zs.home_total, stream);
}

size_t seg_bytes(int tile) {
  return (size_t)kWarps * warp_floats(tile) * sizeof(float);
}

template <typename T>
cudaError_t launch_gram(const XRows& x, long long x_shared, int cap, int d,
                        int jobs, const ZView& z, const ZSlots& zs,
                        const Transform& f, float* K,
                        cudaStream_t stream) {
  cudaError_t err = prepare<T>(x, x_shared, cap, zs, f, stream);
  if (err) return err;
  auto kernel = sparse_gram_kernel<T>;
  const size_t smem = seg_bytes(z.tile);
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  const dim3 grid((x.n + kWarps - 1) / kWarps, z.tiles, jobs);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(x, cap, d, z, f, K);
  return cudaGetLastError();
}

template <typename T, typename TC>
cudaError_t launch_scores(const XRows& x, long long x_shared, int cap, int d,
                          const ZView& z, const ZSlots& zs,
                          const Transform& f, const void* coef,
                          const unsigned char* live, const void* b, int hyps,
                          float* partial, void* out, cudaStream_t stream) {
  cudaError_t err = prepare<T>(x, x_shared, cap, zs, f, stream);
  if (err) return err;
  auto kernel = sparse_scores_kernel<T, TC>;
  const size_t smem = seg_bytes(z.tile);
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  const dim3 grid((x.n + kWarps - 1) / kWarps, z.tiles);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      x, cap, d, z, f, static_cast<const TC*>(coef), live, hyps, partial);
  if ((err = cudaGetLastError())) return err;
  const long long outputs = (long long)x.n * hyps;
  const int threads = 256;
  combine_kernel<TC><<<(unsigned)((outputs + threads - 1) / threads), threads,
                       0, stream>>>(partial, outputs, z.tiles,
                                    static_cast<const TC*>(b), hyps,
                                    static_cast<TC*>(out));
  return cudaGetLastError();
}

}  // namespace

// Z rows a tile at most (the wrapper's tile must not exceed it).
extern "C" int sparse_gram_max_tile() { return kMaxTile; }

// X rows of job l: row i of home block l % x_n_home (x_per rows a
// block) for i < x_per, else row i − x_per of shared block l / x_jps
// (x_shared rows a block); each row is `cap` slots of int32 column id
// and value (bf16 if is_bf16 else f32). x_shared_total is the rows of
// all shared blocks. Z comes as its CSC view by (job, tile, column):
// for Z job l (bounds at l·off_job_stride), tile T (z_tile rows) and
// column c, with k = (l·z_tiles + T)·d + c, the entries [start[k],
// end[k]) of ent, each (Z row in 0..z_n, float32 bits of its value).
// Z's slot values (zh_val, zs_val, laid out like X's) are read only
// for the rbf norms. xnorm and znorm are scratch. kind: 0 linear, 1
// poly, 2 rbf; gamma and coef0 (jobs,) f32, each job's own (the scores
// route reads element 0).
#define SPARSE_ARGS                                                          \
  const int *xh_idx, const void *xh_val, int x_n_home, int x_per,            \
      long long x_home_total, const int *xs_idx, const void *xs_val,         \
      int x_shared, int x_jps, long long x_shared_total, int cap, int d,     \
      int z_n, int z_tile, const int *start, const int *end,                 \
      long long off_job_stride, const int2 *ent, const void *zh_val,         \
      int z_n_home, int z_per, long long z_home_total, const void *zs_val,   \
      int z_shared, int z_jps, long long z_shared_total, int is_bf16,        \
      int kind, const float *gamma, const float *coef0, int degree,          \
      float *xnorm, float *znorm

#define SPARSE_SETUP                                                         \
  const XRows x{xh_idx, xh_val,   x_n_home, x_per,            xs_idx,       \
                xs_val, x_shared, x_jps,    x_per + x_shared, x_home_total}; \
  const int z_tiles = z_tile > 0 ? (z_n + z_tile - 1) / z_tile : 0;          \
  const ZView z{z_n,  z_tile,   z_tiles, start,    end,   off_job_stride,    \
                ent,  z_n_home, z_per,   z_shared, z_jps, z_home_total};     \
  const ZSlots zs{zh_val, z_home_total, zs_val, z_shared_total};             \
  const Transform f{kind, gamma, coef0, degree, xnorm, znorm};               \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
  if (z_tile < 1 || z_tile > kMaxTile || x_n_home < 1 || z_n_home < 1 ||     \
      x_jps < 1 || z_jps < 1)                                                \
    return cudaErrorInvalidValue;

// The Gram route: K (jobs, nx, z_n) f32. Returns a cudaError_t (0 = ok).
extern "C" int sparse_gram(SPARSE_ARGS, int jobs, float* K, void* stream) {
  if (jobs <= 0 || x_per + x_shared <= 0 || z_n <= 0) return cudaSuccess;
  SPARSE_SETUP
  if (is_bf16)
    return launch_gram<__nv_bfloat16>(x, x_shared_total, cap, d, jobs, z, zs,
                                      f, K, s);
  return launch_gram<float>(x, x_shared_total, cap, d, jobs, z, zs, f, K, s);
}

// The scores route: X and Z one job each; coef (hyps, z_n) and b
// (hyps,) bf16 if coef_bf16 else f32; live (hyps, tiles) bytes, 0
// where a hypothesis's coefficients of a tile are all 0; partial (nx,
// hyps, tiles) f32 scratch; out (nx, hyps) in coef's dtype. Returns a
// cudaError_t.
extern "C" int sparse_gram_scores(SPARSE_ARGS, const void* coef,
                                  const unsigned char* live, const void* b,
                                  int coef_bf16, int hyps, float* partial,
                                  void* out, void* stream) {
  if (hyps <= 0 || x_per + x_shared <= 0) return cudaSuccess;
  SPARSE_SETUP
  if (z_n <= 0) return cudaErrorInvalidValue;
  if (is_bf16)
    return coef_bf16
        ? launch_scores<__nv_bfloat16, __nv_bfloat16>(
              x, x_shared_total, cap, d, z, zs, f, coef, live, b, hyps,
              partial, out, s)
        : launch_scores<__nv_bfloat16, float>(x, x_shared_total, cap, d, z,
                                              zs, f, coef, live, b, hyps,
                                              partial, out, s);
  return coef_bf16
      ? launch_scores<float, __nv_bfloat16>(x, x_shared_total, cap, d, z,
                                            zs, f, coef, live, b, hyps,
                                            partial, out, s)
      : launch_scores<float, float>(x, x_shared_total, cap, d, z, zs, f,
                                    coef, live, b, hyps, partial, out, s);
}

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
//     w[id_s] = w[id_s] + (Δ y_i) v_s;  b += Δ y_i;
//     viol = max(viol, |pg_i| m_i)
// with Q_ii = Σ_s v_s² + 1 (1 on masked rows), Σ_s v_s² rounded to the
// values' type as the reference rounds it (bf16 values give a bf16
// Σ v², svm.py:165). Contracts of the rows (repro_torch/sparse.py):
// padding slots are (index 0, value 0.0), dead SV slots keep their ids
// with value 0, and the ids of a row's live slots are distinct.
// Value-0 slots are skipped in the gather and the write, and a row
// whose Δ is 0 writes nothing; both skips are exact (the reference adds
// zeros), and they keep a padding slot from writing a stale w[0] over a
// real column 0 of the same row. A NaN Δ writes every slot, value 0
// included, as the reference's NaN · 0 does (every such write is NaN, so
// the order of a padding slot's and a live slot's writes is moot), and
// NaN passes through the clip, the projected gradient and the violation
// as through jnp.clip / jnp.minimum / jnp.maximum: a job that meets a
// NaN stops after that epoch, as the reference's.
//
// What bounds it on an H100: the row recurrence, not bytes. The rows'
// slots read once an epoch are 126 MB at 8 jobs × 10240 rows × 256
// slots × 6 bytes (bf16), 0.038 ms at 3.35 TB/s; but each row needs the
// w that the rows before it wrote, so a job is a chain of n dependent
// steps and the latency of one step sets the time. The design takes
// every latency it can off that chain:
//
// Two kernels. cds_prep_kernel (a warp a row, all rows of all jobs at
// once) lays each job's rows out as blocks of 16-byte slots (id, value
// as f32, table entry, 0) and (y, m, Q, 0), computes Q_ii, zeroes α and
// builds the look-ahead table (below). cds_solve_kernel runs one CTA a
// job: W ≤ 8 consumer warps, thread t owning the slots t, t + 32W (two
// at most: nnz_cap ≤ 512), and one producer warp.
//
// 1. Rows staged ahead: one thread of the producer warp has the bulk-copy
//    engine (1-D TMA, an mbarrier per ring slot) copy step g + D's row
//    block into a ring of kStages blocks in shared memory, D = k +
//    kStageAhead steps ahead, and waits on step g + k's mbarrier before
//    the step's barrier, so HBM's latency is off the chain and off the
//    consumers' own copy groups.
// 2. Gathers issued ahead, corrected exactly: after step g's barrier each
//    consumer thread issues the gather of w at its slots for step g + k
//    (a 16-byte cp.async through L2 only, the quarter of the column's
//    32-byte sector that holds this job's w, so L1 allocates nothing;
//    thread 0 also gathers α), k = min(kAhead, n − 1),
//    at least 1, and before step g + k's reduction waits for it. The
//    ordering argument: every store of w by a step ≤ g − 1 is made before
//    its thread reaches step g's barrier, and the gather for step g + k is
//    issued after it, so it reads the current w at every column that only
//    rows of steps ≤ g − 1 wrote; the steps g .. g + k − 1 (the window)
//    store after the gather may have read. The table holds, for each
//    live slot of each row, the nearest earlier step in the window whose
//    row holds the same live column, and that row's slot (δ ≤ k steps
//    back; 0: none). Each step publishes, before its barrier, the value
//    each slot read (x, after its own correction) beside the slot's value
//    v; every thread keeps the last k steps' Δy (coef, the same in every
//    thread). A slot with a table entry (δ, s') takes x + coef·v of step
//    g − δ's slot s' (rounded as the store is) in place of the value it
//    gathered: that is what step g − δ left in w (x + 0·v = x when Δ =
//    0), and no step between touched the column (δ is the nearest). In
//    the first epoch an entry before step 0 is ignored. So every step
//    reads exactly the w that the sequential solve reads, and writes what
//    it writes. Thread 0 stores α of a row at its step and gathers it for
//    the row's next step after that store (k ≤ n − 1, or n = 1).
// 3. One barrier a row: a warp reduces its threads' products by xor
//    shuffles, its lane 0 stores the partial (slots alternate by the
//    step's parity), one __syncthreads, and every thread adds the W
//    partials in warp order and computes the same α update, Δ and b, so
//    nothing is broadcast. The loop is pipelined by one step: the next
//    step's reads, corrections and partial come right after the update,
//    and the scattered stores of w and gathers for step g + k only after
//    them. What is left of a step (~0.6 µs at full width, PERF.md §6) is
//    the instructions of the chain in 9 warps, not its memory accesses:
//    a step with no gather and no store takes nearly as long.
//
// The table is periodic in the step (rows repeat every epoch), so the
// prep kernel builds it once a launch; its cost is in the launch's
// time. Sums: a thread adds its slots in order, a warp's lanes pair up
// by xor 16, 8, 4, 2, 1, the warps add in order from 0; every product,
// sum, the division and the update are rounded as written (no fma), so
// svm_step.emulate_sparse_lookahead repeats the arithmetic bit for bit.
// Reruns are bit-identical.
//
// A launch may hold the jobs of a sweep, as in cd_solve.cu: job l reads
// home block l % n_home and shared block l / jobs_per_shared, and its
// own C, tol and epoch cutoff (a job with cutoff 0 runs no epoch: α, w
// and b stay 0). The prep kernel lays out each job's own rows, so the
// solve and the look-ahead table are per job as before.
//
// w is the job's column of a (d, ldw) array (ldw = L rounded up to 8),
// so that the eq. 7 kernel (hinge_scores.cu, sparse route) reads a
// column id's 8 hypotheses as one 32-byte sector without a transpose.
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

constexpr int kAhead = 2;                      // look-ahead depth, at most
constexpr int kRing = kAhead + 1;              // gathers and reads kept
constexpr int kRingPad = (kRing + 1) & ~1;     // α's ring, 8-byte padded
constexpr int kStageAhead = 6;                 // D − k: the producer's slack
constexpr int kStages = kAhead + kStageAhead + 2;   // staged row blocks
constexpr int kMaxWarps = 8;                   // consumer warps
constexpr int kMaxSpt = 2;                     // slots a consumer thread
constexpr int kMaxCap = kMaxSpt * kMaxWarps * 32;
constexpr int kPartStride = kMaxWarps < 4 ? 4 : kMaxWarps;  // partials a step
constexpr int kPrepWarps = 8;                  // rows at once a prep CTA
constexpr int kPrepCtas = 1024;                // prep CTAs a job, at most
constexpr int kSlotBits = 11;                  // table entry: δ << 11 | slot
constexpr unsigned kFull = 0xffffffffu;

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
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// A row block: cap slots of 16 bytes (id, value as f32 bits, table
// entry, 0), then (y, m, Q, 0).
__host__ __device__ __forceinline__ int block_bytes(int cap) {
  return cap * 16 + 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared through L2 only (not allocated in L1), or 16
// zero bytes (src not read) when !live.
__device__ __forceinline__ void cp16z(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// 4 bytes global → shared, or 4 zero bytes (src not read) when !live.
__device__ __forceinline__ void cp4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The thread's copies of all but the newest n groups landed (n < 8).
__device__ __forceinline__ void cp_wait_newest(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    default: cp_wait<7>(); break;
  }
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

constexpr unsigned kSpinLimit = 1u << 28;      // a wait that never ends traps

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (unsigned spins = 0; !mbar_try(bar, parity); ++spins)
    if (spins == kSpinLimit) __trap();
}

// `bytes` from global to shared by the bulk-copy engine (1-D TMA),
// completing on `bar`, which this arrival tells to expect them. The
// slot's earlier readers passed a __syncthreads before the copy is
// issued (as a TMA pipeline's consumer release precedes the producer's
// next copy).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%2], %3;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %3, [%2];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bar), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ int ring_next(int i, int size) {
  return i + 1 == size ? 0 : i + 1;
}

// --- prep: row blocks, Q_ii, α = 0 and the look-ahead table ------------
//
// A warp per (job, row i), kPrepWarps warps a CTA, rows in a grid-stride
// loop. The warp enters row i's live columns into a hash in its shared
// memory (column → slot; a row's live columns are distinct), then looks
// up the live columns of rows i − 1, ..., i − k in turn (mod n: the
// window of the first rows wraps into the end of the epoch before); a
// slot of row i found in row i − δ takes (δ, that slot) unless a nearer
// row gave it one. The hash has ≥ 2 · nnz_cap entries (load ≤ 1/2).
__device__ __forceinline__ unsigned hash_slot(int id, int log2h) {
  return ((unsigned)id * 2654435761u) >> (32 - log2h);
}

// At most kSpt = 8 slots a lane (nnz_cap ≤ 256) the prep keeps to 80
// registers a thread, so that 3 CTAs share an SM.
template <typename T, int kSpt>
__global__ void __launch_bounds__(kPrepWarps * 32, kSpt <= 8 ? 3 : 1)
cds_prep_kernel(const int* __restrict__ xh_idx, const T* __restrict__ xh_val,
                const int* __restrict__ xs_idx, const T* __restrict__ xs_val,
                const float* __restrict__ y, const float* __restrict__ m,
                int per, int n_shared, int n_home, int jps, int cap, int k,
                int log2h, uint8_t* __restrict__ blocks,
                float* __restrict__ alpha) {
  extern __shared__ int hash[];
  const int H = 1 << log2h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* keys = hash + (2 * H + cap) * warp;
  int* slot_of = keys + H;                 // the row's slot of a key
  int* entry = slot_of + H;                // the table entry of a slot
  const int job = blockIdx.y;
  const int n = per + n_shared;
  const int bb = block_bytes(cap);
  const size_t home0 = (size_t)(job % n_home) * per;
  const size_t shared0 = (size_t)(job / jps) * n_shared;
  // The lane's slots lane + 32j of row `row`, loaded all at once.
  auto load = [&](int row, int* id, float* v) {
    const size_t r = row < per ? home0 + row : shared0 + (row - per);
    const int* ri = (row < per ? xh_idx : xs_idx) + r * cap;
    const T* rv = (row < per ? xh_val : xs_val) + r * cap;
#pragma unroll
    for (int j = 0; j < kSpt; ++j) {
      const int s = lane + 32 * j;
      id[j] = s < cap ? ri[s] : 0;
      v[j] = s < cap ? to_float(rv[s]) : 0.f;
    }
  };
  auto back_row = [&](int i, int d) {
    const int r = (i - d) % n;
    return r < 0 ? r + n : r;
  };
  for (int i = blockIdx.x * kPrepWarps + warp; i < n;
       i += gridDim.x * kPrepWarps) {
    int id[kSpt], wid[kSpt], nid[kSpt];
    float v[kSpt], wv[kSpt], nv[kSpt];
    load(i, id, v);
    const float yi = y[(size_t)job * n + i];
    const float mi = m[(size_t)job * n + i];
    load(back_row(i, 1), wid, wv);
    for (int h = lane; h < H; h += 32) keys[h] = -1;
    for (int s = lane; s < cap; s += 32) entry[s] = 0;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kSpt; ++j) {
      if (v[j] == 0.f) continue;
      unsigned h = hash_slot(id[j], log2h);
      while (atomicCAS(&keys[h], -1, id[j]) != -1) h = (h + 1) & (H - 1);
      slot_of[h] = lane + 32 * j;
    }
    __syncwarp();
    for (int d = 1; d <= k; ++d) {
      if (d < k) load(back_row(i, d + 1), nid, nv);
#pragma unroll
      for (int j = 0; j < kSpt; ++j) {
        if (wv[j] == 0.f) continue;
        unsigned h = hash_slot(wid[j], log2h);
        int key;
        while ((key = keys[h]) != -1 && key != wid[j]) h = (h + 1) & (H - 1);
        if (key == wid[j] && entry[slot_of[h]] == 0)
          entry[slot_of[h]] = (d << kSlotBits) | (lane + 32 * j);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kSpt; ++j) {
        wid[j] = nid[j];
        wv[j] = nv[j];
      }
    }
    int4* bslot = reinterpret_cast<int4*>(blocks + ((size_t)job * n + i) * bb);
    // Σ v² in the order of ref.sparse_sq_norms: lane order, then xor.
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kSpt; ++j) {
      const int s = lane + 32 * j;
      if (s >= cap) break;
      bslot[s] = make_int4(id[j], __float_as_int(v[j]), entry[s], 0);
      sq = __fadd_rn(sq, __fmul_rn(v[j], v[j]));
    }
    sq = round_as<T>(warp_sum(sq));
    if (lane == 0) {
      bslot[cap] = make_int4(__float_as_int(yi), __float_as_int(mi),
                             __float_as_int(mi > 0.f ? __fadd_rn(sq, 1.f)
                                                      : 1.f), 0);
      alpha[(size_t)job * n + i] = 0.f;
    }
    __syncwarp();
  }
}

// --- the solve: one CTA a job --------------------------------------------
// kFull: k = kAhead (every job of more than kAhead rows), so the waits
// and the look-ahead are constants; else k comes at run time.
// A minimum of one CTA an SM lets ptxas give the step the registers it
// needs; without it ptxas held the kernel to 40 and spilled.
template <int kSpt, bool kFull>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 1)
cds_solve_kernel(const uint8_t* __restrict__ blocks, int n, int cap,
                 int warps, int k_run, const float* __restrict__ Cs,
                 const float* __restrict__ tols,
                 const int* __restrict__ cutoffs, float* __restrict__ alpha, float* w_all, int ldw,
                 float* __restrict__ b_out, int* __restrict__ epochs_out,
                 float* __restrict__ viol_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int bb = block_bytes(cap);
  const int T = warps * 32;                                 // consumers
  uint8_t* stage = smem;                                    // kStages blocks
  // a gathered slot is the 16-byte quarter of its column's 32-byte
  // sector that holds this job's w (jobs 4q .. 4q + 3)
  float4* gathered = reinterpret_cast<float4*>(smem + kStages * bb);
  float2* reads = reinterpret_cast<float2*>(gathered + kRing * kSpt * T);
  float* partial = reinterpret_cast<float*>(reads + kRing * kSpt * T);
  float* agath = partial + 2 * kPartStride;                 // kRing
  uint64_t* full = reinterpret_cast<uint64_t*>(agath + kRingPad);  // kStages

  const int job = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // C is on the step's chain and stays in a register; tol and the
  // cutoff are read once an epoch, from shared memory
  __shared__ float tol;
  __shared__ int max_epochs;
  const float C = Cs[job];
  if (tid == 0) {
    tol = tols[job];
    max_epochs = cutoffs[job];
  }
  __syncthreads();
  const bool producer = warp == warps;
  const bool copier = tid == T;            // the producer's lane that copies
  const uint8_t* jb = blocks + (size_t)job * n * bb;
  float* aj = alpha + (size_t)job * n;
  float* w = w_all + job;
  const float* wq = w_all + (job & ~3);
  const int k = kFull ? kAhead : k_run;
  const int D = k + kStageAhead;

  auto stage_row = [&](int row, int slot) {      // the copier thread
    bulk_copy(stage + slot * bb, jb + (size_t)row * bb, bb,
              smem_addr(full + slot));
  };
  auto wait_row = [&](unsigned step, int slot) {  // the copier thread
    mbar_wait(smem_addr(full + slot), (step / kStages) & 1u);
  };
  auto gather_row = [&](int row, int slot, int ring) {   // a consumer
    const int4* blk = reinterpret_cast<const int4*>(stage + slot * bb);
#pragma unroll
    for (int j = 0; j < kSpt; ++j) {
      const int s = tid + T * j;
      if (s < cap) {
        const int4 e = blk[s];
        cp16z(gathered + ring * kSpt * T + s, wq + (size_t)e.x * ldw,
              __int_as_float(e.y) != 0.f);
      }
    }
    if (tid == 0) cp4(agath + ring, aj + row, true);
  };

  float coef_back[kAhead + 1];        // Δy of steps g − 1 .. g − k
#pragma unroll
  for (int d = 0; d <= kAhead; ++d) coef_back[d] = 0.f;
  // A consumer's slots of the step whose reduction is under way.
  float x[kSpt], v[kSpt];
  int id[kSpt];
  // The part of step h before its barrier: the corrected reads of the
  // thread's slots, published, and the warp's partial of w·x. It runs
  // after the update of the step before, not beside it: with k = 2 its
  // gathers were issued just before that update's barrier, and the
  // update's latency hides theirs (hoisting the wait measured slower).
  auto pre = [&](unsigned h, int st, int rg, int newer) {
    if (kFull && newer == kAhead - 2)   // the loop's wait, a constant
      cp_wait<kAhead < 2 ? 0 : kAhead - 2>();
    else
      cp_wait_newest(newer);          // step h's gathers landed
    const int4* blk = reinterpret_cast<const int4*>(stage + st * bb);
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < kSpt; ++j) {
      const int s = tid + T * j;
      const int4 e = s < cap ? blk[s] : make_int4(0, 0, 0, 0);
      id[j] = e.x;
      v[j] = __int_as_float(e.y);
      x[j] = s < cap
                 ? reinterpret_cast<const float*>(
                       gathered + rg * kSpt * T + s)[job & 3]
                 : 0.f;
      // the window wrote this column: take what its step left there
      // (read unconditionally, selected without a branch)
      const unsigned back = (unsigned)e.z >> kSlotBits;
      const int src = e.z & ((1 << kSlotBits) - 1);
      int rs = rg - (int)back;
      rs += rs < 0 ? kRing : 0;
      const float2 r = reads[rs * kSpt * T + src];
      float c = coef_back[1];
#pragma unroll
      for (int d = 2; d <= kAhead; ++d)
        c = back == (unsigned)d ? coef_back[d] : c;
      const float fixed = __fadd_rn(r.x, __fmul_rn(c, r.y));
      x[j] = back != 0 && back <= h ? fixed : x[j];
      if (s < cap) reads[rg * kSpt * T + s] = make_float2(x[j], v[j]);
      p = __fadd_rn(p, __fmul_rn(x[j], v[j]));
    }
    p = warp_sum(p);
    if (lane == 0) partial[(h & 1) * kPartStride + warp] = p;
  };

  float b = 0.f;
  float viol = INFINITY;
  int t = 0;
  unsigned g = 0;                 // the step: epoch · n + row
  int row_s = 0, row_g = 0;       // rows of steps g + D and g + k
  int st_c = 0, st_g = 0, st_s = 0;   // stage slots of steps g, g + k, g + D
  int rg_c = 0, rg_g = 0;             // ring slots of steps g, g + k
  const bool run = n > 0 && max_epochs > 0;
  if (run) {
    if (copier) {
      for (int q = 0; q < kStages; ++q) mbar_init(smem_addr(full + q), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int d = 0; d < D; ++d) stage_row(d % n, d % kStages);
      for (int d = 0; d < D; ++d) wait_row(d, d % kStages);
    }
    __syncthreads();
    if (!producer) {
      for (int d = 0; d < k; ++d) {
        gather_row(d % n, d % kStages, d % kRing);
        cp_commit();
      }
      pre(0, 0, 0, k - 1);
    }
    row_s = D % n;
    row_g = k % n;
    st_g = k % kStages;
    st_s = D % kStages;
    rg_g = k % kRing;
  }
  // Software-pipelined by one step: after step g's barrier every thread
  // finishes step g's update; a consumer then does step g + 1's part
  // before its barrier, and only after it the stores of step g and the
  // gathers for step g + k, off the chain (k = 1, n ≤ 2: the gather for
  // step g + 1 goes first, as that step needs it).
  while (t < max_epochs && (t == 0 || viol > tol)) {
    float viol_ep = 0.f;
    for (int i = 0; i < n; ++i, ++g) {
      __syncthreads();
      const int4 info =
          reinterpret_cast<const int4*>(stage + st_c * bb)[cap];
      float part[kPartStride];
#pragma unroll
      for (int q = 0; q < kPartStride; q += 4) {
        const float4 p4 = reinterpret_cast<const float4*>(
            partial + (g & 1) * kPartStride)[q / 4];
        part[q] = p4.x;
        part[q + 1] = p4.y;
        part[q + 2] = p4.z;
        part[q + 3] = p4.w;
      }
      float wx = 0.f;
#pragma unroll
      for (int q = 0; q < kPartStride; ++q)
        if (q < warps) wx = __fadd_rn(wx, part[q]);
      const float yi = __int_as_float(info.x), mi = __int_as_float(info.y),
                  qi = __int_as_float(info.z);
      const float a = agath[rg_c];
      const float gr = __fsub_rn(__fmul_rn(yi, __fadd_rn(wx, b)), 1.f);
      const float pg = a <= 0.f ? min0(gr)
                                : (a >= C ? max0(gr) : gr);
      const float a_new =
          clip0(__fsub_rn(a, __fdiv_rn(gr, qi)), C);
      const float delta = __fmul_rn(__fsub_rn(a_new, a), mi);
      const float coef = __fmul_rn(delta, yi);
      b = __fadd_rn(b, coef);
      viol_ep = nan_max(viol_ep, __fmul_rn(fabsf(pg), mi));
#pragma unroll
      for (int d = kAhead; d > 1; --d) coef_back[d] = coef_back[d - 1];
      coef_back[1] = coef;
      const int st_n = ring_next(st_c, kStages);
      const int rg_n = ring_next(rg_c, kRing);
      if (!producer) {
        if (tid == 0) aj[i] = __fadd_rn(a, delta);
        float xs[kSpt], vs[kSpt];
        int ids[kSpt];
#pragma unroll
        for (int j = 0; j < kSpt; ++j) {
          xs[j] = x[j];
          vs[j] = v[j];
          ids[j] = id[j];
        }
        if (k == 1) {
          gather_row(row_g, st_g, rg_g);
          cp_commit();
        }
        pre(g + 1, st_n, rg_n, k == 1 ? 0 : k - 2);
        if (delta != 0.f) {
#pragma unroll
          for (int j = 0; j < kSpt; ++j)
            if (tid + T * j < cap && (vs[j] != 0.f || coef != coef))
              w[(size_t)ids[j] * ldw] =
                  __fadd_rn(xs[j], __fmul_rn(coef, vs[j]));
        }
        if (k > 1) {
          gather_row(row_g, st_g, rg_g);
          cp_commit();
        }
      } else if (copier) {
        stage_row(row_s, st_s);                 // step g + D
        wait_row(g + 1 + k, ring_next(st_g, kStages));
      }
      row_s = ring_next(row_s, n);
      row_g = ring_next(row_g, n);
      st_c = st_n;
      st_s = ring_next(st_s, kStages);
      st_g = ring_next(st_g, kStages);
      rg_c = rg_n;
      rg_g = ring_next(rg_g, kRing);
    }
    viol = viol_ep;
    ++t;
  }
  cp_wait_all();
  if (run && copier)                    // the staged rows still in flight
    for (unsigned h = g + k + 1; h < g + D; ++h) wait_row(h, h % kStages);
  if (tid == 0) {
    b_out[job] = b;
    epochs_out[job] = t;
    viol_out[job] = viol;
  }
}

int ceil_log2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

template <typename T>
cudaError_t launch(const void* xh_idx, const void* xh_val, const void* xs_idx,
                   const void* xs_val, const float* y, const float* m, int L,
                   int per, int n_shared, int n_home, int jps, int cap,
                   const float* C, const float* tol, const int* cutoff,
                   uint8_t* blocks, float* alpha, float* w,
                   int ldw, float* b, int* epochs, float* viol,
                   cudaStream_t s) {
  const int n = per + n_shared;
  const int k = n > 2 ? (n - 1 < kAhead ? n - 1 : kAhead) : 1;
  cudaError_t err;
  if (n > 0) {
    const int pspt = (cap + 31) / 32;
    const int log2h = ceil_log2(2 * cap) > 5 ? ceil_log2(2 * cap) : 5;
    const int pbytes = kPrepWarps * (2 * (1 << log2h) + cap) * 4;
    const int ctas = (n + kPrepWarps - 1) / kPrepWarps;
    const dim3 grid(ctas < kPrepCtas ? ctas : kPrepCtas, L);
#define CDS_PREP(SPT)                                                        \
  do {                                                                       \
    auto prep = cds_prep_kernel<T, SPT>;                                     \
    if ((err = cudaFuncSetAttribute(                                         \
             prep, cudaFuncAttributeMaxDynamicSharedMemorySize, pbytes)) !=  \
        cudaSuccess)                                                         \
      return err;                                                            \
    prep<<<grid, kPrepWarps * 32, pbytes, s>>>(                              \
        static_cast<const int*>(xh_idx), static_cast<const T*>(xh_val),      \
        static_cast<const int*>(xs_idx), static_cast<const T*>(xs_val), y,   \
        m, per, n_shared, n_home, jps, cap, k, log2h, blocks, alpha);        \
  } while (0)
    if (pspt <= 1)
      CDS_PREP(1);
    else if (pspt <= 2)
      CDS_PREP(2);
    else if (pspt <= 4)
      CDS_PREP(4);
    else if (pspt <= 8)
      CDS_PREP(8);
    else
      CDS_PREP(16);
#undef CDS_PREP
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int warps = (cap + 31) / 32 < kMaxWarps ? (cap + 31) / 32 : kMaxWarps;
  const int threads = warps * 32;
  const int spt = (cap + threads - 1) / threads;
  const int smem = kStages * block_bytes(cap) + kRing * spt * threads * 24 +
                   (2 * kPartStride + kRingPad) * 4 + kStages * 8;
#define CDS_LAUNCH(SPT)                                                      \
  do {                                                                       \
    auto kern = k == kAhead ? cds_solve_kernel<SPT, true>                    \
                            : cds_solve_kernel<SPT, false>;                  \
    if ((err = cudaFuncSetAttribute(                                         \
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=   \
        cudaSuccess)                                                         \
      return err;                                                            \
    kern<<<L, threads + 32, smem, s>>>(blocks, n, cap, warps, k, C, tol,     \
                                       cutoff, alpha, w, ldw, b, epochs,      \
                                       viol);                                 \
  } while (0)
  if (spt <= 1)
    CDS_LAUNCH(1);
  else if (spt <= 2 || kMaxSpt <= 2)
    CDS_LAUNCH(kMaxSpt < 2 ? kMaxSpt : 2);
  else if (spt <= 4 || kMaxSpt <= 4)
    CDS_LAUNCH(kMaxSpt < 4 ? kMaxSpt : 4);
  else
    CDS_LAUNCH(kMaxSpt);
#undef CDS_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int cd_solve_sparse_max_cap() { return kMaxCap; }
extern "C" int cd_solve_sparse_ahead() { return kAhead; }
extern "C" int cd_solve_sparse_max_warps() { return kMaxWarps; }

// Bytes of one row block for nnz_cap cap: the scratch `blocks` holds
// L · (per + S) of them.
extern "C" int cd_solve_sparse_block_bytes(int cap) {
  return block_bytes(cap);
}

// xh: indices (n_home, per, cap) int32 and values (n_home, per, cap);
// xs: indices (L / jobs_per_shared, S, cap) int32 and values of that
// shape; values f32 (bf16 = 0) or bf16 (bf16 = 1). Job l reads home
// block l % n_home and shared block l / jobs_per_shared. y, m (L, per +
// S) f32; C, tol (L,) f32 and cutoff (L,) int32, each job's own.
// Scratch blocks: L · (per + S) ·
// cd_solve_sparse_block_bytes(cap) bytes, 16-byte aligned.
// Outputs alpha (L, n); w (d, ldw) f32, 16-byte aligned, ZEROED by the
// caller, job l's w in column l (ldw ≥ L, a multiple of 4); b (L,),
// epochs (L,) int32, viol (L,).
// Returns a cudaError_t (0 = ok).
extern "C" int cd_solve_sparse(const void* xh_idx, const void* xh_val,
                               const void* xs_idx, const void* xs_val,
                               int bf16, const float* y, const float* m,
                               int L, int per, int n_shared, int n_home,
                               int jobs_per_shared, int cap, const float* C,
                               const float* tol, const int* cutoff,
                               void* blocks, float* alpha, float* w, int ldw,
                               float* b, int* epochs, float* viol,
                               void* stream) {
  if (L < 1 || cap < 1 || cap > kMaxCap || per < 0 || n_shared < 0 ||
      n_home < 1 || jobs_per_shared < 1 || ldw < L || ldw % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(blocks) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15u) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* bl = static_cast<uint8_t*>(blocks);
  if (bf16)
    return launch<__nv_bfloat16>(xh_idx, xh_val, xs_idx, xs_val, y, m, L, per,
                                 n_shared, n_home, jobs_per_shared, cap, C,
                                 tol, cutoff, bl, alpha, w, ldw, b, epochs,
                                 viol, s);
  return launch<float>(xh_idx, xh_val, xs_idx, xs_val, y, m, L, per, n_shared,
                       n_home, jobs_per_shared, cap, C, tol, cutoff, bl,
                       alpha, w, ldw, b, epochs, viol, s);
}

// One-pass small-G GROUP BY for Hopper (sm_90a) — the TPC-H Q1 shape.
//
// Replaces the Pallas kernel group_aggregate_dense_pallas
// (tidb_tpu/ops/dense_pallas.py:223, pallas_call at :415). It computes the
// same function: for <= G (<= 32) groups, count(*) plus, per distinct
// (value, null) argument combo (<= 6), the exact int64 sum and the non-null
// count; groups come out in first-encounter order with group_rep = each
// group's first row. Group identity is the 62-bit primary hash hp (valid
// rows have bit 63 clear, so all-ones marks an empty slot); a row whose
// verify hash hv differs from its group's first row raises the overflow
// flag, as does a (G+1)-th distinct key.
//
// Not a block-by-block copy. The TPU kernel walks a sequential grid, so its
// insert order is the first-encounter order, and it splits int64 values into
// 12-bit limbs (Mosaic has no 64-bit vectors). Hopper has native int64 and
// its blocks run in no order, so:
//   1. discover:   each block builds a 64-slot open-addressing table in
//                  shared memory (atomicCAS on the key, atomicMin of the row
//                  index), then merges it into a 64-slot global table with
//                  one atomic per key per block. A full table is overflow.
//   2. order:      one block of 64 threads ranks the used slots by their
//                  minimum row: rank = gid, min row = group_rep. More than G
//                  used slots is overflow.
//   3. accumulate: each block loads the slot->gid map and each group's
//                  verify hash into shared memory, adds count(*), per-combo
//                  sum and non-null count into shared int64 accumulators
//                  (wrapping atomicAdd on unsigned long long), and flushes
//                  them to global memory with one atomic per accumulator.
// Every sum is order-independent, so the result is deterministic. The limb
// split, the bias, the |v| < 2^46 gate and the row-count bound of the TPU
// kernel are Mosaic artifacts and are gone.
//
// Bound on an H100 SXM: memory. One pass must read hp and hv (8 + 8 bytes),
// the row-valid byte, and per combo an int64 value and a null byte:
// N * (17 + 9 * NC) bytes. For Q1 at 2^22 rows (NC = 4) that is ~0.22 GB,
// ~66 us at 3.35 TB/s. This first version reads hp twice (discover and
// accumulate) and serialises shared-memory atomics on hot groups; a single
// fused pass with warp-level pre-aggregation is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 64;
constexpr int MAX_G = 32;
constexpr int MAX_C = 6;
constexpr int THREADS = 256;
constexpr unsigned long long EMPTY = 0xFFFFFFFFFFFFFFFFull;
constexpr long long NO_ROW = 0x7FFFFFFFFFFFFFFFll;

struct Combos {
  const long long* v[MAX_C];
  const unsigned char* nl[MAX_C];
};

__device__ __forceinline__ int home_slot(unsigned long long h) {
  // hp's low bit is always clear (MAX63 mask): take bits above it
  return (int)((h >> 8) & (SLOTS - 1));
}

// Find or claim the slot of key h (linear probing); -1 when the table is full.
__device__ int insert_key(unsigned long long* keys, unsigned long long h) {
  int s = home_slot(h);
  for (int p = 0; p < SLOTS; ++p) {
    unsigned long long cur = ((volatile unsigned long long*)keys)[s];
    if (cur == h) return s;
    if (cur == EMPTY) {
      unsigned long long prev = atomicCAS(&keys[s], EMPTY, h);
      if (prev == EMPTY || prev == h) return s;
    }
    s = (s + 1) & (SLOTS - 1);
  }
  return -1;
}

// Read-only lookup of key h; -1 when absent.
__device__ int find_key(const unsigned long long* keys, unsigned long long h) {
  int s = home_slot(h);
  for (int p = 0; p < SLOTS; ++p) {
    unsigned long long cur = keys[s];
    if (cur == h) return s;
    if (cur == EMPTY) return -1;
    s = (s + 1) & (SLOTS - 1);
  }
  return -1;
}

__global__ void discover_kernel(const long long* __restrict__ hp,
                                const unsigned char* __restrict__ valid,
                                long long n, unsigned long long* g_keys,
                                long long* g_minrow, int* flag) {
  __shared__ unsigned long long keys[SLOTS];
  __shared__ long long minrow[SLOTS];
  __shared__ int full;
  for (int i = threadIdx.x; i < SLOTS; i += blockDim.x) {
    keys[i] = EMPTY;
    minrow[i] = NO_ROW;
  }
  if (threadIdx.x == 0) full = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!valid[i]) continue;
    int s = insert_key(keys, (unsigned long long)hp[i]);
    if (s < 0) {
      full = 1;
      continue;
    }
    // rows arrive in increasing order per thread: the plain read skips
    // the atomic once the slot holds an earlier row
    if (i < ((volatile long long*)minrow)[s]) atomicMin(&minrow[s], i);
  }
  __syncthreads();
  if (threadIdx.x < SLOTS) {
    unsigned long long h = keys[threadIdx.x];
    if (h != EMPTY) {
      int s = insert_key(g_keys, h);
      if (s < 0)
        atomicOr(flag, 1);
      else
        atomicMin(&g_minrow[s], minrow[threadIdx.x]);
    }
  }
  if (threadIdx.x == 0 && full) atomicOr(flag, 1);
}

// One block of SLOTS threads.
__global__ void order_kernel(const unsigned long long* __restrict__ g_keys,
                             const long long* __restrict__ g_minrow, int G,
                             const long long* __restrict__ hv, int* slot_gid,
                             int* group_rep, long long* rep_hv, int* n_groups,
                             int* flag) {
  __shared__ long long mr[SLOTS];
  __shared__ int used[SLOTS];
  const int t = threadIdx.x;
  const bool u = g_keys[t] != EMPTY;
  mr[t] = u ? g_minrow[t] : NO_ROW;
  used[t] = u ? 1 : 0;
  __syncthreads();
  int rank = 0, nused = 0;
  for (int k = 0; k < SLOTS; ++k) {
    nused += used[k];
    if (used[k] && mr[k] < mr[t]) ++rank;  // min rows are distinct per key
  }
  int gid = -1;
  if (u && rank < G) {
    gid = rank;
    group_rep[rank] = (int)mr[t];
    rep_hv[rank] = hv[mr[t]];
  }
  slot_gid[t] = gid;
  if (t == 0) {
    *n_groups = nused < G ? nused : G;
    if (nused > G) atomicOr(flag, 1);
  }
}

template <int NC>
__global__ void accumulate_kernel(const long long* __restrict__ hp,
                                  const long long* __restrict__ hv,
                                  const unsigned char* __restrict__ valid,
                                  long long n, Combos cb, int G,
                                  const unsigned long long* __restrict__ g_keys,
                                  const int* __restrict__ slot_gid,
                                  const long long* __restrict__ rep_hv,
                                  unsigned long long* acc, int* flag) {
  constexpr int PER_G = 1 + 2 * NC;
  __shared__ unsigned long long s_keys[SLOTS];
  __shared__ int s_gid[SLOTS];
  __shared__ long long s_rhv[MAX_G];
  __shared__ unsigned long long s_acc[MAX_G * PER_G];
  __shared__ int bad;
  for (int i = threadIdx.x; i < SLOTS; i += blockDim.x) {
    s_keys[i] = g_keys[i];
    s_gid[i] = slot_gid[i];
  }
  for (int i = threadIdx.x; i < G; i += blockDim.x) s_rhv[i] = rep_hv[i];
  for (int i = threadIdx.x; i < G * PER_G; i += blockDim.x) s_acc[i] = 0ull;
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!valid[i]) continue;
    int s = find_key(s_keys, (unsigned long long)hp[i]);
    int gid = s < 0 ? -1 : s_gid[s];
    if (gid < 0) {  // key beyond capacity (overflow already counted)
      bad = 1;
      continue;
    }
    if (hv[i] != s_rhv[gid]) bad = 1;  // primary-hash collision
    unsigned long long* a = s_acc + gid * PER_G;
    atomicAdd(a, 1ull);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!cb.nl[c][i]) {
        atomicAdd(a + 1 + 2 * c, (unsigned long long)cb.v[c][i]);
        atomicAdd(a + 2 + 2 * c, 1ull);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < G * PER_G; j += blockDim.x) {
    if (s_acc[j]) atomicAdd(acc + j, s_acc[j]);
  }
  if (threadIdx.x == 0 && bad) atomicOr(flag, 1);
}

template <int NC>
void launch_accumulate(int blocks, cudaStream_t st, const long long* hp,
                       const long long* hv, const unsigned char* valid,
                       long long n, const Combos& cb, int G,
                       const unsigned long long* g_keys, const int* slot_gid,
                       const long long* rep_hv, unsigned long long* acc,
                       int* flag) {
  accumulate_kernel<NC><<<blocks, THREADS, 0, st>>>(hp, hv, valid, n, cb, G, g_keys,
                                                    slot_gid, rep_hv, acc, flag);
}

}  // namespace

// Launches the three phases on `stream`. Workspace and outputs are
// allocated and initialised by the caller:
//   g_keys int64[64] = -1, g_minrow int64[64] = INT64_MAX, slot_gid int32[64],
//   group_rep int32[G] = 0, rep_hv int64[G], n_groups int32[1],
//   acc int64[G * (1 + 2 * nc)] = 0, flag int32[1] = 0.
// Returns cudaGetLastError() (0 on success), or -1 for bad arguments.
extern "C" int dense_agg_launch(const void* hp, const void* hv, const void* valid,
                                long long n, const void* const* vals,
                                const void* const* nulls, int nc, int G,
                                void* g_keys, void* g_minrow, void* slot_gid,
                                void* group_rep, void* rep_hv, void* n_groups,
                                void* acc, void* flag, void* stream) {
  if (nc < 0 || nc > MAX_C || G < 1 || G > MAX_G || n < 0) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  Combos cb;
  for (int c = 0; c < MAX_C; ++c) {
    cb.v[c] = c < nc ? (const long long*)vals[c] : nullptr;
    cb.nl[c] = c < nc ? (const unsigned char*)nulls[c] : nullptr;
  }
  long long want = (n + THREADS - 1) / THREADS;
  int blocks = (int)(want < 1056 ? (want < 1 ? 1 : want) : 1056);  // 8 per SM
  const long long* hp_ = (const long long*)hp;
  const long long* hv_ = (const long long*)hv;
  const unsigned char* va = (const unsigned char*)valid;
  unsigned long long* keys = (unsigned long long*)g_keys;
  int* fl = (int*)flag;

  discover_kernel<<<blocks, THREADS, 0, st>>>(hp_, va, n, keys, (long long*)g_minrow, fl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  order_kernel<<<1, SLOTS, 0, st>>>(keys, (const long long*)g_minrow, G, hv_,
                                    (int*)slot_gid, (int*)group_rep,
                                    (long long*)rep_hv, (int*)n_groups, fl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int* sg = (const int*)slot_gid;
  const long long* rh = (const long long*)rep_hv;
  unsigned long long* ac = (unsigned long long*)acc;
  switch (nc) {
    case 0: launch_accumulate<0>(blocks, st, hp_, hv_, va, n, cb, G, keys, sg, rh, ac, fl); break;
    case 1: launch_accumulate<1>(blocks, st, hp_, hv_, va, n, cb, G, keys, sg, rh, ac, fl); break;
    case 2: launch_accumulate<2>(blocks, st, hp_, hv_, va, n, cb, G, keys, sg, rh, ac, fl); break;
    case 3: launch_accumulate<3>(blocks, st, hp_, hv_, va, n, cb, G, keys, sg, rh, ac, fl); break;
    case 4: launch_accumulate<4>(blocks, st, hp_, hv_, va, n, cb, G, keys, sg, rh, ac, fl); break;
    case 5: launch_accumulate<5>(blocks, st, hp_, hv_, va, n, cb, G, keys, sg, rh, ac, fl); break;
    default: launch_accumulate<6>(blocks, st, hp_, hv_, va, n, cb, G, keys, sg, rh, ac, fl); break;
  }
  return (int)cudaGetLastError();
}

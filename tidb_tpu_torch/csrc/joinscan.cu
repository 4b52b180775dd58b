// Post-sort passes of the packed join+group chain (TPC-H Q3) for Hopper
// (sm_90a).
//
// K2 postsort_segscan replaces the Pallas kernel of the same name
// (tidb_tpu/ops/joinscan.py:198, pallas_call at :231). Over the sorted
// packed keys spk (pk = key << 1 | side: hay rows even, probe rows odd,
// unusable rows pinned at >= 2^31 - 4) it computes, per key run (a maximal
// block of equal spk | 1), the contributing probe-row count, the matched
// flag, the exact int64 sum of each value lane (<= 2) and the non-null
// count of each nullable lane, and writes them at the run's LAST element
// when the run has a contributing row and a match (0 elsewhere). It also
// reports overflow (duplicate usable hay keys, or any bad bit) and the
// join-row total (every real probe row).
//
// Not a block-by-block copy. The TPU kernel walks a sequential grid with a
// carry in scalar memory, emits each run one element late (and shifts the
// outputs back by one), and sums 12/12/8-bit limbs of the bias-flipped
// value under a run-length cap, because Mosaic has no 64-bit vectors.
// Hopper's blocks run in no order and it adds int64 natively, so this is a
// reduce-then-scan segmented scan in three launches:
//   1. reduce: each block reduces its tile of TILE elements to one
//      segmented carry (a run start was seen; the open run's totals), and
//      ORs the overflow conditions and adds the join rows with one atomic
//      each;
//   2. scan:   one block turns the tile carries into exclusive carry-ins;
//   3. emit:   each block rescans its tile from its carry-in and writes
//      every output element: the run totals where the run ends (the next
//      element starts a new run, or it is element n - 1) and emits.
// The limbs, the bias and the run cap are gone: a run of any length stays
// here. Sums of int32 lanes in int64 are exact, so the result does not
// depend on the order of the additions.
//
// K3 membership_segscan replaces the Pallas kernel of the same name
// (tidb_tpu/ops/joinscan.py:344, pallas_call at :365). Inner rows (even pk)
// sort before outer rows (odd pk) of their key, so an outer real row is ok
// iff the element holding pk - 1 exists: one elementwise kernel with a
// binary search, no scan. Duplicate inner keys come from an adjacent-equal
// test, and the overflow flag is one atomicOr per block.
//
// Bound on an H100 SXM (3.35 TB/s): memory. K2 must read spk (4 B), each
// lane (4 B) and the bad byte, and write gv (1 B), cnt (8 B), key (4 B)
// and each sum (8 B): ~30 B a row with one lane, ~0.14 GB and ~42 us for
// Q3's 4.72M sorted rows at 2^22 lineitem rows. This version reads the
// inputs twice (reduce and emit) and stores with a per-thread stride of
// ITEMS elements; a single-pass decoupled look-back is later work. K3 reads
// ~5 B and writes 1 B a row: ~4 MB and ~1.2 us for Q3's 655K rows, so it
// is launch-bound.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int PIN = 0x7FFFFFFC;  // pk >= PIN: an unusable (pinned) row
constexpr int MAXL = 2;

// Segmented-scan state of a run prefix: f = a run start lies inside.
struct Run {
  int f;
  int cnt;
  int mb;
  int nn[MAXL];
  long long s[MAXL];
};

struct Params {
  const int* spk;
  const int* lane[MAXL];
  const unsigned char* bad;
  const unsigned char* nw;
  int nc;
  int bit[MAXL];
  long long n;
};

struct Outs {
  unsigned char* gv;
  long long* cnt;
  int* key;
  long long* sum[MAXL];
  long long* nn[MAXL];
};

__device__ __forceinline__ Run identity() {
  Run r;
  r.f = 0;
  r.cnt = 0;
  r.mb = 0;
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    r.nn[c] = 0;
    r.s[c] = 0;
  }
  return r;
}

// a then b (b later in the array)
__device__ __forceinline__ Run combine(const Run& a, const Run& b) {
  if (b.f) return b;
  Run r;
  r.f = a.f;
  r.cnt = a.cnt + b.cnt;
  r.mb = a.mb + b.mb;
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    r.nn[c] = a.nn[c] + b.nn[c];
    r.s[c] = a.s[c] + b.s[c];
  }
  return r;
}

__device__ __forceinline__ Run shfl_up(const Run& x, int d) {
  Run r;
  r.f = __shfl_up_sync(0xffffffffu, x.f, d);
  r.cnt = __shfl_up_sync(0xffffffffu, x.cnt, d);
  r.mb = __shfl_up_sync(0xffffffffu, x.mb, d);
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    r.nn[c] = __shfl_up_sync(0xffffffffu, x.nn[c], d);
    r.s[c] = __shfl_up_sync(0xffffffffu, x.s[c], d);
  }
  return r;
}

__device__ __forceinline__ bool run_start(int v, int pv) { return (v | 1) != (pv | 1); }

// Element i's scan value and its overflow / join-row contributions.
__device__ __forceinline__ Run element(const Params& p, long long i, int& dup, int& contrib) {
  const int v = p.spk[i];
  const int pv = i ? p.spk[i - 1] : INT_MIN;  // below every real pk
  const bool hay = (v & 1) == 0;
  const bool real = v < PIN;
  const bool phay = (pv & 1) == 0;
  const bool kd = run_start(v, pv);
  const bool ct = !hay && real;
  Run r;
  r.f = kd || i == 0;
  r.cnt = ct;
  r.mb = ct && !kd && phay && pv == (int)((unsigned)v - 1u);
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    const bool on = c < p.nc && ct;
    r.s[c] = on ? (long long)p.lane[c][i] : 0ll;
    r.nn[c] = on && p.bit[c] >= 0 && !((p.nw[i] >> p.bit[c]) & 1);
  }
  dup = hay && real && v == pv && phay;
  contrib = ct;
  return r;
}

// Block-wide scan of one value per thread, in thread order: incl / excl
// are this thread's inclusive / exclusive prefixes, total the block's.
__device__ void block_scan(const Run& x, Run& incl, Run& excl, Run& total) {
  __shared__ Run warp_tot[WARPS];
  __shared__ Run warp_pre[WARPS + 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  Run v = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Run o = shfl_up(v, d);
    if (lane >= d) v = combine(o, v);
  }
  Run ex = shfl_up(v, 1);
  if (lane == 31) warp_tot[w] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    Run acc = identity();
    for (int k = 0; k < WARPS; ++k) {
      warp_pre[k] = acc;
      acc = combine(acc, warp_tot[k]);
    }
    warp_pre[WARPS] = acc;
  }
  __syncthreads();
  const Run pre = warp_pre[w];
  incl = combine(pre, v);
  excl = lane == 0 ? pre : combine(pre, ex);
  total = warp_pre[WARPS];
  __syncthreads();  // the shared arrays are reused by the next call
}

__global__ void k2_reduce(Params p, Run* carries, unsigned long long* meta) {
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  Run agg = identity();
  int dup = 0, bad = 0, rows = 0;
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= p.n) break;
    int d, ct;
    agg = combine(agg, element(p, i, d, ct));
    dup |= d;
    rows += ct;
    bad |= p.bad[i] != 0;
  }
  Run incl, excl, total;
  block_scan(agg, incl, excl, total);
  __shared__ int block_rows;
  if (threadIdx.x == 0) block_rows = 0;
  const int any = __syncthreads_or(dup | bad);
  if (rows) atomicAdd(&block_rows, rows);
  __syncthreads();
  if (threadIdx.x == 0) {
    carries[blockIdx.x] = total;
    if (any) atomicOr(&meta[0], 1ull);
    if (block_rows) atomicAdd(&meta[1], (unsigned long long)block_rows);
  }
}

// One block: carries[t] <- the combination of tiles 0..t-1 (identity for 0).
__global__ void k2_scan_tiles(Run* carries, long long tiles) {
  __shared__ Run running;
  if (threadIdx.x == 0) running = identity();
  __syncthreads();
  for (long long c0 = 0; c0 < tiles; c0 += THREADS) {
    const long long t = c0 + threadIdx.x;
    const Run x = t < tiles ? carries[t] : identity();
    Run incl, excl, total;
    block_scan(x, incl, excl, total);
    const Run before = running;
    __syncthreads();
    if (t < tiles) carries[t] = combine(before, excl);
    if (threadIdx.x == 0) running = combine(before, total);
    __syncthreads();
  }
}

__global__ void k2_emit(Params p, const Run* carries, Outs o) {
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  Run agg = identity();
  int d, ct;
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= p.n) break;
    agg = combine(agg, element(p, i, d, ct));
  }
  Run incl, excl, total;
  block_scan(agg, incl, excl, total);
  Run st = combine(carries[blockIdx.x], excl);
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= p.n) break;
    st = combine(st, element(p, i, d, ct));
    const int v = p.spk[i];
    const bool end = i == p.n - 1 || run_start(p.spk[i + 1], v);
    const bool emit = end && st.cnt > 0 && st.mb > 0;
    o.gv[i] = emit;
    o.cnt[i] = emit ? (long long)st.cnt : 0ll;
    o.key[i] = emit ? v : 0;
#pragma unroll
    for (int c = 0; c < MAXL; ++c) {
      if (c < p.nc) o.sum[c][i] = emit ? st.s[c] : 0ll;
      if (o.nn[c]) o.nn[c][i] = emit ? (long long)st.nn[c] : 0ll;
    }
  }
}

__global__ void k3_kernel(const int* __restrict__ spk, const unsigned char* __restrict__ bad,
                          long long n, unsigned char* __restrict__ ok, int* flag) {
  int any = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int v = spk[i];
    const int pv = i ? spk[i - 1] : INT_MIN;
    const bool inner = (v & 1) == 0;
    const bool real = v < PIN;
    if (inner && real && v == pv) any = 1;
    if (bad[i]) any = 1;
    bool hit = false;
    // v - 1 == INT_MIN could only sit at element 0, where it does not start
    // a run (its predecessor is INT_MIN itself)
    if (!inner && real && v != INT_MIN + 1) {
      const int target = v - 1;
      long long lo = 0, hi = i;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (spk[mid] < target)
          lo = mid + 1;
        else
          hi = mid;
      }
      hit = lo < i && spk[lo] == target;
    }
    ok[i] = hit;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) atomicOr(flag, 1);
}

}  // namespace

extern "C" long long postsort_segscan_tiles(long long n) { return (n + TILE - 1) / TILE; }

extern "C" int postsort_segscan_carry_bytes() { return (int)sizeof(Run); }

// K2. Outputs are written in full (no initialisation needed) except
// meta int64[2] = {0, 0} (overflow, join rows). carries: tiles * carry_bytes
// of scratch. sum1 / nn0 / nn1 may be null when unused; nn_c is written
// only for a lane with bit_c >= 0. Returns cudaGetLastError(), -1 for bad
// arguments.
extern "C" int postsort_segscan_launch(const void* spk, const void* lane0, const void* lane1,
                                       const void* bad, const void* nw, int nc, int bit0, int bit1,
                                       long long n, void* gv, void* cnt, void* key, void* sum0,
                                       void* sum1, void* nn0, void* nn1, void* carries, void* meta,
                                       void* stream) {
  if (nc < 0 || nc > MAXL || n < 1 || n >= (1ll << 31)) return -1;
  Params p;
  p.spk = (const int*)spk;
  p.lane[0] = (const int*)lane0;
  p.lane[1] = (const int*)lane1;
  p.bad = (const unsigned char*)bad;
  p.nw = (const unsigned char*)nw;
  p.nc = nc;
  p.bit[0] = nc > 0 ? bit0 : -1;
  p.bit[1] = nc > 1 ? bit1 : -1;
  p.n = n;
  if ((p.bit[0] >= 0 || p.bit[1] >= 0) && !nw) return -1;
  Outs o;
  o.gv = (unsigned char*)gv;
  o.cnt = (long long*)cnt;
  o.key = (int*)key;
  o.sum[0] = (long long*)sum0;
  o.sum[1] = (long long*)sum1;
  o.nn[0] = p.bit[0] >= 0 ? (long long*)nn0 : nullptr;
  o.nn[1] = p.bit[1] >= 0 ? (long long*)nn1 : nullptr;
  const long long tiles = postsort_segscan_tiles(n);
  cudaStream_t st = (cudaStream_t)stream;
  Run* cr = (Run*)carries;

  k2_reduce<<<(unsigned)tiles, THREADS, 0, st>>>(p, cr, (unsigned long long*)meta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2_scan_tiles<<<1, THREADS, 0, st>>>(cr, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2_emit<<<(unsigned)tiles, THREADS, 0, st>>>(p, cr, o);
  return (int)cudaGetLastError();
}

// K3. ok: uint8[n] (written in full); flag int32[1] = 0.
extern "C" int membership_segscan_launch(const void* spk, const void* bad, long long n, void* ok,
                                         void* flag, void* stream) {
  if (n < 1 || n >= (1ll << 31)) return -1;
  long long want = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 4 * 132 * 8 ? want : 4 * 132 * 8);
  k3_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)spk, (const unsigned char*)bad, n, (unsigned char*)ok, (int*)flag);
  return (int)cudaGetLastError();
}

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
// Hopper's blocks run in no order and it adds int64 natively, so K2 is a
// segmented scan over the associative (reset flag, totals) operator
// `combine`, in ONE launch of k2_scan, a single-pass decoupled look-back
// scan (Merrill and Garland's, written here, no library):
//   * a block takes its tile id (TILE = 2048 elements) from a counter, so
//     it only ever waits on tiles already running;
//   * it loads the tile with coalesced 16-B loads into shared memory, plus
//     one halo element at each edge (spk[start - 1], spk[end]): every input
//     element is read from device memory once;
//   * each thread reduces its 8 consecutive elements, the block scans the
//     thread totals and publishes the tile's aggregate (payload, then
//     __threadfence, then a release store of the status word). A tile
//     whose aggregate holds a run start is its own inclusive prefix
//     (combine(x, b) = b when b starts a run), so it publishes that at
//     once: in Q3 nearly every tile does, and look-back is one step;
//   * warp 0 looks back over up to 32 predecessors at a time (acquire
//     loads of the status words, then the payloads from L2) until the
//     nearest inclusive prefix, and the tile publishes its own;
//   * each warp writes its 256 elements of every output through a
//     swizzled shared-memory stage, so a warp store instruction writes
//     contiguous memory, 16 B a thread (gv: 16 B a thread, 16 threads).
// The overflow flag and the join rows are one block reduction and one
// atomic each per block; the last block to finish moves them into the
// call's outputs.
//
// Regions: one launch scans B regions of n rows each (the region-batched
// program's vmap rule). Tile ids run region after region, so a region's
// tiles still only wait on tiles already running; a tile looks back no
// further than its region's first tile (before it lies the identity), and
// each region's flag and join rows gather in its own record of a second
// scratch (RegionAcc), which the launch's last block moves into the
// [B] outputs and zeroes.
//
// Scratch and reset: the wrapper keeps one zeroed scratch buffer per
// device and stream: a header {counter, done, 16 unused bytes, epoch},
// then one 88-B record per tile of every region: its status word
// ((epoch << 2) | 1 aggregate, | 2 inclusive prefix; 0 never published)
// and its two 40-B payloads. A record's status word sits at the same
// offset whatever n and B are, so a word there only ever holds a status
// word, of this launch or of an earlier one. The epoch
// lives on the device: every block reads it when it starts, and the last
// block of a launch (a block counts itself done only after it has read the
// epoch, taken its tile id, finished its look-back and added its flag and
// rows) bumps it and resets the counter, done, flag and rows. So stale
// status words of an earlier call never match, no reset launch runs, two
// calls in a row give the same results, and the epoch stays right for
// callers on several threads sharing a stream and for graph replays.
//
// The limbs, the bias and the run cap are gone: a run of any length stays
// here. Sums of int32 lanes in int64 are exact, so the result does not
// depend on the order of the additions.
//
// Bound on an H100 SXM (3.35 TB/s): memory. K2 reads spk (4 B), each lane
// (4 B), the bad byte and the null word (1 B), and writes gv (1 B), cnt
// (8 B), key (4 B), each sum (8 B) and each nullable lane's count (8 B):
// 39 B a row for Q3's one nullable lane, 189,136,912 B over its 4,849,664
// sorted rows (2^22 lineitem rows + 655,360 hay rows), 0.056 ms.
// Resources (ptxas -v, sm_90a): k2_scan runs 256 threads a block, capped
// at 64 registers (__launch_bounds__(256, 4): four blocks, 32 warps, per
// SM), 64 bytes of stack and no spills, 43,768 B of static shared memory (spk 8 KB,
// lanes 16 KB, null word 2 KB, output stages 16 KB, scan scratch). Its
// times on the card are in PERF.md.
//
// K3 membership_segscan replaces the Pallas kernel of the same name
// (tidb_tpu/ops/joinscan.py:344, pallas_call at :365). Over the sorted
// packed keys it marks each outer (odd) real row whose run (a maximal
// block of equal spk | 1) begins with a usable inner row, and flags
// overflow: a duplicate usable inner key, or any bad byte. ONE launch of
// k3_kernel and no other device operation; one CTA of 256 threads per
// 2048-row tile, 8 consecutive rows a thread: 320 CTAs, one wave, at Q3's
// 655,360 rows (grid (tiles, B) over B regions: each region starts at a
// tile boundary, has its own ticket and its own flag, and no window or
// search crosses its start). No search per row:
//   * every load goes out at once: two 16-B spk loads and two 4-B bad
//     loads a thread, and the 32 rows before each warp (its window);
//   * a warp whose rows are all pinned stops there (Q3's 371,356-row
//     pinned tail): a real row after a pinned one always starts its run;
//   * a thread turns its rows into bit masks (run starts K, heads A,
//     outer real rows O); the head bit of every row's run is the carry
//     chain of one add, (~K | A) + A + carry-in (k3_heads). The carry-in is
//     the last start of the nearest earlier lane (two ballots), else the
//     warp's leading run, decided by its window: the last row before the
//     run there, or for a run that fills the window a 32-ary search of the
//     rows before it (the one place that takes the keys as sorted). Warps
//     never wait on one another;
//   * ok leaves with 4-B streaming stores. The flag: warps 1-7 leave their
//     bit in shared memory and arrive at a named barrier; warp 0 waits
//     there and takes the CTA's ticket, one 64-bit atomic carrying the
//     count and the flag; the last CTA writes the 0-d output and zeroes
//     the ticket (K3Scratch, 16 B per device and stream, zeroed once).
// Element 0's predecessor is INT_MIN, as in the plain version: an INT_MIN
// inner row there heads no run (and counts as a duplicate).
// Bound on an H100 SXM (3.35 TB/s): memory, 6 B a row (spk, bad, ok) and
// the flag, 3,932,161 B at Q3, 0.0012 ms. A kernel this small sits on the
// card's floor instead (a one-element fill takes 0.0010 ms, a copy of as
// many bytes 0.0015 ms), and the completion signal across CTAs that the
// one 0-d output needs (this ticket; counters that one CTA polls were no
// faster) lies on its critical path. Times and variants: PERF.md.
// Resources (ptxas -v, sm_90a): k3_kernel<true> 31 registers, <false> 30,
// 32 B of shared memory, no spills. Views at an element offset take the
// <false> copy (per-element loads); the launcher picks it by alignment.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // elements per tile (and per block)
constexpr int WTILE = 32 * ITEMS;      // a warp's consecutive elements
constexpr int PIN = 0x7FFFFFFC;        // pk >= PIN: an unusable (pinned) row
constexpr int MAXL = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long ST_AGG = 1, ST_PRE = 2;  // status = epoch << 2 | state

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
  long long n;      // rows a region
  long long tiles;  // tiles a region
};

struct Outs {
  unsigned char* gv;
  long long* cnt;
  int* key;
  long long* sum[MAXL];
  long long* nn[MAXL];
  unsigned char* ovf;
  long long* rows;
};

// Head of the scratch buffer; one TileRec per tile follows.
struct Scratch {
  unsigned long long counter;  // next tile id
  unsigned long long done;     // blocks past their flag and rows
  unsigned long long unused[2];
  unsigned long long epoch;    // this launch's; the last block bumps it
};

// A region's flag and join rows, in a second zeroed buffer of one record
// per region; the last block of a launch moves them into the outputs and
// zeroes them.
struct RegionAcc {
  unsigned long long ovf;
  unsigned long long rows;
};

struct TileRec {
  unsigned long long status;  // epoch << 2 | ST_AGG or ST_PRE
  Run agg;
  Run pre;
};
static_assert(sizeof(Run) == 40 && sizeof(TileRec) == 88, "the record sizes the notes state");

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

template <typename F>
__device__ __forceinline__ Run shfl_run(const Run& x, F sh) {
  Run r;
  r.f = sh(x.f);
  r.cnt = sh(x.cnt);
  r.mb = sh(x.mb);
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    r.nn[c] = sh(x.nn[c]);
    r.s[c] = sh(x.s[c]);
  }
  return r;
}

__device__ __forceinline__ Run shfl_up(const Run& x, int d) {
  return shfl_run(x, [d](auto v) { return __shfl_up_sync(FULL, v, d); });
}

__device__ __forceinline__ Run shfl_down(const Run& x, int d) {
  return shfl_run(x, [d](auto v) { return __shfl_down_sync(FULL, v, d); });
}

__device__ __forceinline__ Run shfl_lane0(const Run& x) {
  return shfl_run(x, [](auto v) { return __shfl_sync(FULL, v, 0); });
}

__device__ __forceinline__ bool run_start(int v, int pv) { return (v | 1) != (pv | 1); }

// Shared-memory swizzle of 16-B chunks: chunk c moves within its 128-B row
// (c ^ row), so a thread's consecutive chunks and a warp's striped chunks
// both fall on distinct banks.
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }
__device__ __forceinline__ int sw32(int e) { return (swz(e >> 2) << 2) | (e & 3); }
__device__ __forceinline__ int sw64(int e) { return (swz(e >> 1) << 1) | (e & 1); }

__host__ __device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// m int32 elements of g into the swizzled tile sm: 16 B a thread,
// neighbouring threads on neighbouring addresses, where the tile is whole.
__device__ __forceinline__ void load_i32(int* sm, const int* g, int m) {
  if (m == TILE && aligned16(g)) {
    const int4* g4 = reinterpret_cast<const int4*>(g);
    int4* s4 = reinterpret_cast<int4*>(sm);
#pragma unroll
    for (int k = 0; k < TILE / 4 / THREADS; ++k) {
      const int q = threadIdx.x + k * THREADS;
      s4[swz(q)] = __ldcs(g4 + q);
    }
  } else {
    for (int e = threadIdx.x; e < m; e += THREADS) sm[sw32(e)] = g[e];
  }
}

__device__ __forceinline__ void load_u8(unsigned char* sm, const unsigned char* g, int m) {
  if (m == TILE && aligned16(g)) {
    if (threadIdx.x < TILE / 16)
      reinterpret_cast<uint4*>(sm)[threadIdx.x] = __ldcs(reinterpret_cast<const uint4*>(g) + threadIdx.x);
  } else {
    for (int e = threadIdx.x; e < m; e += THREADS) sm[e] = g[e];
  }
}

// Any set byte among g[0..m), this thread's share.
__device__ __forceinline__ int any_byte(const unsigned char* g, int m) {
  if (m == TILE && aligned16(g)) {
    if (threadIdx.x >= TILE / 16) return 0;
    const uint4 x = __ldcs(reinterpret_cast<const uint4*>(g) + threadIdx.x);
    return (x.x | x.y | x.z | x.w) != 0;
  }
  int a = 0;
  for (int e = threadIdx.x; e < m; e += THREADS) a |= g[e] != 0;
  return a;
}

// This thread's 8 consecutive int32 elements of a swizzled tile.
__device__ __forceinline__ void read8(const int* sm, int t, int (&v)[ITEMS]) {
  const int4* s4 = reinterpret_cast<const int4*>(sm);
  const int4 a = s4[swz(2 * t)], b = s4[swz(2 * t + 1)];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Payloads are read from L2 (they were written by other SMs).
__device__ __forceinline__ Run load_run(const Run* p) {
  Run r;
  r.f = __ldcg(&p->f);
  r.cnt = __ldcg(&p->cnt);
  r.mb = __ldcg(&p->mb);
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    r.nn[c] = __ldcg(&p->nn[c]);
    r.s[c] = __ldcg(&p->s[c]);
  }
  return r;
}

// Payload, fence, then the status word.
__device__ __forceinline__ void publish(unsigned long long* status, Run* slot, const Run& r,
                                        unsigned long long word) {
  *slot = r;
  __threadfence();
  store_release(status, word);
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

// Warp 0: the combination of records first..tile-1 (the tiles of the
// region before this one), walking back 32 tiles at a time until the
// nearest one that has published its inclusive prefix; it never reads a
// record before the region's first.
__device__ Run look_back(const TileRec* rec, long long tile, long long first, unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  Run acc = identity();  // the tiles after the current window
  for (long long w = tile - 1;; w -= 32) {
    const long long pt = w - lane;  // lane 0 is the nearest predecessor
    int state = pt < first ? (int)ST_PRE : 0;  // before the region's first tile: the identity
    unsigned pm, upto;
    for (;;) {
      if (state == 0) {
        const unsigned long long s = load_acquire(&rec[pt].status);
        if ((s >> 2) == epoch) state = (int)(s & 3);
      }
      const unsigned ready = __ballot_sync(FULL, state != 0);
      pm = __ballot_sync(FULL, state == (int)ST_PRE);
      upto = pm ? (pm ^ (pm - 1)) : FULL;  // lanes up to the nearest prefix
      if ((ready & upto) == upto) break;
      __nanosleep(32);
    }
    Run x = identity();
    if (((upto >> lane) & 1) && pt >= first) x = load_run(state == (int)ST_PRE ? &rec[pt].pre : &rec[pt].agg);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Run o = shfl_down(x, d);  // lane + d is the earlier tile
      if (lane + d < 32) x = combine(o, x);
    }
    acc = combine(shfl_lane0(x), acc);
    if (pm) return acc;
  }
}

// A warp's output staging (2 KB): each thread puts its 8 values, then the
// warp stores its 256 elements contiguously, 16 B a thread, as streaming
// stores (the outputs are not read again by this kernel).
__device__ __forceinline__ void store64(long long* stg, long long* g, int wm, const long long (&out)[ITEMS]) {
  const int lane = threadIdx.x & 31;
  longlong2* s2 = reinterpret_cast<longlong2*>(stg);
#pragma unroll
  for (int k = 0; k < ITEMS / 2; ++k) s2[swz(lane * (ITEMS / 2) + k)] = make_longlong2(out[2 * k], out[2 * k + 1]);
  __syncwarp();
  if (wm == WTILE && aligned16(g)) {
    longlong2* g2 = reinterpret_cast<longlong2*>(g);
#pragma unroll
    for (int k = 0; k < WTILE / 2 / 32; ++k) __stcs(g2 + lane + 32 * k, s2[swz(lane + 32 * k)]);
  } else {
    for (int e = lane; e < wm; e += 32) g[e] = stg[sw64(e)];
  }
  __syncwarp();
}

__device__ __forceinline__ void store32(long long* stg, int* g, int wm, const int (&out)[ITEMS]) {
  const int lane = threadIdx.x & 31;
  int4* s4 = reinterpret_cast<int4*>(stg);
  s4[swz(2 * lane)] = make_int4(out[0], out[1], out[2], out[3]);
  s4[swz(2 * lane + 1)] = make_int4(out[4], out[5], out[6], out[7]);
  __syncwarp();
  if (wm == WTILE && aligned16(g)) {
    int4* g4 = reinterpret_cast<int4*>(g);
#pragma unroll
    for (int k = 0; k < WTILE / 4 / 32; ++k) __stcs(g4 + lane + 32 * k, s4[swz(lane + 32 * k)]);
  } else {
    const int* s = reinterpret_cast<const int*>(stg);
    for (int e = lane; e < wm; e += 32) g[e] = s[sw32(e)];
  }
  __syncwarp();
}

__device__ __forceinline__ void store8(long long* stg, unsigned char* g, int wm, unsigned long long bytes) {
  const int lane = threadIdx.x & 31;
  reinterpret_cast<unsigned long long*>(stg)[lane] = bytes;
  __syncwarp();
  if (wm == WTILE && aligned16(g)) {
    if (lane < WTILE / 16) __stcs(reinterpret_cast<uint4*>(g) + lane, reinterpret_cast<const uint4*>(stg)[lane]);
  } else {
    const unsigned char* s = reinterpret_cast<const unsigned char*>(stg);
    for (int e = lane; e < wm; e += 32) g[e] = s[e];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 4) k2_scan(Params p, Outs o, unsigned char* scratch, RegionAcc* acc,
                                                      int regions) {
  __shared__ __align__(16) int s_spk[TILE];
  __shared__ __align__(16) int s_lane[MAXL][TILE];
  __shared__ __align__(16) unsigned char s_nw[TILE];
  __shared__ __align__(16) long long s_stage[WARPS][WTILE];
  __shared__ int s_halo[2];
  __shared__ long long s_tile;
  __shared__ unsigned long long s_epoch;
  __shared__ int s_rows;
  __shared__ Run s_carry;

  Scratch* sc = reinterpret_cast<Scratch*>(scratch);
  TileRec* rec = reinterpret_cast<TileRec*>(sc + 1);

  if (threadIdx.x == 0) {
    s_epoch = __ldcg(&sc->epoch);
    s_tile = (long long)atomicAdd(&sc->counter, 1ull);
    s_rows = 0;
  }
  __syncthreads();
  // tile ids run region after region: record g is tile g % tiles of
  // region g / tiles, whose rows and outputs start region * n elements in
  const long long g = s_tile;
  const long long region = g / p.tiles, tile = g - region * p.tiles, first = region * p.tiles;
  const long long roff = region * p.n;
  p.spk += roff;
  p.bad += roff;
  if (p.nw) p.nw += roff;
  o.gv += roff;
  o.cnt += roff;
  o.key += roff;
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    if (p.lane[c]) p.lane[c] += roff;
    if (o.sum[c]) o.sum[c] += roff;
    if (o.nn[c]) o.nn[c] += roff;
  }
  const unsigned long long epoch = s_epoch;
  const long long start = tile * TILE;
  const int m = (int)min((long long)TILE, p.n - start);  // < TILE only for the last tile

  // 1. the tile's inputs, read once
  load_i32(s_spk, p.spk + start, m);
  for (int c = 0; c < p.nc; ++c) load_i32(s_lane[c], p.lane[c] + start, m);
  const bool nullable = p.bit[0] >= 0 || p.bit[1] >= 0;
  if (nullable) load_u8(s_nw, p.nw + start, m);
  int flag = any_byte(p.bad + start, m);
  if (threadIdx.x == 0) s_halo[0] = start ? p.spk[start - 1] : INT_MIN;  // below every real pk
  if (threadIdx.x == 32) s_halo[1] = start + m < p.n ? p.spk[start + m] : 0;
  __syncthreads();

  // 2. this thread's elements e0..e0+7: per-element bits and their reduction
  const int t = threadIdx.x, e0 = t * ITEMS;
  const int mt = max(0, min(ITEMS, m - e0));
  int v[ITEMS], lv[MAXL][ITEMS];
  read8(s_spk, t, v);
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    if (c < p.nc) read8(s_lane[c], t, lv[c]);
  }
  unsigned long long nwv = 0;
  if (nullable) nwv = *reinterpret_cast<const unsigned long long*>(s_nw + e0);
  const int pv0 = t ? s_spk[sw32(e0 - 1)] : s_halo[0];
  const int nx = e0 + ITEMS < m ? s_spk[sw32(e0 + ITEMS)] : s_halo[1];
  unsigned fm = 0, ctm = 0, mbm = 0, endm = 0, nnm[MAXL] = {0, 0};
  int dup = 0, rows = 0;
  Run a = identity();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (j < mt) {
      const int x = v[j], px = j ? v[j - 1] : pv0, nxx = j + 1 < ITEMS ? v[j + 1] : nx;
      const long long i = start + e0 + j;
      const bool hay = (x & 1) == 0, real = x < PIN, phay = (px & 1) == 0;
      const bool kd = run_start(x, px);
      const bool ct = !hay && real;
      Run r;
      r.f = kd || i == 0;
      r.cnt = ct;
      r.mb = ct && !kd && phay && px == (int)((unsigned)x - 1u);
#pragma unroll
      for (int c = 0; c < MAXL; ++c) {
        const bool on = c < p.nc && ct;
        r.s[c] = on ? (long long)lv[c][j] : 0ll;
        r.nn[c] = on && p.bit[c] >= 0 && !((nwv >> (8 * j + p.bit[c])) & 1);
        nnm[c] |= (unsigned)r.nn[c] << j;
      }
      fm |= (unsigned)r.f << j;
      ctm |= (unsigned)ct << j;
      mbm |= (unsigned)r.mb << j;
      endm |= (unsigned)(i == p.n - 1 || run_start(nxx, x)) << j;
      dup |= hay && real && x == px && phay;
      rows += ct;
      a = combine(a, r);
    }
  }

  // 3. the tile's scan, its aggregate published, the carry-in looked up
  Run incl, excl, total;
  block_scan(a, incl, excl, total);
  flag = __syncthreads_or(flag | dup);
  if (rows) atomicAdd(&s_rows, rows);
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      if (total.f)
        publish(&rec[g].status, &rec[g].pre, total, epoch << 2 | ST_PRE);
      else
        publish(&rec[g].status, &rec[g].agg, total, epoch << 2 | ST_AGG);
    }
    Run x = identity();
    if (tile > 0) x = look_back(rec, g, first, epoch);
    if (threadIdx.x == 0) {
      s_carry = x;
      if (!total.f) publish(&rec[g].status, &rec[g].pre, combine(x, total), epoch << 2 | ST_PRE);
    }
  }
  __syncthreads();
  const Run st = combine(s_carry, excl);  // the state before element e0

  // 4. every output, staged per warp and stored contiguously
  const int w = threadIdx.x >> 5;
  const long long wb = start + (long long)w * WTILE;
  const int wm = max(0, min(WTILE, m - w * WTILE));
  long long* stg = s_stage[w];
  unsigned em = 0;  // the elements that emit their run's totals
  {
    int cr = st.cnt, mr = st.mb;
    long long out[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if ((fm >> j) & 1) cr = mr = 0;
      cr += (ctm >> j) & 1;
      mr += (mbm >> j) & 1;
      const bool e = ((endm >> j) & 1) && cr > 0 && mr > 0;
      em |= (unsigned)e << j;
      out[j] = e ? (long long)cr : 0ll;
    }
    store64(stg, o.cnt + wb, wm, out);
  }
  {
    int out[ITEMS];
    unsigned long long bytes = 0;
    read8(s_spk, t, v);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      out[j] = ((em >> j) & 1) ? v[j] : 0;
      bytes |= (unsigned long long)((em >> j) & 1) << (8 * j);
    }
    store32(stg, o.key + wb, wm, out);
    store8(stg, o.gv + wb, wm, bytes);
  }
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    if (c < p.nc) {
      long long run = st.s[c], out[ITEMS];
      read8(s_lane[c], t, v);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const long long xv = ((ctm >> j) & 1) ? (long long)v[j] : 0ll;
        run = ((fm >> j) & 1) ? xv : run + xv;
        out[j] = ((em >> j) & 1) ? run : 0ll;
      }
      store64(stg, o.sum[c] + wb, wm, out);
    }
    if (o.nn[c]) {
      int run = st.nn[c];
      long long out[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int xv = (nnm[c] >> j) & 1;
        run = ((fm >> j) & 1) ? xv : run + xv;
        out[j] = ((em >> j) & 1) ? (long long)run : 0ll;
      }
      store64(stg, o.nn[c] + wb, wm, out);
    }
  }

  // 5. the flag and the join rows, off the look-back's path
  if (threadIdx.x == 0) {
    if (flag) atomicOr(&acc[region].ovf, 1ull);
    if (s_rows) atomicAdd(&acc[region].rows, (unsigned long long)s_rows);
    __threadfence();
    if (atomicAdd(&sc->done, 1ull) == gridDim.x - 1ull) {
      // every block of every region has read the epoch, taken its tile
      // id, looked back and added its flag and rows
      __threadfence();
      for (int r = 0; r < regions; ++r) {
        o.ovf[r] = atomicExch(&acc[r].ovf, 0ull) != 0;
        o.rows[r] = (long long)atomicExch(&acc[r].rows, 0ull);
      }
      atomicAdd(&sc->epoch, 1ull);
      atomicExch(&sc->counter, 0ull);
      atomicExch(&sc->done, 0ull);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: one CTA per tile of K3_TILE rows, K3_ITEMS consecutive rows a thread
// ---------------------------------------------------------------------------

constexpr int K3_THREADS = 256;
constexpr int K3_ITEMS = 8;
constexpr int K3_TILE = K3_THREADS * K3_ITEMS;
constexpr int K3_WARPS = K3_THREADS / 32;
static_assert(K3_ITEMS % 4 == 0 && K3_ITEMS < 32, "vector accesses; a row mask and its carry in 32 bits");

struct K3Scratch {
  // CTAs of this launch finished (low 32 bits) and, of those, the ones
  // that saw a duplicate or a bad bit (high 32 bits): one atomic a CTA
  unsigned long long tickets;
  unsigned long long pad;
};

// v is a run head led by a usable inner row; pv is the element before it
// (INT_MIN before element 0, as in the plain version).
__device__ __forceinline__ bool k3_head(int v, int pv) {
  return (v & 1) == 0 && v < PIN && (v | 1) != (pv | 1);
}

// A warp: the head bit of the run that holds element e (> 0), the warp's
// first row, when that run began before e. w is spk[e - 32 + lane]
// (anything where that is below 0), x is spk[e]. The last element before
// the run inside the 32-element window decides at once; a run that fills
// the window is found by a 32-ary search of [0, e - 32] for its first
// element, which takes the input to be sorted (each step: 32 probes, one
// ballot).
__device__ int k3_lead(const int* __restrict__ spk, long long e, int w, int x) {
  const int lane = threadIdx.x & 31;
  const int key = x | 1;
  const long long base = e - 32;
  const unsigned out = __ballot_sync(FULL, base + lane < 0 || (w | 1) != key);
  if (out) {
    const int q = 31 - __clz(out);  // <= 30: element e - 1 is in the run
    const int vf = __shfl_sync(FULL, w, q + 1);
    const int pw = __shfl_sync(FULL, w, q);
    return k3_head(vf, base + q < 0 ? INT_MIN : pw);
  }
  long long lo = 0, hi = base;  // the run's first element lies in [lo, hi]
  while (lo < hi) {
    const long long q = lo + (long long)lane * (hi - lo) / 32;
    const int c = __popc(__ballot_sync(FULL, (__ldcg(spk + q) | 1) < key));
    if (c == 0) break;  // spk[lo] is in the run
    const long long below = __shfl_sync(FULL, q, c - 1);
    if (c < 32) hi = __shfl_sync(FULL, q, c);
    lo = below + 1;
  }
  return k3_head(__ldcg(spk + lo), lo ? __ldcg(spk + lo - 1) : INT_MIN);
}

// H[j], the head bit of the last run start at or before row j of a thread
// (cin before its first start), for all rows at once: K marks the run
// starts and A the heads among them. In x + A + cin with x = ~K | A, a head
// generates a carry, another start kills it and any other row propagates
// it, so the carry out of bit j is H[j].
__device__ __forceinline__ unsigned k3_heads(unsigned K, unsigned A, unsigned cin) {
  constexpr unsigned ROWS = (1u << K3_ITEMS) - 1;
  const unsigned x = (~K & ROWS) | A;
  return ((x + A + cin) ^ x ^ A) >> 1;
}

// Four ok bits (bits 0-3 of b) as four bytes.
__device__ __forceinline__ unsigned k3_bytes(unsigned b) { return (b & 15u) * 0x204081u & 0x01010101u; }

// ok[i] = an outer real row whose run (a maximal block of equal spk | 1)
// begins with a run head; ovf = a duplicate usable inner key or any bad
// byte. VEC: spk 16-B, bad and ok 4-B aligned; whole threads then load and
// store with vector accesses, and the ragged tail per element.
template <bool VEC>
__global__ void __launch_bounds__(K3_THREADS) k3_kernel(const int* __restrict__ spk,
                                                        const unsigned char* __restrict__ bad, int n,
                                                        unsigned char* __restrict__ ok,
                                                        unsigned char* __restrict__ ovf, K3Scratch* sc) {
  constexpr int W = K3_ITEMS / 4;  // 4-row words a thread
  // the region (blockIdx.y): its rows, its ok bytes, its flag and its own
  // ticket. Row indexes below are the region's own, so the window before
  // a warp and the run-head search never cross the region's start.
  const long long region = blockIdx.y;
  spk += region * n;
  bad += region * n;
  ok += region * n;
  ovf += region;
  sc += region;
  __shared__ int s_any[K3_WARPS];  // each warp's overflow bit
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  const unsigned wb = blockIdx.x * (unsigned)K3_TILE + wp * (32u * K3_ITEMS);  // the warp's first row
  const unsigned e0 = wb + lane * K3_ITEMS;                                    // < 2^32: n < 2^31
  const int m = e0 < (unsigned)n ? min(K3_ITEMS, (int)((unsigned)n - e0)) : 0;

  // 1. every load at once: the thread's rows and bad bytes, and the 32
  // rows before the warp (INT_MIN before element 0). Rows past n read as
  // pinned.
  int v[K3_ITEMS];
  unsigned bb = 0;
  if (VEC && m == K3_ITEMS) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(spk + e0) + k);
      v[4 * k] = a.x, v[4 * k + 1] = a.y, v[4 * k + 2] = a.z, v[4 * k + 3] = a.w;
      bb |= __ldcs(reinterpret_cast<const unsigned*>(bad + e0) + k);
    }
  } else {
#pragma unroll
    for (int j = 0; j < K3_ITEMS; ++j) {
      v[j] = j < m ? spk[e0 + j] : PIN;
      bb |= j < m ? bad[e0 + j] : 0u;
    }
  }
  const int win = wb > 0 && wb < (unsigned)n ? spk[wb - 32 + lane] : INT_MIN;
  const int up = __shfl_up_sync(FULL, v[K3_ITEMS - 1], 1);
  const int win_last = __shfl_sync(FULL, win, 31);
  const int pv = lane ? up : win_last;

  // 2. per row: run starts K, heads A (starts led by a usable inner row),
  // outer real rows O, duplicates; then ok = O & the head bit of each
  // row's run. A warp whose rows are all pinned skips this: it has no ok
  // row and no duplicate.
  unsigned okm = 0;
  int any = bb != 0;
  int lo = v[0];
#pragma unroll
  for (int j = 1; j < K3_ITEMS; ++j) lo = min(lo, v[j]);
  if (!__all_sync(FULL, lo >= PIN)) {
    unsigned K = 0, A = 0, O = 0;
    int px = pv;
#pragma unroll
    for (int j = 0; j < K3_ITEMS; ++j) {
      const int x = v[j];
      const bool kd = (x | 1) != (px | 1), real = x < PIN, inner = (x & 1) == 0;
      K |= (unsigned)kd << j;
      A |= (unsigned)(kd && inner && real) << j;
      O |= (unsigned)(!inner && real) << j;
      any |= inner && real && x == px;
      px = x;
    }
    K |= e0 == 0;  // element 0 starts a run whatever its predecessor INT_MIN says
    // the carry into each thread: the head bit of the last start in the
    // nearest earlier lane that has one, else the warp's leading run's
    const unsigned h0 = k3_heads(K, A, 0);
    const unsigned S = __ballot_sync(FULL, K != 0), V = __ballot_sync(FULL, (h0 >> (K3_ITEMS - 1)) & 1);
    const int x0 = __shfl_sync(FULL, v[0], 0);
    const int lead = wb > 0 && x0 < PIN && (x0 | 1) == (win_last | 1) ? k3_lead(spk, wb, win, x0) : 0;
    const unsigned before = S & ((1u << lane) - 1u);
    const unsigned cin = before ? (V >> (31 - __clz(before))) & 1 : lead;
    okm = O & (cin ? k3_heads(K, A, 1) : h0);
  }
  if (VEC && m == K3_ITEMS) {
#pragma unroll
    for (int k = 0; k < W; ++k) __stcs(reinterpret_cast<unsigned*>(ok + e0) + k, k3_bytes(okm >> (4 * k)));
  } else {
#pragma unroll
    for (int j = 0; j < K3_ITEMS; ++j)
      if (j < m) ok[e0 + j] = (okm >> j) & 1;
  }

  // 3. the flag: warps 1.. leave their bit and go; warp 0 waits for them,
  // then takes the CTA's ticket, in which the flag rides. The last CTA
  // publishes the flag and resets the scratch. No fence: the ticket is all
  // that the CTAs share.
  any = __any_sync(FULL, any);
  if (lane == 0) s_any[wp] = any;
  if (wp) {
    asm volatile("bar.arrive 1, %0;" ::"n"(K3_THREADS) : "memory");
    return;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(K3_THREADS) : "memory");
  if (lane == 0) {
    int cta = 0;
#pragma unroll
    for (int k = 0; k < K3_WARPS; ++k) cta |= s_any[k];
    const unsigned long long seen = atomicAdd(&sc->tickets, 1ull | (unsigned long long)(cta != 0) << 32);
    if ((unsigned)seen == gridDim.x - 1) {
      *ovf = (seen >> 32) != 0 || cta;
      atomicExch(&sc->tickets, 0ull);
    }
  }
}

}  // namespace

extern "C" int postsort_segscan_tile() { return TILE; }

// Bytes of K2's scratch for B regions of n rows; it must be zeroed once
// when allocated.
extern "C" long long postsort_segscan_scratch_bytes(long long n, long long B) {
  const long long tiles = (n + TILE - 1) / TILE;
  return (long long)sizeof(Scratch) + B * tiles * (long long)sizeof(TileRec);
}

// Bytes of a region's record of K2's second scratch (its flag and join
// rows); B records, zeroed when allocated.
extern "C" long long postsort_segscan_acc_bytes() { return (long long)sizeof(RegionAcc); }

// K2 over B regions of n rows, one launch. Inputs and outputs are
// region-major and contiguous ([B, n]). Every output is written in full
// (no initialisation needed): gv, cnt, key, sum_c for c < nc, nn_c for a
// lane with bit_c >= 0, ovf (a byte a region) and rows (an int64 a
// region). sum1 / nn0 / nn1 may be null when unused. scratch: at least
// postsort_segscan_scratch_bytes(n, B) bytes, acc: B *
// postsort_segscan_acc_bytes(), both zeroed when allocated and then kept
// for every later call on the same stream that they fit. Returns
// cudaGetLastError(), -1 for bad arguments.
extern "C" int postsort_segscan_launch(const void* spk, const void* lane0, const void* lane1,
                                       const void* bad, const void* nw, int nc, int bit0, int bit1,
                                       long long n, int B, void* gv, void* cnt, void* key, void* sum0,
                                       void* sum1, void* nn0, void* nn1, void* ovf, void* rows,
                                       void* scratch, void* acc, void* stream) {
  if (nc < 0 || nc > MAXL || n < 1 || n >= (1ll << 31) || B < 1) return -1;
  if (!scratch || ((uintptr_t)scratch & 15) || !acc || ((uintptr_t)acc & 15)) return -1;
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
  p.tiles = (n + TILE - 1) / TILE;
  if (p.tiles * B >= (1ll << 31)) return -1;
  if ((p.bit[0] >= 0 || p.bit[1] >= 0) && !nw) return -1;
  Outs o;
  o.gv = (unsigned char*)gv;
  o.cnt = (long long*)cnt;
  o.key = (int*)key;
  o.sum[0] = (long long*)sum0;
  o.sum[1] = (long long*)sum1;
  o.nn[0] = p.bit[0] >= 0 ? (long long*)nn0 : nullptr;
  o.nn[1] = p.bit[1] >= 0 ? (long long*)nn1 : nullptr;
  o.ovf = (unsigned char*)ovf;
  o.rows = (long long*)rows;
  if (!spk || !bad || !gv || !cnt || !key || !ovf || !rows) return -1;
  for (int c = 0; c < nc; ++c)
    if (!p.lane[c] || !o.sum[c] || (p.bit[c] >= 0 && !o.nn[c])) return -1;
  k2_scan<<<(unsigned)(p.tiles * B), THREADS, 0, (cudaStream_t)stream>>>(p, o, (unsigned char*)scratch,
                                                                         (RegionAcc*)acc, B);
  return (int)cudaGetLastError();
}

extern "C" int membership_segscan_tile() { return K3_TILE; }

// Bytes of a region's record of K3's scratch; B records, zeroed once when
// allocated.
extern "C" long long membership_segscan_scratch_bytes() { return (long long)sizeof(K3Scratch); }

// K3 over B regions of n rows, one launch on `stream` (grid: tiles x B).
// spk int32 [B, n], each region sorted, bad byte [B, n]. Outputs, written
// in full: ok uint8 [B, n] and ovf (a byte a region). scratch: B *
// membership_segscan_scratch_bytes() bytes, zeroed when allocated and then
// kept for every later call on the same stream. Returns cudaGetLastError(),
// -1 for bad arguments.
extern "C" int membership_segscan_launch(const void* spk, const void* bad, long long n, int B, void* ok,
                                         void* ovf, void* scratch, void* stream) {
  if (n < 1 || n >= (1ll << 31) || B < 1 || B > 65535 || !spk || !bad || !ok || !ovf) return -1;
  if (!scratch || ((uintptr_t)scratch & 15)) return -1;
  const unsigned tiles = (unsigned)((n + K3_TILE - 1) / K3_TILE);
  // a region's rows start n elements after the last one's
  const bool vec = aligned16(spk) && ((uintptr_t)bad & 3) == 0 && ((uintptr_t)ok & 3) == 0 && (B == 1 || n % 4 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  const int* s = (const int*)spk;
  const unsigned char* b = (const unsigned char*)bad;
  const dim3 grid(tiles, B);
  if (vec)
    k3_kernel<true><<<grid, K3_THREADS, 0, st>>>(s, b, (int)n, (unsigned char*)ok, (unsigned char*)ovf, (K3Scratch*)scratch);
  else
    k3_kernel<false><<<grid, K3_THREADS, 0, st>>>(s, b, (int)n, (unsigned char*)ok, (unsigned char*)ovf, (K3Scratch*)scratch);
  return (int)cudaGetLastError();
}

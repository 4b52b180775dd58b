// One-pass small-G GROUP BY for Hopper (sm_90a) — the TPC-H Q1 shape.
//
// Replaces the Pallas kernel group_aggregate_dense_pallas
// (tidb_tpu/ops/dense_pallas.py:223, pallas_call at :415). It computes the
// same function: for <= G (<= 32) groups, count(*) plus, per distinct
// (value, null) argument combo (<= 6), the exact wrapping int64 sum and the
// non-null count; groups come out in first-encounter order with group_rep =
// each group's first valid row, and rows of groups ranked >= G are left
// out. Group identity is the primary hash hp (valid rows have bit 63 clear);
// a valid row whose verify hash hv differs from its group's first row
// raises the overflow flag, as does a (G+1)-th distinct key.
//
// Bound on an H100 SXM (3.35 TB/s): memory. One pass must read hp and hv
// (8 + 8 bytes), the row-valid byte, and per combo an int64 value and a
// null byte: N * (17 + 9 * NC) bytes. For Q1 at 2^22 rows (NC = 4) that is
// 222,298,112 B of input, 0.066 ms.
//
// Not a block-by-block copy. The TPU kernel walks a sequential grid, so its
// insert order is the first-encounter order, and it splits int64 values into
// 12-bit limbs (Mosaic has no 64-bit vectors). Hopper's blocks run in no
// order and it adds int64 natively, so K1 is ONE launch of k1_kernel:
//   * persistent blocks (as many as fit on the card: one of 512 threads per
//     SM at Q1's 128 registers) walk 128-row chunks, one per warp, in a
//     grid-stride loop. A lane takes rows 2l, 2l+1, 64+2l, 65+2l of its
//     warp's chunk, so every int64 lane is read with two coalesced 16-B
//     loads and every byte lane with two 2-B loads (a warp instruction
//     covers 512 or 64 contiguous bytes), each input byte once, as
//     streaming loads. Lanes that are views at an element offset take a
//     scalar-load copy of the kernel (the launcher picks it by pointer
//     alignment, nothing is copied), as does the ragged last chunk;
//   * discovery and accumulation are fused and keyed by SLOT: each block
//     keeps a 64-slot open-addressing table in shared memory (atomicCAS on
//     the key) with, per slot, the minimum row, the minimum and maximum hv
//     and 1 + 2 * NC int64 accumulators, so no order pass sits between
//     them. "min hv != max hv" of a used slot is exactly "some valid row's
//     hv differs from its group's first row": the verify check needs no
//     first-row lookup during the pass;
//   * warp pre-aggregation over the whole chunk (128 rows, Q1's six keys:
//     about six groups a chunk, not six per 32 rows): each iteration takes
//     the slot of the lowest lane's first pending row, and every lane
//     folds its up to 4 rows of that slot into partials; count(*) and the
//     non-null counts travel as 8-bit fields of one __reduce_add_sync, a
//     sum as one __reduce_add_sync of 32-bit partials when every value of
//     the chunk lies in [-2^24, 2^24) (Q1's quantity, price and discount),
//     else as three of the 22/21/21-bit pieces of each lane's wrapping
//     64-bit partial, recombined mod 2^64 (bit-exact, wrapping), and the
//     minimum row as one __reduce_min_sync. Each matched row ORs
//     (hv ^ the group's hv) into one word. The group's totals go to
//     registers of the lane that owns the slot (lane l keeps slots l and
//     l + 32): no shared atomics in the loop. That lane also keeps the
//     first hv the warp saw for the slot and compares later ones with it;
//     only at that first sighting (the warp's chunks come in row order, so
//     it also holds the warp's lowest row) does it touch the block's row
//     and hv entries, with a plain read before each atomicMin/atomicMax;
//   * at the end each warp adds its registers into the block's table, the
//     block merges its used slots into a 64-slot table in the scratch (CAS
//     on the key, atomicMax on encoded rows and hv, atomicAdd on the
//     accumulators), fences and counts itself done. The last block ranks
//     the used slots by minimum row (read through L2), writes every output
//     in its final layout (unused groups zeroed) and zeroes the table and
//     the counter for the next call: no second launch, no fill before it
//     and no copy after it.
// More than 64 distinct keys in a block or in the table is overflow (rows
// of keys that found no slot are dropped; the caller keeps only the flag).
// Every sum is order-independent, so the result is deterministic. The
// limbs, the bias, the |v| < 2^46 gate and the row-count bound of the TPU
// kernel are Mosaic artifacts and are gone.
//
// Regions: one launch serves B regions of n rows each (the region-batched
// program's vmap rule), grid (blocks, B): each region takes the blocks a
// single call would, and each region has its own table and done
// counter in its own scratch record, its own last block and its own
// outputs. Nothing crosses a region.
//
// Scratch: one record per region (Scratch below, 8,456 B, padded to
// 8,464), zeroed once when allocated, one buffer per device and stream;
// every launch leaves its records zeroed again. Resources (ptxas -v,
// sm_90a) and times on the card are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 64;
constexpr int MAX_G = 32;
constexpr int MAX_C = 6;
constexpr int ACC = 1 + 2 * MAX_C;  // accumulator stride of a scratch slot
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 128;  // rows a warp takes at a time, 4 a lane
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long TAG = 1ull << 63;  // a stored key is hp | TAG; 0 = empty
constexpr int NO_ROW = 0x7FFFFFFF;

// The table the blocks merge into. Zero is every field's neutral value:
// rows are kept as NO_ROW - row and hv as hv ^ TAG (unsigned order = signed
// order) under atomicMax, the minimum hv as ~(hv ^ TAG).
struct Scratch {
  unsigned long long key[SLOTS];
  unsigned long long acc[SLOTS][ACC];
  unsigned long long hv_hi[SLOTS];
  unsigned long long hv_lo[SLOTS];
  unsigned int row[SLOTS];
  unsigned int flag;
  unsigned int done;
};

// a region's scratch record: sizeof(Scratch) rounded up to 16 bytes
constexpr int SCRATCH_STRIDE = (int)((sizeof(Scratch) + 15) / 16 * 16);

struct Inputs {
  const long long* hp;
  const long long* hv;
  const unsigned char* valid;
  const long long* v[MAX_C];
  const unsigned char* nl[MAX_C];
  long long n;
};

struct Outputs {
  int* group_rep;
  int* n_groups;
  unsigned char* overflow;
  long long* counts;
  long long* sums;
  long long* nns;
  int G;
};

// Find or claim the slot of stored key k (linear probing, shared or global
// table); -1 when the table is full.
__device__ __forceinline__ int slot_of(unsigned long long* keys, unsigned long long k) {
  int s = (int)((k >> 8) & (SLOTS - 1));
  for (int p = 0; p < SLOTS; ++p) {
    const unsigned long long cur = ((volatile unsigned long long*)keys)[s];
    if (cur == k) return s;
    if (cur == 0) {
      const unsigned long long prev = atomicCAS(&keys[s], 0ull, k);
      if (prev == 0 || prev == k) return s;
    }
    s = (s + 1) & (SLOTS - 1);
  }
  return -1;
}

// Row j (0..3) of a lane within its warp's chunk.
__device__ __forceinline__ int row_off(int lane, int j) { return (j < 2 ? 0 : 64) + 2 * lane + (j & 1); }

// A lane's 4 rows: keys, verify hashes, values, and bit masks (bit j = row
// j) of "valid and in range" and, per combo, "not null".
template <int NC>
struct Rows {
  long long hp[4], hv[4], v[NC > 0 ? NC : 1][4];
  unsigned live, nn[NC > 0 ? NC : 1];
};

__device__ __forceinline__ unsigned byte_bits(unsigned short a, unsigned short b) {
  return ((a & 0xFF) ? 1u : 0u) | ((a >> 8) ? 2u : 0u) | ((b & 0xFF) ? 4u : 0u) | ((b >> 8) ? 8u : 0u);
}

// The lane's 4 rows of the chunk at `base`: two 16-B (int64) or 2-B (byte)
// loads per lane on a full chunk of aligned lanes, scalar loads otherwise,
// rows past n not live.
template <int NC, bool VEC>
__device__ __forceinline__ void load_rows(const Inputs& in, long long base, int lane, Rows<NC>& r) {
  if (VEC && base + CHUNK <= in.n) {
    const long long a = base + 2 * lane, b = a + 64;
    const longlong2 hpa = __ldcs((const longlong2*)(in.hp + a)), hpb = __ldcs((const longlong2*)(in.hp + b));
    const longlong2 hva = __ldcs((const longlong2*)(in.hv + a)), hvb = __ldcs((const longlong2*)(in.hv + b));
    r.hp[0] = hpa.x, r.hp[1] = hpa.y, r.hp[2] = hpb.x, r.hp[3] = hpb.y;
    r.hv[0] = hva.x, r.hv[1] = hva.y, r.hv[2] = hvb.x, r.hv[3] = hvb.y;
    r.live = byte_bits(__ldcs((const unsigned short*)(in.valid + a)), __ldcs((const unsigned short*)(in.valid + b)));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const longlong2 va = __ldcs((const longlong2*)(in.v[c] + a)), vb = __ldcs((const longlong2*)(in.v[c] + b));
      r.v[c][0] = va.x, r.v[c][1] = va.y, r.v[c][2] = vb.x, r.v[c][3] = vb.y;
      r.nn[c] = ~byte_bits(__ldcs((const unsigned short*)(in.nl[c] + a)),
                           __ldcs((const unsigned short*)(in.nl[c] + b))) & 15u;
    }
    return;
  }
  r.live = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) r.nn[c] = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = base + row_off(lane, j);
    const bool inb = i < in.n;
    r.hp[j] = inb ? __ldcs(in.hp + i) : 0;
    r.hv[j] = inb ? __ldcs(in.hv + i) : 0;
    if (inb && __ldcs(in.valid + i)) r.live |= 1u << j;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      r.v[c][j] = inb ? __ldcs(in.v[c] + i) : 0;
      if (inb && !__ldcs(in.nl[c] + i)) r.nn[c] |= 1u << j;
    }
  }
}

template <int NC, bool VEC>
__global__ void __launch_bounds__(THREADS) k1_kernel(Inputs in, Outputs out, unsigned char* scratch) {
  constexpr int NA = 1 + 2 * NC;
  // the region this block serves (blockIdx.y): its rows, its outputs and
  // its own scratch record; nothing is shared between regions
  const long long region = blockIdx.y;
  in.hp += region * in.n;
  in.hv += region * in.n;
  in.valid += region * in.n;
#pragma unroll
  for (int c = 0; c < NC; ++c) in.v[c] += region * in.n, in.nl[c] += region * in.n;
  out.group_rep += region * out.G;
  out.n_groups += region;
  out.overflow += region;
  out.counts += region * out.G;
  out.sums += region * NC * out.G;
  out.nns += region * NC * out.G;
  Scratch* sc = reinterpret_cast<Scratch*>(scratch + region * (long long)SCRATCH_STRIDE);
  __shared__ unsigned long long s_key[SLOTS];
  __shared__ unsigned long long s_acc[SLOTS * NA];
  __shared__ long long s_hvmin[SLOTS], s_hvmax[SLOTS];
  __shared__ int s_row[SLOTS], s_gslot[SLOTS];
  __shared__ int s_bad, s_last, s_used;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t < SLOTS) {
    s_key[t] = 0;
    s_row[t] = NO_ROW;
    s_hvmin[t] = 0x7FFFFFFFFFFFFFFFll;
    s_hvmax[t] = (long long)TAG;
  }
  for (int i = t; i < SLOTS * NA; i += THREADS) s_acc[i] = 0;
  if (t == 0) s_bad = 0;
  __syncthreads();

  // the warp's own accumulators, in registers: lane l keeps slots l (lo)
  // and l + 32 (hi); each iteration below adds one group's totals there
  unsigned cnt_lo = 0, cnt_hi = 0, nn_lo[NC > 0 ? NC : 1], nn_hi[NC > 0 ? NC : 1];
  unsigned long long sum_lo[NC > 0 ? NC : 1], sum_hi[NC > 0 ? NC : 1];
#pragma unroll
  for (int c = 0; c < NC; ++c) nn_lo[c] = nn_hi[c] = 0, sum_lo[c] = sum_hi[c] = 0;
  // the owner lane also keeps the first verify hash the warp saw for each
  // of its two slots: the warp's chunks come in row order, so that first
  // sighting also carries the warp's lowest row of the slot
  bool seen_lo = false, seen_hi = false;
  long long ref_lo = 0, ref_hi = 0;
  unsigned long long diff = 0;  // OR of (hv ^ group verify hash): nonzero = mismatch
  bool bad = false;
  const long long chunks = (in.n + CHUNK - 1) / CHUNK;
  for (long long ch = (long long)blockIdx.x * WARPS + warp; ch < chunks; ch += (long long)gridDim.x * WARPS) {
    const long long base = ch * CHUNK;
    Rows<NC> r;
    load_rows<NC, VEC>(in, base, lane, r);
    // the slots of the lane's 4 rows (independent probes); pend: rows not
    // yet added
    int slot[4];
    unsigned pend = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      slot[j] = -1;
      if ((r.live >> j) & 1) slot[j] = slot_of(s_key, (unsigned long long)r.hp[j] | TAG);
      if (slot[j] >= 0) pend |= 1u << j;
      bad |= ((r.live >> j) & 1) && slot[j] < 0;
    }
    // per combo: whether every value of the chunk lies in [-2^24, 2^24), so
    // that a lane's 4-row partial and the warp's total fit 32 bits
    bool small[NC > 0 ? NC : 1];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      bool f = true;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f &= !((pend & r.nn[c]) >> j & 1) || (unsigned long long)(r.v[c][j] + (1ll << 24)) < (1ull << 25);
      small[c] = __all_sync(FULL, f);
    }
    // one group per iteration: the slot of the lowest lane's first pending
    // row, with every row of the chunk that has it
    while (true) {
      const unsigned lanes = __ballot_sync(FULL, pend != 0);
      if (!lanes) break;
      const int lead = __ffs(lanes) - 1;
      const int s0 = (pend & 1) ? slot[0] : (pend & 2) ? slot[1] : (pend & 4) ? slot[2] : slot[3];
      const long long h0 = (pend & 1) ? r.hv[0] : (pend & 2) ? r.hv[1] : (pend & 4) ? r.hv[2] : r.hv[3];
      const int s = __shfl_sync(FULL, s0, lead);
      const long long href = __shfl_sync(FULL, h0, lead);  // the group's verify hash
      unsigned m = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((pend >> j & 1) && slot[j] == s) {
          m |= 1u << j;
          diff |= (unsigned long long)(r.hv[j] ^ href);
        }
      pend &= ~m;
      // count(*) and the non-null counts, as 8-bit fields (<= 128 each)
      unsigned f0 = __popc(m), f1 = 0;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const unsigned k = __popc(m & r.nn[c]);
        if (c < 3)
          f0 |= k << (8 * (c + 1));
        else
          f1 |= k << (8 * (c - 3));
      }
      f0 = __reduce_add_sync(FULL, f0);
      if (NC > 3) f1 = __reduce_add_sync(FULL, f1);
      long long sum[NC > 0 ? NC : 1];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const unsigned mc = m & r.nn[c];
        if (small[c]) {
          int p = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) p += (mc >> j & 1) ? (int)r.v[c][j] : 0;
          sum[c] = (long long)__reduce_add_sync(FULL, p);
        } else {
          // the lane's wrapping partial in three 22/21/21-bit pieces: the
          // warp's piece sums stay below 2^27
          unsigned long long u = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (mc >> j & 1) u += (unsigned long long)r.v[c][j];
          const unsigned p0 = __reduce_add_sync(FULL, (unsigned)(u & 0x3FFFFFull));
          const unsigned p1 = __reduce_add_sync(FULL, (unsigned)(u >> 22 & 0x1FFFFFull));
          const unsigned p2 = __reduce_add_sync(FULL, (unsigned)(u >> 43));
          sum[c] = (long long)((unsigned long long)p0 + ((unsigned long long)p1 << 22) +
                               ((unsigned long long)p2 << 43));
        }
      }
      // rows grow with j within a lane: the lane's first matched row is its lowest
      const unsigned mrow = __reduce_min_sync(FULL, m ? (unsigned)(base + row_off(lane, __ffs(m) - 1)) : 0xFFFFFFFFu);
      if (lane == (s & 31)) {
        const unsigned k = f0 & 0xFF;
        bool first;
        if (s < 32) {
          cnt_lo += k;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            nn_lo[c] += ((c < 3 ? f0 >> (8 * (c + 1)) : f1 >> (8 * (c - 3))) & 0xFF), sum_lo[c] += sum[c];
          first = !seen_lo;
          diff |= seen_lo ? (unsigned long long)(ref_lo ^ href) : 0ull;
          seen_lo = true, ref_lo = first ? href : ref_lo;
        } else {
          cnt_hi += k;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            nn_hi[c] += ((c < 3 ? f0 >> (8 * (c + 1)) : f1 >> (8 * (c - 3))) & 0xFF), sum_hi[c] += sum[c];
          first = !seen_hi;
          diff |= seen_hi ? (unsigned long long)(ref_hi ^ href) : 0ull;
          seen_hi = true, ref_hi = first ? href : ref_hi;
        }
        if (first) {
          if ((int)mrow < ((volatile int*)s_row)[s]) atomicMin(&s_row[s], (int)mrow);
          if (href < ((volatile long long*)s_hvmin)[s]) atomicMin(&s_hvmin[s], href);
          if (href > ((volatile long long*)s_hvmax)[s]) atomicMax(&s_hvmax[s], href);
        }
      }
    }
  }
  // the warp's registers into the block's table
  for (int half = 0; half < 2; ++half) {
    const unsigned k = half ? cnt_hi : cnt_lo;
    if (!k) continue;
    unsigned long long* a = s_acc + (lane + 32 * half) * NA;
    atomicAdd(a, (unsigned long long)k);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      atomicAdd(a + 1 + 2 * c, half ? sum_hi[c] : sum_lo[c]);
      atomicAdd(a + 2 + 2 * c, (unsigned long long)(half ? nn_hi[c] : nn_lo[c]));
    }
  }
  if (bad || diff) s_bad = 1;
  __syncthreads();

  // merge the block's used slots into the scratch table
  if (t < SLOTS) {
    int g = -1;
    const unsigned long long k = s_key[t];
    if (k) {
      g = slot_of(sc->key, k);
      if (g < 0) {
        atomicOr(&sc->flag, 1u);
      } else {
        const unsigned row = (unsigned)(NO_ROW - s_row[t]);
        if (row > ((volatile unsigned*)sc->row)[g]) atomicMax(&sc->row[g], row);
        const unsigned long long hi = (unsigned long long)s_hvmax[t] ^ TAG;
        const unsigned long long lo = ~((unsigned long long)s_hvmin[t] ^ TAG);
        if (hi > ((volatile unsigned long long*)sc->hv_hi)[g]) atomicMax(&sc->hv_hi[g], hi);
        if (lo > ((volatile unsigned long long*)sc->hv_lo)[g]) atomicMax(&sc->hv_lo[g], lo);
      }
    }
    s_gslot[t] = g;
  }
  if (t == 0 && s_bad) atomicOr(&sc->flag, 1u);
  __syncthreads();
  for (int i = t; i < SLOTS * NA; i += THREADS) {
    const int g = s_gslot[i / NA];
    if (g >= 0 && s_acc[i]) atomicAdd(&sc->acc[g][i % NA], s_acc[i]);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&sc->done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block: rank the used slots by minimum row and write the outputs
  __threadfence();
  const int G = out.G;
  if (t < SLOTS) {
    const bool used = __ldcg(&sc->key[t]) != 0;
    s_row[t] = used ? NO_ROW - (int)__ldcg(&sc->row[t]) : NO_ROW;
    s_key[t] = used ? 1ull : 0ull;  // from here on: "scratch slot t is used"
    if (used && __ldcg(&sc->hv_hi[t]) != ~__ldcg(&sc->hv_lo[t])) s_bad = 1;
  }
  if (t == 0 && __ldcg(&sc->flag)) s_bad = 1;
  __syncthreads();
  if (t < SLOTS) {
    int rank = 0, used = 0;
    for (int k = 0; k < SLOTS; ++k) {
      used += (int)s_key[k];
      rank += s_key[k] && s_row[k] < s_row[t];  // min rows are distinct per key
    }
    const int gid = s_key[t] && rank < G ? rank : -1;
    s_gslot[t] = gid;
    if (gid >= 0) out.group_rep[gid] = s_row[t];
    if (t == 0) s_used = used;
  }
  __syncthreads();
  const int ng = s_used < G ? s_used : G;
  for (int i = t; i < SLOTS * NA; i += THREADS) {
    const int gid = s_gslot[i / NA], k = i % NA;
    if (gid < 0) continue;
    const long long v = (long long)__ldcg(&sc->acc[i / NA][k]);
    if (k == 0)
      out.counts[gid] = v;
    else if (k & 1)
      out.sums[(k - 1) / 2 * G + gid] = v;
    else
      out.nns[(k - 2) / 2 * G + gid] = v;
  }
  for (int i = ng + t; i < G; i += THREADS) {
    out.group_rep[i] = 0;
    out.counts[i] = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) out.sums[c * G + i] = out.nns[c * G + i] = 0;
  }
  if (t == 0) {
    *out.n_groups = ng;
    *out.overflow = s_bad || s_used > G;
  }
  __syncthreads();
  // leave the table zeroed for the next launch on this scratch
  unsigned* w = (unsigned*)sc;
  for (int i = t; i < (int)(sizeof(Scratch) / 4); i += THREADS) w[i] = 0;
}

template <int NC, bool VEC>
int launch(const Inputs& in, const Outputs& out, int B, unsigned char* sc, cudaStream_t st) {
  static int per_sm = 0;
  if (!per_sm) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k1_kernel<NC, VEC>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long chunks = (in.n + CHUNK - 1) / CHUNK;
  const long long want = (chunks + WARPS - 1) / WARPS;
  // as many blocks per region as one region would take: a region whose
  // keys make it slow (many groups a chunk) still gets the whole card in
  // its turn, rather than a fixed 1/B share of it
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  k1_kernel<NC, VEC><<<dim3(blocks, B), THREADS, 0, st>>>(in, out, sc);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_nc(int nc, const Inputs& in, const Outputs& out, int B, unsigned char* sc, cudaStream_t st) {
  switch (nc) {
    case 0: return launch<0, VEC>(in, out, B, sc, st);
    case 1: return launch<1, VEC>(in, out, B, sc, st);
    case 2: return launch<2, VEC>(in, out, B, sc, st);
    case 3: return launch<3, VEC>(in, out, B, sc, st);
    case 4: return launch<4, VEC>(in, out, B, sc, st);
    case 5: return launch<5, VEC>(in, out, B, sc, st);
    default: return launch<6, VEC>(in, out, B, sc, st);
  }
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

}  // namespace

// Bytes of one region's record of K1's scratch; a launch over B regions
// takes B records, zeroed when allocated.
extern "C" long long dense_agg_scratch_bytes() { return (long long)SCRATCH_STRIDE; }

// K1 over B regions, one launch on `stream` (grid: blocks x B; the
// counterpart of the region axis that vmap adds to the Pallas grid).
// Inputs, region-major and contiguous: hp, hv int64 [B, n]; valid byte
// [B, n]; vals[c] int64 [B, n] and nulls[c] byte [B, n] for c < nc. Every
// output is written in full (no initialisation needed): group_rep int32
// [B, G], n_groups int32 [B], overflow byte [B], counts int64 [B, G], sums
// and nns int64 [B, nc, G]. scratch: B * dense_agg_scratch_bytes() bytes,
// zeroed when allocated and then kept for every later call on the same
// stream. Returns cudaGetLastError() (0 on success), or -1 for bad
// arguments.
extern "C" int dense_agg_launch(const void* hp, const void* hv, const void* valid, long long n,
                                const void* const* vals, const void* const* nulls, int nc, int G, int B,
                                void* group_rep, void* n_groups, void* overflow, void* counts,
                                void* sums, void* nns, void* scratch, void* stream) {
  if (nc < 0 || nc > MAX_C || G < 1 || G > MAX_G || n < 0 || n >= (1ll << 31)) return -1;
  if (B < 1 || B > 65535) return -1;
  if (!scratch || !aligned(scratch, 16)) return -1;
  Inputs in;
  in.hp = (const long long*)hp;
  in.hv = (const long long*)hv;
  in.valid = (const unsigned char*)valid;
  in.n = n;
  // a region's rows start n elements after the last one's: whole vectors
  // only when n is even
  bool vec = aligned(hp, 16) && aligned(hv, 16) && aligned(valid, 2) && (B == 1 || n % 2 == 0);
  for (int c = 0; c < MAX_C; ++c) {
    in.v[c] = c < nc ? (const long long*)vals[c] : nullptr;
    in.nl[c] = c < nc ? (const unsigned char*)nulls[c] : nullptr;
    if (c < nc) vec = vec && aligned(vals[c], 16) && aligned(nulls[c], 2);
  }
  Outputs out;
  out.group_rep = (int*)group_rep;
  out.n_groups = (int*)n_groups;
  out.overflow = (unsigned char*)overflow;
  out.counts = (long long*)counts;
  out.sums = (long long*)sums;
  out.nns = (long long*)nns;
  out.G = G;
  unsigned char* sc = (unsigned char*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch_nc<true>(nc, in, out, B, sc, st) : launch_nc<false>(nc, in, out, B, sc, st);
}

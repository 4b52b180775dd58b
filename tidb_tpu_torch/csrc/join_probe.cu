// Per-partition probe of the radix-partitioned join for Hopper (sm_90a).
//
// Replaces the Pallas kernel probe_tables_pallas
// (tidb_tpu/ops/join_pallas.py:103, pallas_call at :130). It computes the
// same function: for each partition p and probe slot j, bpos[p, j] = the
// smallest build slot g with b_ok[p, g] and b_key[p, g] == p_key[p, j]
// when p_ok[p, j], else part_cap; and the dup flag = some usable probe slot
// matches more than one usable build slot (the unique-build fan-out check).
// Keys compare as int64: unsigned keys are the same bit patterns.
//
// Bound on an H100 SXM (3.35 TB/s): memory. What the inputs need is every
// ok byte of both sides, the 32-byte key sectors that hold a usable slot,
// and bpos written in full (4 B a slot) — ops/join_probe.py
// probe_tables_bytes counts it. At the radix join's 1:32 plan (4096
// partitions x 128 build x 2048 probe slots, about half the probe slots
// usable, as a prefix of each row) that is about 77 MB, 0.023 ms. The
// compares are a few per usable probe slot, far below the integer rate.
//
// Not a block-by-block copy. The TPU kernel walks the partitions as a
// sequential grid, keeps the build keys in scalar memory as hi/lo int32
// halves (Mosaic has no 64-bit vectors) and unrolls a compare over every
// one of part_cap build slots for every probe slot. Here ONE launch, one
// CTA of 256 threads per partition:
//   * probe loads go out first: a thread owns groups of 4 probe slots (one
//     32-byte key sector; groups i * 256 + t, so a warp's loads are
//     contiguous), reads the 4 ok bytes of each of its groups in one 4-byte
//     load, then starts the 16-byte key loads of every pair that holds a
//     usable slot before anything waits on them. Empty slots' keys are
//     never read. The build side's ok byte and key are loaded beside them;
//   * the build table is an open-addressed hash table in shared memory of
//     2 * pow2(part_cap) entries (<= 512; load factor <= 1/2). Entries are
//     claimed with atomicCAS on a slot word (-1 = empty: any int64 is a
//     valid key, so no key value can mark an empty entry); the home entry
//     is the top bits of a multiplicative hash of the key — not the
//     partition hash (ops/seg.py hash_words), whose low bits are equal
//     for every key of a partition. Inserts race, so chains are in no slot
//     order: a probe walks its chain to the first empty entry, keeps the
//     smallest matching slot and counts the hits (> 1 is dup);
//   * bpos is written with 16-byte streaming stores, part_cap for every
//     unusable slot;
//   * dup: each CTA ORs its bit into a scratch word kept per (device,
//     stream), then takes a ticket; the last CTA moves the word into the
//     0-d output and zeroes the scratch. No fill before the launch and no
//     compare after it: a call is one device operation.
// Tables that are views at an element offset (or rows whose length is not
// a multiple of 4) take a scalar-load copy of the same kernel; the
// launcher picks it by pointer alignment and nothing is copied.
// Measured slower on the card and not kept (PERF.md): a persistent grid
// that loads the next partition during this one's probe, one 2-slot pair a
// load, 8 CTAs an SM at 32 registers, and a table deduplicated after the
// inserts so that a probe stops at its first match.
//
// Regions: one launch probes B regions (the region-batched program's vmap
// rule), grid (n_parts, B): a CTA per (region, partition). A build table
// with no region axis (the broadcast build side of a region batch) is one
// table that every region's CTAs read; each region has its own bpos rows,
// its own dup flag and its own scratch record and ticket.
//
// Scratch: one Scratch record (16 B) per region, zeroed once when
// allocated; every launch leaves its records zeroed again. Resources (ptxas -v) and times on the card are
// in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PART_CAP = 256;
constexpr int MAX_TABLE = 2 * MAX_PART_CAP;  // entries of the shared hash table
constexpr int GROUPS = 2;                    // 4-slot groups a thread loads before it probes
constexpr int STEP = GROUPS * THREADS;       // groups a CTA takes per round
constexpr int EMPTY = -1;

struct Scratch {
  unsigned flag;  // some CTA of this launch saw a fan-out > 1
  unsigned done;  // CTAs finished
  unsigned pad[2];
};

// Home entry of key k in a table of 2^bits entries: the top bits of a
// multiplicative (Fibonacci) hash of the key's two words.
__device__ __forceinline__ int table_home(long long k, int bits) {
  unsigned long long x = (unsigned long long)k;
  x ^= x >> 32;
  x *= 0x9E3779B97F4A7C15ull;
  return (int)(x >> (64 - bits));
}

// One round of a thread's probe slots: GROUPS groups of 4 consecutive slots.
struct Round {
  unsigned ok[GROUPS];   // byte i non-zero: slot i of the group is usable
  long long key[GROUPS][4];
};

__device__ __forceinline__ bool slot_ok(unsigned ok, int i) { return (ok >> (8 * i)) & 0xffu; }

// Start every load of a round: the ok bytes, then the keys of the usable
// slots (VEC: one 4-byte and up to two 16-byte loads a group).
template <bool VEC>
__device__ __forceinline__ void load_round(Round& r, const long long* __restrict__ p_key,
                                           const unsigned char* __restrict__ p_ok, long long prow,
                                           int probe_cap, int ngroups, int g0) {
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const int g = g0 + i * THREADS;
    r.ok[i] = 0;
    if (g >= ngroups) continue;
    const long long s = prow + 4ll * g;
    if (VEC) {
      r.ok[i] = __ldcs((const unsigned*)(p_ok + s));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * g + k < probe_cap && __ldcs(p_ok + s + k)) r.ok[i] |= 1u << (8 * k);
    }
  }
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const long long s = prow + 4ll * (g0 + i * THREADS);
    if (VEC) {
      if (r.ok[i] & 0x0000ffffu) {
        const longlong2 a = __ldcs((const longlong2*)(p_key + s));
        r.key[i][0] = a.x;
        r.key[i][1] = a.y;
      }
      if (r.ok[i] & 0xffff0000u) {
        const longlong2 b = __ldcs((const longlong2*)(p_key + s + 2));
        r.key[i][2] = b.x;
        r.key[i][3] = b.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (slot_ok(r.ok[i], k)) r.key[i][k] = __ldcs(p_key + s + k);
    }
  }
}

// Elements between one region's table and the next, per input: 0 for a
// table that every region shares (a build table with no region axis).
struct Strides {
  long long b_key, b_ok, p_key, p_ok;
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const long long* __restrict__ b_key, const unsigned char* __restrict__ b_ok,
             const long long* __restrict__ p_key, const unsigned char* __restrict__ p_ok,
             int part_cap, int probe_cap, int bits, int* __restrict__ bpos,
             unsigned char* __restrict__ dup_out, Scratch* sc, Strides rs) {
  __shared__ long long s_key[MAX_TABLE];
  __shared__ int s_slot[MAX_TABLE];
  // the region (blockIdx.y): its tables (a shared build table is read by
  // every region), its bpos rows, its dup flag and its own scratch record
  const long long region = blockIdx.y;
  b_key += region * rs.b_key;
  b_ok += region * rs.b_ok;
  p_key += region * rs.p_key;
  p_ok += region * rs.p_ok;
  bpos += region * (long long)gridDim.x * probe_cap;
  dup_out += region;
  sc += region;
  const long long part = blockIdx.x;
  const int t = threadIdx.x;
  const int size = 1 << bits, mask = size - 1;
  const int ngroups = (probe_cap + 3) >> 2;
  const long long prow = part * probe_cap, brow = part * part_cap;

  for (int i = t; i < size; i += THREADS) s_slot[i] = EMPTY;
  // the first round's probe loads and the build slot's loads, in flight together
  Round r;
  load_round<VEC>(r, p_key, p_ok, prow, probe_cap, ngroups, t);
  const bool bok = t < part_cap && b_ok[brow + t];
  const long long bk = bok ? b_key[brow + t] : 0;
  __syncthreads();
  if (bok) {
    int h = table_home(bk, bits);
    while (atomicCAS(&s_slot[h], EMPTY, t) != EMPTY) h = (h + 1) & mask;
    s_key[h] = bk;
  }
  __syncthreads();

  int dup = 0;
  for (int g0 = t;;) {
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      const int g = g0 + i * THREADS;
      int out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int first = part_cap;
        if (slot_ok(r.ok[i], k)) {
          const long long key = r.key[i][k];
          int hits = 0;
          for (int h = table_home(key, bits);; h = (h + 1) & mask) {
            const int s = s_slot[h];
            if (s == EMPTY) break;
            if (s_key[h] == key) {
              first = s < first ? s : first;
              ++hits;
            }
          }
          dup |= hits > 1;
        }
        out[k] = first;
      }
      if (g < ngroups) {
        const long long s = prow + 4ll * g;
        if (VEC) {
          __stcs((int4*)(bpos + s), make_int4(out[0], out[1], out[2], out[3]));
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * g + k < probe_cap) __stcs(bpos + s + k, out[k]);
        }
      }
    }
    g0 += STEP;
    if (g0 - t >= ngroups) break;
    load_round<VEC>(r, p_key, p_ok, prow, probe_cap, ngroups, g0);
  }

  // dup: one OR a CTA, then the last CTA publishes it and resets the scratch
  if (__syncthreads_or(dup) && t == 0) atomicOr(&sc->flag, 1u);
  if (t == 0) {
    __threadfence();
    if (atomicAdd(&sc->done, 1u) == gridDim.x - 1) {
      __threadfence();
      *dup_out = atomicExch(&sc->flag, 0u) != 0;
      atomicExch(&sc->done, 0u);
    }
  }
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

}  // namespace

// Bytes of a region's record of K4's scratch; B records, zeroed once when
// allocated.
extern "C" long long probe_tables_scratch_bytes() { return (long long)sizeof(Scratch); }

// K4 over B regions, one launch on `stream` (grid: n_parts x B). Inputs,
// region-major: b_key int64 [B, n_parts, part_cap], b_ok byte [B, n_parts,
// part_cap], p_key int64 [B, n_parts, probe_cap], p_ok byte [B, n_parts,
// probe_cap]; a build input passed with shared_b_key / shared_b_ok set is
// one [n_parts, part_cap] table read by every region. Outputs, written in
// full: bpos int32 [B, n_parts, probe_cap] and dup (a byte a region).
// scratch: B * probe_tables_scratch_bytes() bytes, zeroed when allocated
// and then kept for every later call on the same stream. Returns
// cudaGetLastError() (0 on success), or -1 for bad arguments.
extern "C" int probe_tables_launch(const void* b_key, const void* b_ok, const void* p_key,
                                   const void* p_ok, int n_parts, int part_cap, int probe_cap, int B,
                                   int shared_b_key, int shared_b_ok, void* bpos, void* dup, void* scratch,
                                   void* stream) {
  if (n_parts < 1 || part_cap < 1 || part_cap > MAX_PART_CAP || probe_cap < 1) return -1;
  if ((long long)n_parts * probe_cap >= (1ll << 31) || B < 1 || B > 65535) return -1;
  if (!scratch || !aligned(scratch, 16)) return -1;
  int bits = 1;
  while ((1 << bits) < 2 * part_cap) ++bits;
  const bool vec = probe_cap % 4 == 0 && aligned(p_key, 16) && aligned(p_ok, 4) && aligned(bpos, 16);
  cudaStream_t st = (cudaStream_t)stream;
  const long long* bk = (const long long*)b_key;
  const unsigned char* bo = (const unsigned char*)b_ok;
  const long long* pk = (const long long*)p_key;
  const unsigned char* po = (const unsigned char*)p_ok;
  Scratch* sc = (Scratch*)scratch;
  Strides rs;
  rs.b_key = shared_b_key ? 0 : (long long)n_parts * part_cap;
  rs.b_ok = shared_b_ok ? 0 : (long long)n_parts * part_cap;
  rs.p_key = rs.p_ok = (long long)n_parts * probe_cap;
  const dim3 grid(n_parts, B);
  if (vec)
    probe_kernel<true><<<grid, THREADS, 0, st>>>(bk, bo, pk, po, part_cap, probe_cap, bits, (int*)bpos,
                                                 (unsigned char*)dup, sc, rs);
  else
    probe_kernel<false><<<grid, THREADS, 0, st>>>(bk, bo, pk, po, part_cap, probe_cap, bits, (int*)bpos,
                                                  (unsigned char*)dup, sc, rs);
  return (int)cudaGetLastError();
}

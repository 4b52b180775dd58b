// Per-partition probe of the radix-partitioned join for Hopper (sm_90a).
//
// Replaces the Pallas kernel probe_tables_pallas
// (tidb_tpu/ops/join_pallas.py:103, pallas_call at :130). It computes the
// same function: for each partition p and probe slot j, bpos[p, j] = the
// smallest build slot g with b_ok[p, g] and b_key[p, g] == p_key[p, j]
// when p_ok[p, j], else part_cap; and the dup flag = some usable probe slot
// matches more than one usable build slot (the unique-build fan-out check).
//
// Not a block-by-block copy. The TPU kernel walks the partitions as a
// sequential grid, keeps the build keys in scalar memory as hi/lo int32
// halves (Mosaic has no 64-bit vectors) and unrolls a compare over every
// one of part_cap build slots for every probe slot. Here one CTA of 256
// threads takes one partition:
//   * the partition's usable build slots are compacted, in ascending slot
//     order, into shared memory (warp ballots give each its position), so
//     the first hit in the compacted list is the smallest slot;
//   * threads stride over the probe slots (neighbouring threads on
//     neighbouring slots, so loads and stores coalesce); an unusable slot
//     writes part_cap at once; a usable one compares its int64 key with
//     every usable build key (a shared-memory broadcast), keeping the first
//     hit and counting hits;
//   * dup is one __syncthreads_or and one atomicOr per CTA.
// Keys compare as int64: unsigned keys are the same bit patterns.
//
// Bound on an H100 SXM (3.35 TB/s): memory. At the radix join's 1:32 plan
// (4096 partitions x 2048 probe slots x 128 build slots) the kernel must
// read the probe tables (8 B key + 1 B ok a slot) and the build tables, and
// write bpos (4 B a slot): ~0.11 GB, ~34 us. The compares this run's data
// needs — usable probe slots x usable build slots per partition, ~1.3e8
// for 2^22 probe rows against 2^17 build rows — are far from the integer
// rate. The empty probe slots (about half of them) are still read and
// written; skipping them and warp-cooperative compares are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PART_CAP = THREADS;

__global__ void __launch_bounds__(THREADS)
probe_kernel(const long long* __restrict__ b_key, const unsigned char* __restrict__ b_ok,
             const long long* __restrict__ p_key, const unsigned char* __restrict__ p_ok,
             int part_cap, int probe_cap, int* __restrict__ bpos, int* flag) {
  __shared__ long long keys[MAX_PART_CAP];
  __shared__ int slot[MAX_PART_CAP];
  __shared__ int warp_off[WARPS + 1];
  const long long part = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;

  // compact the usable build slots, keeping their order
  const long long brow = part * part_cap;
  const bool ok = t < part_cap && b_ok[brow + t];
  const unsigned ballot = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) warp_off[w] = __popc(ballot);
  __syncthreads();
  if (t == 0) {
    int acc = 0;
    for (int k = 0; k < WARPS; ++k) {
      const int c = warp_off[k];
      warp_off[k] = acc;
      acc += c;
    }
    warp_off[WARPS] = acc;
  }
  __syncthreads();
  if (ok) {
    const int pos = warp_off[w] + __popc(ballot & ((1u << lane) - 1u));
    keys[pos] = b_key[brow + t];
    slot[pos] = t;
  }
  __syncthreads();

  const int m = warp_off[WARPS];
  const long long prow = part * probe_cap;
  int dup = 0;
  for (int j = t; j < probe_cap; j += THREADS) {
    int first = part_cap;
    if (p_ok[prow + j]) {
      const long long k = p_key[prow + j];
      int hits = 0;
      for (int s = 0; s < m; ++s) {
        if (keys[s] == k) {
          if (hits == 0) first = slot[s];
          ++hits;
        }
      }
      dup |= hits > 1;
    }
    bpos[prow + j] = first;
  }
  if (__syncthreads_or(dup) && t == 0) atomicOr(flag, 1);
}

}  // namespace

// bpos int32[P * probe_cap] is written in full; flag int32[1] = 0.
// Returns cudaGetLastError(), or -1 for bad arguments.
extern "C" int probe_tables_launch(const void* b_key, const void* b_ok, const void* p_key,
                                   const void* p_ok, int n_parts, int part_cap, int probe_cap,
                                   void* bpos, void* flag, void* stream) {
  if (n_parts < 1 || part_cap < 1 || part_cap > MAX_PART_CAP || probe_cap < 1) return -1;
  probe_kernel<<<n_parts, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)b_key, (const unsigned char*)b_ok, (const long long*)p_key,
      (const unsigned char*)p_ok, part_cap, probe_cap, (int*)bpos, (int*)flag);
  return (int)cudaGetLastError();
}

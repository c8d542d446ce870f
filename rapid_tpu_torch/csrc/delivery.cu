// Alert delivery for the virtual-cluster engine, written for Hopper (sm_90a).
//
// Replaces rapid_tpu/ops/pallas_kernels.py::delivery_new_bits_pallas (the
// Mosaic kernel, body _delivery_kernel). Function: for each receiver cohort
// c, slot s and ring r, draw a delivery delay from a hash of (c, s, r, epoch)
// and set bit r of out[c, s] iff age[r, s] >= delay and cohort c is not
// blocked from the edge's observer (bit c%32 of blocked[(c/32)*k + r, s]).
// Its plain PyTorch version, bit for bit, is
// rapid_tpu_torch/ops/kernels.py::delivery_new_bits_ref. A fleet of t
// independent clusters is one call: every input gains a leading tenant axis
// and each tenant salts its draws with its own epoch (one cluster: t = 1).
// A shard of a sharded cluster is one call on its local columns and cohort
// rows: the draws are salted with the global slot (slot_offset + local
// column) and the global cohort (cohort_offset + local row), so every shard
// draws the delays the whole cluster would. The layout and the grid stay
// over the local n and c.
//
// What bounds it. Bytes: each input read once and the output written
// once, 38.5 MB at the churn shape (t=1, c=64, k=10, n=102,500), 11.5 us
// at 3.35 TB/s, and 29.9 MB at the fleet shape (t=256, c=8, n=1,044),
// 8.9 us. Operations: only the draws the inputs need. An edge's output
// depends on its hash draw only when it is unblocked and its age lies in
// [0, maxdelay): below 0 nothing is delivered whatever the draw, at or
// above maxdelay (the largest delay) everything unblocked is. On the
// engine's paths 0.06-1.2% of (cohort, slot, ring) edges need one, so the
// bound is the bytes. The kernel reaches 66-74% of it in mode 0 (no draws)
// at both shapes, cold (NVIDIA H100 80GB HBM3, 700 W; PERF.md). With draws
// it is bound by their latency, not by issue or occupancy (register caps
// and larger blocks changed nothing): a warp runs its draw passes one
// after another, and on the churn the join wave's contiguous new slots
// give a few warps ~32 owners with ~10 pending rings each, a chain of ~320
// draws that sets the launch's length (~17 of its ~38 us).
//
// The design, against what held the first version back:
// 1. Inputs were re-read once per cohort (one thread per (cohort, slot)).
//    Now one thread owns a (tenant, cohort word, slot), loads the k
//    blocked words and k ages once into registers, and writes the up-to-32
//    cohorts of its word, every load and store coalesced along slots.
//    16-byte groups of 4 slots a thread were built and measured: slower
//    than one slot a thread in mode 0 (churn 19.0 against 16.3 us, fleet
//    7.3 against 6.8), and their staging tile would not fit, so they went.
// 2. The remainder by a runtime divisor (spread + 1, spread) was nvcc's
//    generic unsigned modulus. Now it is Lemire's fastmod: a multiply by
//    m = ceil(2^64 / d), computed once on the host, and a 64 x 32 multiply-
//    high, exact for every 32-bit input (d = 1 gives m = 0 and 0). The
//    % 1000 of the gate is a constant and stays one.
// 3. The ring loop ran on a runtime k with a multiply for each ring salt.
//    Now K is a template parameter (10, the engine's value, plus a generic
//    instance for 1 <= k <= 32 that unrolls to 32 and zeroes the rings past
//    k): every loop is unrolled and every salt a constant.
// 4. Every draw was made. Now the ages give two ring masks per slot,
//    matured (age >= maxdelay) and pending (0 <= age < maxdelay, heard by
//    some cohort of the word); a cohort's k unblocked bits u are gathered
//    from the k words by a constant shift and one LOP3 per ring, and its
//    output is (u & matured) OR-ed with draws for the pending rings only.
//    Mode 0 (maxdelay 0) draws nothing. The draws are shared by the warp
//    (phase B below): a lane-per-slot loop ran a warp at the pace of its
//    busiest lane, and scattered atomics to merge the draws cost a 32-byte
//    sector per 4-byte word, so the draws land in a shared-memory tile
//    and every output word is stored once.
// 5. The 3-D grid (256-thread blocks along slots, cohorts on y, tenants on
//    z) left most threads of the last block of every row idle at n=1,044.
//    Now the grid is 1-D over (tenant, word, slot), so only the last block
//    of the launch is ragged.
//
// 6. The Pallas kernel's lane tile (``EngineConfig.pallas_lanes``: slots a
//    grid step covers, a positive multiple of 128) is a launch argument.
//    A block keeps 128 threads and covers `lanes` consecutive thread
//    indices, lanes / 128 per thread in a loop, so the grid has
//    ceil(threads / lanes) blocks. Shared memory and registers stay those
//    of one 128-thread block, and at lanes = 128 this is the kernel as it
//    was. Each thread index is computed as it would be at any width, and
//    the draws are salted by global slot and cohort, so every width writes
//    the same words.
//
// No tensor-core or TMA path applies: there is no product to feed wgmma,
// and every tile is one row of 4-byte words read once, which coalesced
// loads already stream at the memory's rate without staging in shared
// memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kCohortSalt = 0x9E3779B1u;
constexpr uint32_t kSlotSalt = 0x85EBCA77u;
constexpr uint32_t kEpochSalt = 0x27D4EB2Fu;
constexpr uint32_t kRingSalt = 0xC2B2AE3Du;
constexpr uint32_t kGateSalt = 0xA511E9B3u;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// x % d for every 32-bit x, with m = ceil(2^64 / d) mod 2^64 from the host:
// the high word of (m * x mod 2^64) * d, as one 32 x 32 -> 64 multiply per
// half of the low product.
__device__ __forceinline__ uint32_t fastmod(uint32_t x, uint64_t m, uint32_t d) {
  const uint64_t low = m * x;
  const uint64_t lo_part = (static_cast<uint64_t>(static_cast<uint32_t>(low)) * d) >> 32;
  const uint64_t hi_part = static_cast<uint64_t>(static_cast<uint32_t>(low >> 32)) * d;
  return static_cast<uint32_t>((hi_part + lo_part) >> 32);
}

// Whether a pending edge (0 <= age < spread) is delivered.
// MODE 1: delay = rnd % (spread + 1).
// MODE 2: delay = 1 + rnd % spread with probability permille / 1000, gated
//         by a second hash stream; else 0.
template <int MODE>
__device__ __forceinline__ bool draw_delivers(uint32_t rnd, int32_t age, uint64_t m, uint32_t d,
                                              uint32_t permille) {
  if (MODE == 1) return age >= static_cast<int32_t>(fastmod(rnd, m, d));
  const bool gate = mix32(rnd ^ kGateSalt) % 1000u < permille;
  return !gate || age >= 1 + static_cast<int32_t>(fastmod(rnd, m, d));
}

// One (tenant, cohort word, slot) thread index of the launch, `gidx`.
template <int K, int MODE>
__device__ __forceinline__ void deliver_thread(
    const uint32_t* __restrict__ blocked, const int32_t* __restrict__ age,
    const uint32_t* __restrict__ epoch, uint32_t* __restrict__ out, uint32_t threads,
    uint32_t words, int n, int k_rt, int c, int32_t maxdelay, uint32_t d, uint64_t m,
    uint32_t permille, uint32_t lanes_per_slot, uint32_t slot_offset, uint32_t cohort_offset,
    uint32_t gidx) {
  constexpr int KR = K ? K : 32;
  // Lanes past the last thread stay for the warp's collectives; they load
  // the last thread's inputs and store nothing. (The wrapper keeps
  // t * words * n below 2^31.)
  const bool valid = gidx < threads;
  const uint32_t idx = min(gidx, threads - 1);
  const uint32_t slot = idx % static_cast<uint32_t>(n);
  const uint32_t row = idx / static_cast<uint32_t>(n);
  const uint32_t word = row % words;
  const uint32_t tenant = row / words;
  const int k = K ? K : k_rt;
  // Row numbers fit in 32 bits (t <= 65535, w and k <= 32, c <= 1024), so
  // each offset is one 32 x 32 -> 64-bit multiply by n.
  const uint32_t* brow = blocked + static_cast<size_t>((tenant * words + word) * k) * n + slot;
  const int32_t* arow = age + static_cast<size_t>(tenant * k) * n + slot;

  // Unblocked bits (cohorts of this word, others cleared) and ages of every
  // ring, once.
  const uint32_t cohort0 = word * 32u;
  const int cohorts = min(32, c - static_cast<int>(cohort0));
  const uint32_t cohort_bits = cohorts == 32 ? ~0u : (1u << cohorts) - 1u;
  uint32_t unblocked[KR];
  int32_t ages[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const bool ring = K || r < k;
    unblocked[r] = ring ? ~brow[static_cast<size_t>(r) * n] & cohort_bits : 0u;
    ages[r] = ring ? arow[static_cast<size_t>(r) * n] : 0;
  }
  // Ring masks: matured (age >= maxdelay) and pending (0 <= age <
  // maxdelay, heard by some cohort of the word).
  uint32_t matured = 0, pending = 0;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    matured |= static_cast<uint32_t>(ages[r] >= maxdelay) << r;
    if (MODE != 0)
      pending |= static_cast<uint32_t>(ages[r] >= 0 && ages[r] < maxdelay && unblocked[r] != 0) << r;
  }

  // Phase B (draw modes): the draws, shared by the warp. Each pass takes the
  // next 32 / lanes_per_slot lanes of the warp with a pending ring
  // ("owners"); lane j of an owner's lanes draws for cohort j of the
  // owner's word, with the owner's ring words and ages shuffled from it,
  // and leaves the delivered bits in the warp's staging tile at (j, owner).
  // A slot with pending rings thus costs the warp its pending rings' draws
  // once, whichever lane holds it.
  __shared__ uint32_t staged[MODE != 0 ? kThreads / 32 : 1][MODE != 0 ? 32 * 33 : 1];
  const uint32_t lane = threadIdx.x & 31u;
  if constexpr (MODE != 0) {
    constexpr uint32_t kAll = 0xFFFFFFFFu;
    uint32_t* tile = staged[threadIdx.x / 32];
    const uint32_t pair = lane / lanes_per_slot, j = lane % lanes_per_slot;
    const uint32_t pairs_per_pass = 32u / lanes_per_slot;
    const uint32_t slot_term = ((slot_offset + slot) * kSlotSalt) ^ (epoch[tenant] * kEpochSalt);
    const uint32_t salt_cohort0 = cohort_offset + cohort0;
    uint32_t owners = __ballot_sync(kAll, valid && pending != 0);
    while (owners) {
      uint32_t mine = owners;
      for (uint32_t i = 0; i < pair; ++i) mine &= mine - 1;
      const int src = mine ? __ffs(mine) - 1 : static_cast<int>(lane);
      for (uint32_t i = 0; i < pairs_per_pass; ++i) owners &= owners - 1;
      const uint32_t p = __shfl_sync(kAll, pending, src) & (mine ? kAll : 0u);
      const uint32_t p_any = __reduce_or_sync(kAll, p);
      const uint32_t base =
          ((__shfl_sync(kAll, salt_cohort0, src) + j) * kCohortSalt) ^ __shfl_sync(kAll, slot_term, src);
      uint32_t bits = 0;
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        if ((p_any >> r) & 1u) {
          const uint32_t w = __shfl_sync(kAll, unblocked[r], src);
          const int32_t a = __shfl_sync(kAll, ages[r], src);
          const uint32_t rnd = mix32(base ^ (static_cast<uint32_t>(r) * kRingSalt));
          const uint32_t hit = (p >> r) & (w >> j) & 1u &
                               static_cast<uint32_t>(draw_delivers<MODE>(rnd, a, m, d, permille));
          bits |= hit << r;
        }
      }
      if (mine) tile[j * 33 + src] = bits;
    }
    __syncwarp();
  }

  // Phase A, unrolled: every output word of the thread, u & matured OR-ed
  // with its staged draws, stored once, coalesced along slots.
  uint32_t* orow = out + static_cast<size_t>(tenant * c + cohort0) * n + slot;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j >= cohorts) break;
    // Bit r of u: cohort cohort0 + j hears ring r's observer.
    uint32_t u = 0;
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      const uint32_t w = unblocked[r];
      u |= (r >= j ? w << (r - j) : w >> (j - r)) & (1u << r);
    }
    uint32_t o = u & matured;
    if (MODE != 0 && pending != 0) o |= staged[threadIdx.x / 32][j * 33 + lane];
    if (valid) orow[static_cast<size_t>(j) * n] = o;
  }
}

// A block of 128 threads per `lanes` (tenant, cohort word, slot) thread
// indices. K = 0 is the generic instance: rings up to 32, those at or past
// k zeroed. MODE 0: spread == 0, every delay is 0 (nothing pending).
template <int K, int MODE>
__global__ void __launch_bounds__(kThreads)
    delivery_new_bits_kernel(const uint32_t* __restrict__ blocked, const int32_t* __restrict__ age,
                             const uint32_t* __restrict__ epoch, uint32_t* __restrict__ out,
                             uint32_t threads, uint32_t words, int n, int k_rt, int c,
                             int32_t maxdelay, uint32_t d, uint64_t m, uint32_t permille,
                             uint32_t lanes_per_slot, uint32_t slot_offset,
                             uint32_t cohort_offset, uint32_t lanes) {
  // The block's tile: `lanes` thread indices from blockIdx.x * lanes, 128
  // at a time (the loop's bounds are the block's, so warps stay whole).
  const uint32_t tile0 = blockIdx.x * lanes;
  for (uint32_t step = 0; step < lanes && tile0 + step < threads; step += kThreads) {
    deliver_thread<K, MODE>(blocked, age, epoch, out, threads, words, n, k_rt, c, maxdelay, d, m,
                            permille, lanes_per_slot, slot_offset, cohort_offset,
                            tile0 + step + threadIdx.x);
    // The next index's draws reuse the warp's staging tile.
    __syncwarp();
  }
}

template <int K, int MODE>
void launch(const uint32_t* b, const int32_t* a, const uint32_t* e, uint32_t* o, int t, int n,
            int k, int c, int spread, int permille, uint32_t d, unsigned long long m,
            int slot_offset, int cohort_offset, int lanes, cudaStream_t s) {
  const uint32_t words = (static_cast<uint32_t>(c) + 31u) / 32u;
  const uint32_t threads = static_cast<uint32_t>(t) * words * static_cast<uint32_t>(n);
  const uint32_t tile = static_cast<uint32_t>(lanes);
  const dim3 grid((threads + tile - 1) / tile);
  uint32_t lanes_per_slot = 1;  // the power of two that covers one word's cohorts
  while (lanes_per_slot < static_cast<uint32_t>(c < 32 ? c : 32)) lanes_per_slot <<= 1;
  delivery_new_bits_kernel<K, MODE><<<grid, kThreads, 0, s>>>(
      b, a, e, o, threads, words, n, k, c, spread, d, m, static_cast<uint32_t>(permille),
      lanes_per_slot, static_cast<uint32_t>(slot_offset), static_cast<uint32_t>(cohort_offset), tile);
}

}  // namespace

// blocked: [t, w*k, n] uint32, w = ceil(c / 32); age: [t, k, n] int32;
// epoch: [t] uint32 (device memory, so the caller never reads it back);
// out: [t, c, n] uint32. m: ceil(2^64 / d) mod 2^64 for the launch's
// divisor d (spread + 1 when permille >= 1000, else spread; unused when
// spread == 0). slot_offset / cohort_offset: the global slot of local column
// 0 and the global cohort of local row 0 (0 and 0 for a whole cluster).
// lanes: the thread indices a block covers (the Pallas lane tile), a
// positive multiple of 128; any other value launches nothing and returns
// cudaErrorInvalidValue. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rapid_delivery_new_bits(const void* blocked, const void* age, const void* epoch,
                                       void* out, int t, int n, int k, int c, int spread,
                                       int permille, int slot_offset, int cohort_offset,
                                       int lanes, unsigned long long m, void* stream) {
  if (lanes <= 0 || lanes % kThreads != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint32_t*>(blocked);
  auto a = static_cast<const int32_t*>(age);
  auto e = static_cast<const uint32_t*>(epoch);
  auto o = static_cast<uint32_t*>(out);
  const uint32_t sp = static_cast<uint32_t>(spread);
  const int so = slot_offset, co = cohort_offset;
  if (spread == 0) {
    (k == 10 ? launch<10, 0> : launch<0, 0>)(b, a, e, o, t, n, k, c, spread, permille, 1u, m, so, co, lanes, s);
  } else if (permille >= 1000) {
    (k == 10 ? launch<10, 1> : launch<0, 1>)(b, a, e, o, t, n, k, c, spread, permille, sp + 1u, m, so, co, lanes, s);
  } else {
    (k == 10 ? launch<10, 2> : launch<0, 2>)(b, a, e, o, t, n, k, c, spread, permille, sp, m, so, co, lanes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

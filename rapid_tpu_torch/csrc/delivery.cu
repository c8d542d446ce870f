// Alert delivery for the virtual-cluster engine, written for Hopper (sm_90a).
//
// Replaces rapid_tpu/ops/pallas_kernels.py::delivery_new_bits_pallas (the
// Mosaic kernel, body _delivery_kernel). Function: for each receiver cohort
// c, slot s and ring r, draw a delivery delay from a hash of (c, s, r, epoch)
// and set bit r of out[c, s] iff age[r, s] >= delay and cohort c is not
// blocked from the edge's observer (bit c%32 of blocked[(c/32)*k + r, s]).
// Its plain PyTorch version, bit for bit, is
// rapid_tpu_torch/ops/kernels.py::delivery_new_bits_ref.
//
// A fleet of t independent clusters is one call: every input gains a
// leading tenant axis, each tenant salts its draws with its own epoch, and
// the tenants ride gridDim.z. A one-cluster call is t = 1.
//
// What bounds it: integer issue, not memory. At the headline shape
// (c=64, k=10, n=102,500) it moves about 38.5 MB (blocked words, ages, the
// [c, n] output) but makes 65.6 M (cohort, slot, ring) draws of roughly
// 18-31 integer operations each (one or two mix32 finalizers, an unsigned
// modulus, compares). At the fleet shape (t=256, c=8, k=10, n=1,044) it
// moves 29.9 MB, 8.9 us at 3.35 TB/s, and makes 21.4 M draws, 385 M
// operations at 18 each, 23 us of int32 issue: integer issue again.
// What the design does about it:
// - one thread per output word (cohort, slot), threads laid along slots so
//   every load and the store coalesce; blockIdx.y walks cohorts, so the 32
//   cohorts of one blocked word read the same line from L1/L2 and device
//   memory sees each input about once;
// - the K rings loop inside the thread and the (cohort, slot, epoch) part
//   of the hash is computed once per thread, not per ring;
// - the three delay modes are template instances, so the ring loop carries
//   no mode branch and compiles to straight-line integer code;
// - the [c, n] output is written directly (no [32*w, n] pad and slice) and
//   the ragged slot edge is masked, not padded.
// The TPU version's layout (32 cohorts on sublanes, slots on 128-wide lanes,
// a sequential grid over slot tiles) is not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// MODE 0: spread == 0, every delay is 0.
// MODE 1: permille >= 1000, delay = rnd % (spread + 1).
// MODE 2: otherwise, delay = 1 + rnd % spread with probability
//         permille / 1000, gated by a second hash stream; else 0.
template <int MODE>
__global__ void delivery_new_bits_kernel(const uint32_t* __restrict__ blocked,
                                         const int32_t* __restrict__ age,
                                         const uint32_t* __restrict__ epoch,
                                         uint32_t* __restrict__ out, int n, int k, int c,
                                         uint32_t spread, uint32_t permille) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= n) return;
  const uint32_t cohort = blockIdx.y;
  const uint32_t tenant = blockIdx.z;
  const uint32_t words = (static_cast<uint32_t>(c) + 31u) / 32u;
  const uint32_t bit = cohort & 31u;
  // Row numbers fit in 32 bits (t <= 65535, w and k <= 32, c <= 1024), so
  // each offset is one 32 x 32 -> 64-bit multiply by n.
  const uint32_t* brow =
      blocked + static_cast<size_t>((tenant * words + (cohort >> 5)) * k) * n + slot;
  const int32_t* arow = age + static_cast<size_t>(tenant * k) * n + slot;
  const uint32_t base = (cohort * 0x9E3779B1u) ^ (static_cast<uint32_t>(slot) * 0x85EBCA77u) ^
                        (epoch[tenant] * 0x27D4EB2Fu);
  uint32_t acc = 0;
  for (int ring = 0; ring < k; ++ring) {
    const uint32_t b = (brow[static_cast<size_t>(ring) * n] >> bit) & 1u;
    const int32_t a = arow[static_cast<size_t>(ring) * n];
    int32_t delay = 0;
    if (MODE != 0) {
      const uint32_t rnd = mix32(base ^ (static_cast<uint32_t>(ring) * 0xC2B2AE3Du));
      if (MODE == 1) {
        delay = static_cast<int32_t>(rnd % (spread + 1u));
      } else {
        const bool gate = (mix32(rnd ^ 0xA511E9B3u) % 1000u) < permille;
        delay = gate ? 1 + static_cast<int32_t>(rnd % spread) : 0;
      }
    }
    acc |= static_cast<uint32_t>((a >= delay) & (b == 0u)) << ring;
  }
  out[static_cast<size_t>(tenant * c + cohort) * n + slot] = acc;
}

}  // namespace

// blocked: [t, w*k, n] uint32, w = ceil(c / 32); age: [t, k, n] int32;
// epoch: [t] uint32 (device memory, so the caller never reads it back);
// out: [t, c, n] uint32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rapid_delivery_new_bits(const void* blocked, const void* age, const void* epoch,
                                       void* out, int t, int n, int k, int c, int spread,
                                       int permille, void* stream) {
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads, c, t);
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint32_t*>(blocked);
  auto a = static_cast<const int32_t*>(age);
  auto e = static_cast<const uint32_t*>(epoch);
  auto o = static_cast<uint32_t*>(out);
  const uint32_t sp = static_cast<uint32_t>(spread), pm = static_cast<uint32_t>(permille);
  if (spread == 0) {
    delivery_new_bits_kernel<0><<<grid, threads, 0, s>>>(b, a, e, o, n, k, c, sp, pm);
  } else if (permille >= 1000) {
    delivery_new_bits_kernel<1><<<grid, threads, 0, s>>>(b, a, e, o, n, k, c, sp, pm);
  } else {
    delivery_new_bits_kernel<2><<<grid, threads, 0, s>>>(b, a, e, o, n, k, c, sp, pm);
  }
  return static_cast<int>(cudaGetLastError());
}

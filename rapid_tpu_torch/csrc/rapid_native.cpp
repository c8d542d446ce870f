// Native host-runtime components: XXH64 and batch ring-key construction.
//
// The host side of the framework hashes every endpoint K times to build the
// ring permutations (semantics of MembershipView.AddressComparator,
// MembershipView.java:562-587). At 100K endpoints x K=10 rings that is 1M+
// seeded hashes on the bootstrap path; this C library computes them at memory
// bandwidth. Exposed through ctypes (rapid_tpu/utils/_native.py) with a
// pure-Python fallback producing bit-identical values.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t round1(uint64_t acc, uint64_t lane) {
  acc += lane * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  acc ^= round1(0, val);
  return acc * P1 + P4;
}

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86-64 / aarch64-le)
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t avalanche(uint64_t h) {
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

uint64_t xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;

  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2;
    uint64_t v2 = seed + P2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round1(v1, read64(p));
      v2 = round1(v2, read64(p + 8));
      v3 = round1(v3, read64(p + 16));
      v4 = round1(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }

  h += len;

  while (p + 8 <= end) {
    h ^= round1(0, read64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  return avalanche(h);
}

inline uint64_t xxh64_int(int64_t value, uint64_t seed) {
  uint8_t buf[8];
  std::memcpy(buf, &value, 8);
  return xxh64(buf, 8, seed);
}

}  // namespace

extern "C" {

uint64_t rapid_xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
  return xxh64(data, len, seed);
}

// Ring key for one endpoint on one ring:
//   xxh64(hostname, seed) * 31 + xxh64(le64(port), seed)
// (semantics of AddressComparator.computeHash, MembershipView.java:579-582).
uint64_t rapid_ring_key(const uint8_t* hostname, uint64_t hostname_len,
                        int32_t port, uint64_t seed) {
  return xxh64(hostname, hostname_len, seed) * 31ULL +
         xxh64_int(static_cast<int64_t>(port), seed);
}

// Batch ring keys for n endpoints x k rings. Hostnames are packed into one
// blob with offsets[i]..offsets[i+1] delimiting endpoint i's hostname bytes.
// out is row-major [k, n].
void rapid_ring_keys_batch(const uint8_t* blob, const uint64_t* offsets,
                           const int32_t* ports, uint64_t n, uint32_t k,
                           uint64_t* out) {
  for (uint32_t ring = 0; ring < k; ++ring) {
    const uint64_t seed = ring;
    uint64_t* row = out + static_cast<uint64_t>(ring) * n;
    for (uint64_t i = 0; i < n; ++i) {
      const uint8_t* host = blob + offsets[i];
      const uint64_t len = offsets[i + 1] - offsets[i];
      row[i] = xxh64(host, len, seed) * 31ULL +
               xxh64_int(static_cast<int64_t>(ports[i]), seed);
    }
  }
}

// Configuration-id fold (semantics of Configuration.getConfigurationId,
// MembershipView.java:544-556): hash = hash*37 + xxh64(field) over sorted
// node ids then ring-0-ordered endpoints.
uint64_t rapid_configuration_id(const uint64_t* id_high, const uint64_t* id_low,
                                uint64_t n_ids, const uint8_t* blob,
                                const uint64_t* offsets, const int32_t* ports,
                                uint64_t n_endpoints) {
  uint64_t h = 1;
  for (uint64_t i = 0; i < n_ids; ++i) {
    h = h * 37 + xxh64_int(static_cast<int64_t>(id_high[i]), 0);
    h = h * 37 + xxh64_int(static_cast<int64_t>(id_low[i]), 0);
  }
  for (uint64_t i = 0; i < n_endpoints; ++i) {
    h = h * 37 + xxh64(blob + offsets[i], offsets[i + 1] - offsets[i], 0);
    h = h * 37 + xxh64_int(static_cast<int64_t>(ports[i]), 0);
  }
  return h;
}

}  // extern "C"

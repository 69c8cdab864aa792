// Kernel H: murmur3-32 of each canonical 46-byte timestamp string
// `YYYY-MM-DDTHH:mm:ss.sssZ-CCCC-<16 hex>` (counter hex upper case, node
// hex lower case), plus the batch XOR digest.
//
// Replaces evolu_tpu/ops/pallas_hash.py::_hash_kernel (pallas_call in
// _hash_blocks). The TPU kernel takes six pre-split 32-bit planes because
// Pallas on the TPU has no 64-bit vectors; here one thread renders and
// hashes one row straight from 64-bit inputs, the string bytes never
// leave registers. On the reconcile path it starts from the SORTED HLC
// keys (millis = k1 >> 16, counter = k1 & 0xFFFF, node = k2) and the xor
// mask, writes `hash if xor else 0` (fusing unpack_ts_keys and the select
// at evolu_tpu/parallel/reconcile.py:140-143), and XOR-reduces what it
// wrote into the digest: warp shuffles, then one atomicXor per warp of a
// grid-stride launch (torch has no XOR reduction).
//
// Division is floor division, as in the JAX path's exact int64 branch
// (evolu_tpu/ops/encode.py:133-137), so a negative millis renders its
// pre-1970 date; C's `/` truncates toward zero and is corrected below.
//
// Bound on the card: integer operations. Per row it reads 17 bytes
// (8 key/millis + 8 node + 1 mask) and writes 4, but the render and the
// murmur rounds take a few hundred 32-bit ALU operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

__device__ __forceinline__ int64_t fdiv(int64_t a, int64_t b) {  // b > 0
  int64_t q = a / b;
  return (a % b < 0) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ uint32_t mix_k(uint32_t k) {
  return rotl(k * 0xCC9E2D51u, 15) * 0x1B873593u;
}

// murmur3-32 fed one byte at a time; every call site is unrolled, so the
// byte position is a compile-time constant after inlining.
struct Murmur {
  uint32_t h = 0, word = 0;
  int pos = 0;
  __device__ __forceinline__ void put(uint32_t byte) {
    word |= byte << (8 * (pos & 3));
    ++pos;
    if ((pos & 3) == 0) {
      h = rotl(h ^ mix_k(word), 13) * 5u + 0xE6546B64u;
      word = 0;
    }
  }
  __device__ __forceinline__ void digits(uint32_t x, int n) {
    uint32_t p = 1;
    for (int i = 1; i < n; ++i) p *= 10u;
    for (int i = 0; i < n; ++i, p /= 10u) put((x / p) % 10u + '0');
  }
  __device__ __forceinline__ void hex(uint32_t x, int nibbles, uint32_t alpha) {
    for (int s = 4 * (nibbles - 1); s >= 0; s -= 4) {
      uint32_t v = (x >> s) & 0xFu;
      put(v < 10u ? v + '0' : v + alpha);
    }
  }
  __device__ __forceinline__ uint32_t finish() {
    if (pos & 3) h ^= mix_k(word);
    h ^= (uint32_t)pos;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    return h ^ (h >> 16);
  }
};

__device__ uint32_t timestamp_hash(int64_t millis, uint32_t counter, uint64_t node) {
  const int64_t secs = fdiv(millis, 1000);
  const uint32_t ms = (uint32_t)(millis - secs * 1000);
  const int64_t days64 = fdiv(secs, 86400);
  const uint32_t sod = (uint32_t)(secs - days64 * 86400);
  // days wraps to int32 as in the JAX path, then civil_from_days.
  const int64_t days = (int32_t)(uint32_t)(uint64_t)days64;
  const int64_t z = days + 719468;
  const int64_t era = fdiv(z, 146097);
  const int64_t doe = z - era * 146097;
  const int64_t yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096), 365);
  const int64_t doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100));
  const int64_t mp = fdiv(5 * doy + 2, 153);
  const int64_t d = doy - fdiv(153 * mp + 2, 5) + 1;
  const int64_t m = mp + (mp < 10 ? 3 : -9);
  const int64_t y = yoe + era * 400 + (m <= 2 ? 1 : 0);

  Murmur mm;
  mm.digits((uint32_t)y, 4);
  mm.put('-');
  mm.digits((uint32_t)m, 2);
  mm.put('-');
  mm.digits((uint32_t)d, 2);
  mm.put('T');
  mm.digits(sod / 3600u, 2);
  mm.put(':');
  mm.digits((sod / 60u) % 60u, 2);
  mm.put(':');
  mm.digits(sod % 60u, 2);
  mm.put('.');
  mm.digits(ms, 3);
  mm.put('Z');
  mm.put('-');
  mm.hex(counter, 4, 'A' - 10);
  mm.put('-');
  mm.hex((uint32_t)(node >> 32), 8, 'a' - 10);
  mm.hex((uint32_t)node, 8, 'a' - 10);
  return mm.finish();
}

// counter == nullptr: `a` holds packed keys k1 = millis << 16 | counter.
// Otherwise `a` holds millis and `counter` the counters. mask may be null
// (every row hashed); digest may be null (no reduction).
__global__ void __launch_bounds__(kThreads)
    ts_hash_kernel(const int64_t* a, const int32_t* counter, const uint64_t* node,
                   const uint8_t* mask, uint32_t* out, uint32_t* digest, int64_t n) {
  uint32_t acc = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t h = 0;
    if (mask == nullptr || mask[i]) {
      int64_t millis;
      uint32_t c;
      if (counter == nullptr) {
        const uint64_t k1 = (uint64_t)a[i];
        millis = (int64_t)(k1 >> 16);
        c = (uint32_t)(k1 & 0xFFFFu);
      } else {
        millis = a[i];
        c = (uint32_t)counter[i];
      }
      h = timestamp_hash(millis, c, node[i]);
    }
    out[i] = h;
    acc ^= h;
  }
  if (digest != nullptr) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, d);
    if ((threadIdx.x & 31) == 0 && acc != 0) atomicXor(digest, acc);
  }
}

}  // namespace

extern "C" int evolu_ts_hash(const void* a, const void* counter, const void* node, const void* mask,
                             void* out, void* digest, long long n, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ts_hash_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int32_t*>(counter),
      static_cast<const uint64_t*>(node), static_cast<const uint8_t*>(mask),
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(digest), n);
  return (int)cudaGetLastError();
}

// Kernel H: murmur3-32 of each canonical 46-byte timestamp string
// `YYYY-MM-DDTHH:mm:ss.sssZ-CCCC-<16 hex>` (counter hex upper case, node
// hex lower case), plus the batch XOR digest.
//
// Replaces evolu_tpu/ops/pallas_hash.py::_hash_kernel (pallas_call in
// _hash_blocks). The TPU kernel takes six pre-split 32-bit planes because
// Pallas on the TPU has no 64-bit vectors; here one thread renders and
// hashes one row straight from 64-bit inputs, and the string never leaves
// registers. On the reconcile path it starts from the SORTED HLC keys
// (millis = k1 >> 16, counter = k1 & 0xFFFF, node = k2) and the xor mask,
// writes `hash if xor else 0` (fusing unpack_ts_keys and the select at
// evolu_tpu/parallel/reconcile.py:140-143) and XOR-reduces what it wrote
// into the digest (torch has no XOR reduction).
//
// Bound on the card: integer operations. A row moves 17 bytes in (8
// key/millis + 8 node + 1 mask) and 4 out, but rendering and hashing it
// issues ~253 32-bit integer instructions (counted in the SASS of the
// hash alone; about 75 of them murmur's). What the design does about that:
//  1. One 64-bit step. days = floor(millis / 86,400,000) and the
//     millisecond of the day msod = millis - days * 86,400,000, which lies
//     in [0, 86.4M) and fits u32. Nested floor divisions by positive
//     divisors equal one floor division by their product, so this is the
//     JAX package's millis -> secs -> days split. days wraps to int32 (the
//     JAX package's `.astype(int32)`); from there on everything is 32-bit:
//     ms, seconds, hh/mm/ss and civil_from_days, whose `days + 719468`
//     wraps in int32 as in JAX (an unsigned add, then the cast: signed
//     overflow is undefined in C++). The one other int32 overflow of
//     civil_from_days, `era * 146097` at era = -14700, cancels in
//     `doe = z - era * 146097`, here an unsigned difference.
//  2. Words, not bytes. The string has a fixed layout, so its 11
//     little-endian murmur words and 2-byte tail are built directly:
//     decimal pairs by multiply-shift, hex by SWAR (nibbles spread one a
//     byte with byte permutes, then '0' added to every byte and the letter
//     gap to the bytes whose nibble is above 9). No table, so no shared or
//     constant memory (divergent indices would serialize there).
//  3. The digest in the same launch, no memset. Each block XOR-reduces
//     its rows and writes the partial to a per-(device, stream) scratch;
//     a fence, then a counter: the block that brings it to gridDim.x XORs
//     the partials, writes the digest after the hashes and resets the
//     counter to 0 for the next call on that stream.
//  4. The grid fills the card once: the SM count times the blocks an SM
//     holds at this kernel's register count (the occupancy API), each
//     thread striding over rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMsPerDay = 86400000;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ uint32_t mix_k(uint32_t k) {
  return rotl(k * 0xCC9E2D51u, 15) * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h(uint32_t h, uint32_t k) {
  return rotl(h ^ mix_k(k), 13) * 5u + 0xE6546B64u;
}

// v in [0, 100) -> its two decimal digits, tens in byte 0 and ones in
// byte 1, not yet ASCII: tens | (v - 10 * tens) << 8.
__device__ __forceinline__ uint32_t pair(uint32_t v) {
  const uint32_t tens = (v * 103u) >> 10;  // v / 10 for v < 179
  return (v << 8) - tens * 2559u;
}

// Four nibble values, one a byte -> their ASCII hex digits: '0' + v, and
// `gap` more where v > 9 (7 for 'A'-'F', 39 for 'a'-'f').
__device__ __forceinline__ uint32_t hex_ascii(uint32_t nibbles, uint32_t gap) {
  const uint32_t above9 = ((nibbles + 0x06060606u) >> 4) & 0x01010101u;
  return nibbles + 0x30303030u + above9 * gap;
}

// The 8 nibbles of x as hex, most significant first: bytes 0-3 of `first`
// hold nibbles 7-4, bytes 0-3 of `second` nibbles 3-0.
__device__ __forceinline__ void hex8(uint32_t x, uint32_t gap, uint32_t& first, uint32_t& second) {
  const uint32_t s = __byte_perm(x, 0, 0x0123);  // bytes most significant first
  const uint32_t hi = (s >> 4) & 0x0F0F0F0Fu;     // nibbles 7, 5, 3, 1
  const uint32_t lo = s & 0x0F0F0F0Fu;            // nibbles 6, 4, 2, 0
  first = hex_ascii(__byte_perm(hi, lo, 0x5140), gap);
  second = hex_ascii(__byte_perm(hi, lo, 0x7362), gap);
}

// murmur3-32 (seed 0) of the canonical string of one timestamp. millis
// is any int64; only the low 16 bits of `counter` are rendered.
__device__ __forceinline__ uint32_t timestamp_hash(int64_t millis, uint32_t counter, uint64_t node) {
  int64_t days64 = millis / kMsPerDay;  // truncates toward zero
  int64_t rem = millis - days64 * kMsPerDay;
  if (rem < 0) {
    days64 -= 1;
    rem += kMsPerDay;
  }
  const uint32_t msod = (uint32_t)rem;
  const uint32_t sod = msod / 1000u;
  const uint32_t ms = msod - sod * 1000u;
  const uint32_t hh = sod / 3600u;
  const uint32_t mins = sod / 60u;
  const uint32_t mi = mins - (mins / 60u) * 60u;
  const uint32_t ss = sod - mins * 60u;

  // civil_from_days in int32, days wrapped to int32 first.
  const int32_t z = (int32_t)((uint32_t)days64 + 719468u);
  int32_t era = z / 146097;  // truncates; |era| <= 14699, era * 146097 fits
  if (era * 146097 > z) era -= 1;
  const uint32_t doe = (uint32_t)z - (uint32_t)era * 146097u;  // [0, 146096]
  const uint32_t yoe = (doe - doe / 1460u + doe / 36524u - doe / 146096u) / 365u;
  const uint32_t doy = doe - (365u * yoe + yoe / 4u - yoe / 100u);
  const uint32_t mp = (5u * doy + 2u) / 153u;
  const uint32_t d = doy - (153u * mp + 2u) / 5u + 1u;
  const uint32_t mo = mp < 10u ? mp + 3u : mp - 9u;
  // The year's u32 bits, as the JAX package's `.astype(uint32)`; its four
  // digits are those of y mod 10^4.
  const uint32_t y = (uint32_t)era * 400u + yoe + (mo <= 2u ? 1u : 0u);
  const uint32_t y4 = y % 10000u;
  const uint32_t yh = y4 / 100u;

  // Counter hex: the 4 nibbles of its low 16 bits, one a byte, most
  // significant first.
  const uint32_t cs = __byte_perm(counter, 0, 0x4041);  // byte 0 = bits 15-8, byte 2 = bits 7-0
  const uint32_t cn = ((cs >> 4) & 0x000F000Fu) | ((cs & 0x000F000Fu) << 8);
  const uint32_t c = hex_ascii(cn, 'A' - '0' - 10);
  uint32_t n0, n1, n2, n3;  // node hex, 4 digits a word, most significant first
  hex8((uint32_t)(node >> 32), 'a' - '0' - 10, n0, n1);
  hex8((uint32_t)node, 'a' - '0' - 10, n2, n3);
  const uint32_t hp = pair(hh);

  // String bytes 4k..4k+3 as word k, byte 4k in the low byte.
  uint32_t h = 0;
  h = mix_h(h, (pair(yh) | pair(y4 - 100u * yh) << 16) + 0x30303030u);  // YYYY
  h = mix_h(h, (pair(mo) << 8) + 0x2D30302Du);                           // -MM-
  h = mix_h(h, (pair(d) | hp << 24) + 0x30543030u);                      // DDTH
  h = mix_h(h, ((hp >> 8) | pair(mi) << 16) + 0x30303A30u);              // H:mm
  h = mix_h(h, (pair(ss) << 8) + 0x2E30303Au);                           // :ss.
  h = mix_h(h, (ms / 100u | pair(ms % 100u) << 8) + 0x5A303030u);        // sssZ
  h = mix_h(h, 0x2Du | c << 8);                                          // -CCC
  h = mix_h(h, c >> 24 | 0x2D00u | n0 << 16);                            // C-nn
  h = mix_h(h, __byte_perm(n0, n1, 0x5432));                             // nnnn
  h = mix_h(h, __byte_perm(n1, n2, 0x5432));
  h = mix_h(h, __byte_perm(n2, n3, 0x5432));
  h ^= mix_k(n3 >> 16);  // the 2-byte tail
  h ^= 46u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// XOR of `x` over the block, in thread 0. Every thread must call it.
__device__ __forceinline__ uint32_t block_xor(uint32_t x, uint32_t* warp_acc) {
  x = warp_xor(x);
  if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = x;
  __syncthreads();
  uint32_t total = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total ^= warp_acc[w];
  }
  return total;
}

// kKeys: `a` holds packed keys k1 = millis << 16 | counter, `mask` picks
// the rows to hash (the others write 0), and the XOR of what was written
// lands in *digest. scratch: a u32 counter (0 between calls), then one
// partial a block. Otherwise `a` holds millis and `counter` the counters,
// and every row is hashed.
template <bool kKeys>
__global__ void __launch_bounds__(kThreads)
    ts_hash_kernel(const int64_t* __restrict__ a, const int32_t* __restrict__ counter,
                   const uint64_t* __restrict__ node, const uint8_t* __restrict__ mask,
                   uint32_t* __restrict__ out, int64_t n, uint32_t* scratch, uint32_t* digest) {
  uint32_t acc = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
#pragma unroll 1
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    uint32_t h;
    if (kKeys) {
      h = 0;
      if (mask[i]) {
        const uint64_t k1 = (uint64_t)a[i];
        h = timestamp_hash((int64_t)(k1 >> 16), (uint32_t)k1 & 0xFFFFu, node[i]);
      }
      acc ^= h;
    } else {
      h = timestamp_hash(a[i], (uint32_t)counter[i], node[i]);
    }
    out[i] = h;
  }
  if (!kKeys) return;

  __shared__ uint32_t warp_acc[kThreads / 32];
  __shared__ bool last;
  volatile uint32_t* partial = scratch + 1;
  const uint32_t mine = block_xor(acc, warp_acc);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = mine;
    __threadfence();  // the partial is visible before the count that reports it
    last = atomicAdd(scratch, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  uint32_t x = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) x ^= partial[b];
  const uint32_t total = block_xor(x, warp_acc);
  if (threadIdx.x == 0) {
    *digest = total;
    *scratch = 0;  // the next call on this stream starts from 0
  }
}

// Blocks of one launch: the SM count times the blocks an SM holds.
template <bool kKeys>
int grid_blocks(int& blocks) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ts_hash_kernel<kKeys>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    cached = sms * (per_sm > 0 ? per_sm : 1);
  }
  blocks = cached;
  return 0;
}

}  // namespace

extern "C" {

// Bytes of the reconcile form's digest scratch on the current device, 4
// for the counter and 4 for each block of its full grid (0 if the grid
// query fails); zero it once.
long long evolu_ts_hash_scratch_bytes(void) {
  int blocks = 0;
  return grid_blocks<true>(blocks) == 0 ? 4LL * (1 + blocks) : 0;
}

// Columns form: scratch == null; a: n int64 millis, counter: n int32,
// node: n u64, out: n u32; mask unused. Reconcile form: scratch != null,
// evolu_ts_hash_scratch_bytes() bytes zeroed when made; a: n packed keys
// k1, node: n keys k2, mask: n bytes (0/1), out: n + 1 u32 (the hashes,
// then the digest); counter unused. (An empty tensor's pointer is null,
// so the form is told by the scratch alone.)
int evolu_ts_hash(const void* a, const void* counter, const void* node, const void* mask, void* out,
                  void* scratch, long long n, void* stream) {
  const bool keys = scratch != nullptr;
  if (n < 0 || (n > 0 && (keys ? mask : counter) == nullptr)) return (int)cudaErrorInvalidValue;
  if (n == 0 && !keys) return 0;
  int blocks = 0;
  const int err = keys ? grid_blocks<true>(blocks) : grid_blocks<false>(blocks);
  if (err) return err;
  const long long need = (n + kThreads - 1) / kThreads;
  if (need < blocks) blocks = need > 0 ? (int)need : 1;  // the reconcile form writes a digest even for n = 0
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (keys) {
    ts_hash_kernel<true><<<blocks, kThreads, 0, s>>>(
        static_cast<const int64_t*>(a), nullptr, static_cast<const uint64_t*>(node),
        static_cast<const uint8_t*>(mask), o, n, static_cast<uint32_t*>(scratch), o + n);
  } else {
    ts_hash_kernel<false><<<blocks, kThreads, 0, s>>>(
        static_cast<const int64_t*>(a), static_cast<const int32_t*>(counter),
        static_cast<const uint64_t*>(node), nullptr, o, n, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

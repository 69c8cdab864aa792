// Kernels L, X and S: inclusive segmented scans for the LWW planner, the
// Merkle minute fold and the typed-CRDT folds, one template per monoid.
//
// Replace evolu_tpu/ops/pallas_scan.py::_make_scan_kernel as instantiated
// for _LEX_KERNEL (combine `_comb`: lexicographic max of (k1, k2) unsigned
// u64 pairs), _XOR_KERNEL (combine `_seg_xor`: XOR of u32 hashes) and
// _SUM_KERNEL (combine `_seg_sum`: modular u64 sum; the TPU kernel carries
// it across hi/lo u32 limbs, here it is one native unsigned add that wraps
// mod 2^64, which is what the limb carry computes). The segment flag marks a segment start; the element nearest the scan head
// wins outright when flagged:
//   combine(l, r) = (l.f | r.f, r.f ? r.v : op(l.v, r.v)).
// With reverse != 0 the scan runs right to left over the same memory
// (flags then mark segment ENDS), which is what the JAX wrapper's
// flip / scan / flip computes.
//
// The TPU kernel walks a sequential grid and carries the running value in
// SMEM; Hopper blocks run in no order, so this is a three-phase
// reduce-then-scan: (A) each tile of 2048 rows reduces to its aggregate,
// (B) one block scans the aggregates into exclusive tile prefixes, (C)
// each tile rescans its rows starting from its prefix and writes them.
// Hopper has native 64-bit integers, so the u64 keys are scanned whole
// (no u32 limb planes) with unsigned compares.
//
// Bound on the card: memory bytes. L moves 1 + 16 bytes in and 16 out per
// row, X 1 + 4 in and 4 out, S 1 + 8 in and 8 out; phase A reads the
// inputs a second time, which costs 17 (L) / 5 (X) / 9 (S) bytes per row
// over that bound. A single-pass
// decoupled look-back would remove it; this first version stays simple.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

struct LexMax {
  struct V {
    uint64_t a, b;
  };
  __device__ static V zero() { return V{0, 0}; }
  __device__ static V op(const V& l, const V& r) {
    bool l_wins = (l.a > r.a) || (l.a == r.a && l.b >= r.b);
    return l_wins ? l : r;
  }
  __device__ static V shfl_up(const V& x, int d) {
    return V{(uint64_t)__shfl_up_sync(kFull, (unsigned long long)x.a, d),
             (uint64_t)__shfl_up_sync(kFull, (unsigned long long)x.b, d)};
  }
};

struct Xor {
  using V = uint32_t;
  __device__ static V zero() { return 0u; }
  __device__ static V op(V l, V r) { return l ^ r; }
  __device__ static V shfl_up(V x, int d) { return __shfl_up_sync(kFull, x, d); }
};

struct Sum {
  using V = uint64_t;
  __device__ static V zero() { return 0ull; }
  __device__ static V op(V l, V r) { return l + r; }  // unsigned: wraps mod 2^64
  __device__ static V shfl_up(V x, int d) {
    return (uint64_t)__shfl_up_sync(kFull, (unsigned long long)x, d);
  }
};

template <class M>
struct Elem {
  typename M::V v;
  uint32_t f;
};

template <class M>
__device__ __forceinline__ Elem<M> identity() {
  return Elem<M>{M::zero(), 0u};
}

template <class M>
__device__ __forceinline__ Elem<M> combine(const Elem<M>& l, const Elem<M>& r) {
  return Elem<M>{r.f ? r.v : M::op(l.v, r.v), l.f | r.f};
}

template <class M>
__device__ __forceinline__ Elem<M> shfl_up(const Elem<M>& x, int d) {
  return Elem<M>{M::shfl_up(x.v, d), __shfl_up_sync(kFull, x.f, d)};
}

// Block-wide exclusive scan of one value per thread. Every thread of the
// block must call it. Returns this thread's exclusive prefix and sets
// `total` to the block's inclusive total.
template <class M>
__device__ Elem<M> block_exclusive(Elem<M> x, Elem<M>* warp_tot, Elem<M>& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Elem<M> inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Elem<M> y = shfl_up<M>(inc, d);
    if (lane >= d) inc = combine<M>(y, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Elem<M> w = lane < kWarps ? warp_tot[lane] : identity<M>();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      Elem<M> y = shfl_up<M>(w, d);
      if (lane >= d) w = combine<M>(y, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  Elem<M> excl = shfl_up<M>(inc, 1);
  if (lane == 0) excl = identity<M>();
  Elem<M> prefix = warp > 0 ? combine<M>(warp_tot[warp - 1], excl) : excl;
  total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the caller's next call
  return prefix;
}

struct LexIO {
  const uint8_t* flags;
  const uint64_t* k1;
  const uint64_t* k2;
  uint64_t* o1;
  uint64_t* o2;
  __device__ Elem<LexMax> load(int64_t p) const {
    return Elem<LexMax>{LexMax::V{k1[p], k2[p]}, flags[p] ? 1u : 0u};
  }
  __device__ void store(int64_t p, const LexMax::V& v) const {
    o1[p] = v.a;
    o2[p] = v.b;
  }
};

struct XorIO {
  const uint8_t* flags;
  const uint32_t* v;
  uint32_t* out;
  __device__ Elem<Xor> load(int64_t p) const {
    return Elem<Xor>{v[p], flags[p] ? 1u : 0u};
  }
  __device__ void store(int64_t p, uint32_t x) const { out[p] = x; }
};

struct SumIO {
  const uint8_t* flags;
  const uint64_t* v;
  uint64_t* out;
  __device__ Elem<Sum> load(int64_t p) const {
    return Elem<Sum>{v[p], flags[p] ? 1u : 0u};
  }
  __device__ void store(int64_t p, uint64_t x) const { out[p] = x; }
};

// Logical scan position j → memory position.
__device__ __forceinline__ int64_t phys(int64_t j, int64_t n, int reverse) {
  return reverse ? n - 1 - j : j;
}

// Phase A: one aggregate per tile.
template <class M, class IO>
__global__ void __launch_bounds__(kThreads) tile_reduce(IO io, int64_t n, int reverse, Elem<M>* aggs) {
  __shared__ Elem<M> warp_tot[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  Elem<M> acc = identity<M>();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = base + i;
    if (j < n) acc = combine<M>(acc, io.load(phys(j, n, reverse)));
  }
  Elem<M> total;
  block_exclusive<M>(acc, warp_tot, total);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

// Phase B: one block turns the m tile aggregates into exclusive prefixes,
// in place, a chunk of kTile at a time with a running carry.
template <class M>
__global__ void __launch_bounds__(kThreads) scan_aggregates(Elem<M>* aggs, int64_t m) {
  __shared__ Elem<M> warp_tot[kWarps];
  Elem<M> carry = identity<M>();
  for (int64_t start = 0; start < m; start += kTile) {
    const int64_t base = start + (int64_t)threadIdx.x * kItems;
    Elem<M> items[kItems];
    Elem<M> acc = identity<M>();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      items[i] = base + i < m ? aggs[base + i] : identity<M>();
      acc = combine<M>(acc, items[i]);
    }
    Elem<M> total;
    Elem<M> run = combine<M>(carry, block_exclusive<M>(acc, warp_tot, total));
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (base + i < m) aggs[base + i] = run;
      run = combine<M>(run, items[i]);
    }
    carry = combine<M>(carry, total);
  }
}

// Phase C: rescan each tile from its exclusive prefix and write the rows.
template <class M, class IO>
__global__ void __launch_bounds__(kThreads) tile_scan(IO io, int64_t n, int reverse, const Elem<M>* prefix) {
  __shared__ Elem<M> warp_tot[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  Elem<M> items[kItems];
  Elem<M> acc = identity<M>();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = base + i;
    items[i] = j < n ? io.load(phys(j, n, reverse)) : identity<M>();
    acc = combine<M>(acc, items[i]);
  }
  Elem<M> total;
  Elem<M> run = block_exclusive<M>(acc, warp_tot, total);
  if (prefix != nullptr) run = combine<M>(prefix[blockIdx.x], run);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = base + i;
    run = combine<M>(run, items[i]);
    if (j < n) io.store(phys(j, n, reverse), run.v);
  }
}

template <class M>
int64_t scratch_bytes(int64_t n) {
  return ((n + kTile - 1) / kTile) * (int64_t)sizeof(Elem<M>);
}

template <class M, class IO>
int run_scan(const IO& io, int64_t n, int reverse, void* scratch, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Elem<M>* aggs = static_cast<Elem<M>*>(scratch);
  if (tiles > 1) {
    tile_reduce<M, IO><<<(unsigned)tiles, kThreads, 0, stream>>>(io, n, reverse, aggs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan_aggregates<M><<<1, kThreads, 0, stream>>>(aggs, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  tile_scan<M, IO><<<(unsigned)tiles, kThreads, 0, stream>>>(io, n, reverse, tiles > 1 ? aggs : nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device scratch the scan of n rows needs (monoid 0 = L, 1 = X,
// 2 = S).
long long evolu_seg_scan_scratch_bytes(int monoid, long long n) {
  switch (monoid) {
    case 0: return scratch_bytes<LexMax>(n);
    case 1: return scratch_bytes<Xor>(n);
    default: return scratch_bytes<Sum>(n);
  }
}

// Kernel L. flags: n bytes (0/1); k1, k2: n u64; o1, o2: n u64 outputs.
int evolu_seg_lex_max_scan(const void* flags, const void* k1, const void* k2, void* o1, void* o2,
                           long long n, int reverse, void* scratch, void* stream) {
  LexIO io{static_cast<const uint8_t*>(flags), static_cast<const uint64_t*>(k1),
           static_cast<const uint64_t*>(k2), static_cast<uint64_t*>(o1), static_cast<uint64_t*>(o2)};
  return run_scan<LexMax>(io, n, reverse, scratch, static_cast<cudaStream_t>(stream));
}

// Kernel X. flags: n bytes (0/1); v: n u32; out: n u32.
int evolu_seg_xor_scan(const void* flags, const void* v, void* out, long long n, void* scratch,
                       void* stream) {
  XorIO io{static_cast<const uint8_t*>(flags), static_cast<const uint32_t*>(v),
           static_cast<uint32_t*>(out)};
  return run_scan<Xor>(io, n, 0, scratch, static_cast<cudaStream_t>(stream));
}

// Kernel S. flags: n bytes (0/1), segment starts; v: n u64; out: n u64.
int evolu_seg_sum_scan(const void* flags, const void* v, void* out, long long n, void* scratch,
                       void* stream) {
  SumIO io{static_cast<const uint8_t*>(flags), static_cast<const uint64_t*>(v),
           static_cast<uint64_t*>(out)};
  return run_scan<Sum>(io, n, 0, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// Kernels L, X and S: inclusive segmented scans for the LWW planner, the
// Merkle minute fold and the typed-CRDT folds, one template per monoid.
//
// They replace evolu_tpu/ops/pallas_scan.py::_make_scan_kernel as
// instantiated at pallas_scan.py:157 for _LEX_KERNEL (kernel L, combine
// `_comb`: lexicographic max of (k1, k2) unsigned u64 pairs), :158 for
// _XOR_KERNEL (kernel X, combine `_seg_xor`: XOR of u32 hashes) and :159
// for _SUM_KERNEL (kernel S, combine `_seg_sum`: modular u64 sum; the TPU
// kernel carries it across hi/lo u32 limbs, here it is one native unsigned
// add that wraps mod 2^64, which is what the limb carry computes). The
// segment flag marks a segment start; the element nearest the scan head
// wins outright when flagged:
//   combine(l, r) = (l.f | r.f, r.f ? r.v : op(l.v, r.v)).
// With reverse != 0 the scan runs right to left over the same memory
// (flags then mark segment ENDS), which is what the JAX wrapper's
// flip / scan / flip computes. Hopper has native 64-bit integers, so the
// u64 keys are scanned whole (no u32 limb planes) with unsigned compares.
//
// Bound on the card: memory bytes, each input read once and each output
// written once. L moves 1 + 16 bytes in and 16 out per row (33 B/row), S
// 1 + 8 in and 8 out (17 B/row), X 1 + 4 in and 4 out (9 B/row).
//
// L and S are one kernel per call, a single-pass scan with decoupled
// look-back (Merrill & Garland, 2016). What it does about the three
// limits of the reduce-then-scan it replaced:
//  1. Three launches and two reads of the input. Each block reads its
//     tile once into shared memory, reduces it, publishes the aggregate,
//     finds its exclusive prefix in its predecessors' published state,
//     publishes its inclusive prefix, rescans the tile in shared memory
//     and writes it. A flagged aggregate decides the prefix by itself
//     (combine(x, r) = r when r.f), so the look-back stops at the nearest
//     predecessor tile that holds a segment start, and a tile whose first
//     row starts a segment needs no prefix at all.
//  2. Strided per-thread loads. Neighbouring threads load neighbouring
//     16-byte pairs of rows (flags 16 bytes a thread), every load of the
//     tile in flight before the first lands in shared memory, padded one
//     u64 in 16 so that each thread's run of 8 rows reads without bank
//     conflicts. A row before the first 16-byte boundary and a row after
//     the last pair load alone, so any contiguous view works. About 50
//     registers a thread: 4 blocks of 256 threads fit an SM.
//  3. The wrapper's fixed cost. Status words carry a per-call epoch, so a
//     stale word never reads as ready: the wrapper keeps one scratch per
//     device and stream, clears it only when the epoch wraps, and makes
//     one launch per call with no allocation but the outputs.
//
// X still runs the three-phase reduce-then-scan (tile_reduce,
// scan_aggregates, tile_scan) until it moves to the look-back template.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void st_volatile(uint64_t* p, uint64_t x) {
  *reinterpret_cast<volatile unsigned long long*>(p) = x;
}

__device__ __forceinline__ uint64_t ld_volatile(const uint64_t* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

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
  __device__ static void publish(V* p, const V& x) {
    st_volatile(&p->a, x.a);
    st_volatile(&p->b, x.b);
  }
  __device__ static V read(const V* p) { return V{ld_volatile(&p->a), ld_volatile(&p->b)}; }
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
  __device__ static void publish(V* p, V x) { st_volatile(p, x); }
  __device__ static V read(const V* p) { return ld_volatile(p); }
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

// ---- L and S: single pass with decoupled look-back ------------------------

constexpr int kLbPadded = kTile + kTile / 16;
constexpr uint32_t kAggregate = 1, kInclusive = 2;
constexpr uint32_t kEpochLimit = 1u << 29;  // status = epoch << 3 | flag << 2 | state

// Shared-memory slot of tile row r: one u64 of padding after every 16, so
// that thread t reading rows 8t..8t+7 hits 16 distinct 8-byte banks.
__device__ __forceinline__ int pad(int r) { return r + (r >> 4); }

constexpr int kPairs = kTile / 2 / kThreads;  // 16-byte loads a thread per u64 column
static_assert(kTile / 16 <= kThreads, "one 16-byte flag chunk a thread");

// Rows [0, count) of one u64 column g, loaded 16 bytes a thread from the
// first 16-byte-aligned row on, all of a thread's loads in flight before
// any lands in shared memory; a row before the first pair and a row after
// the last load alone (threads 0 and 1). g is 8-byte aligned, as every
// int64 tensor's data is. put() stores row r at s[pad(r)].
struct RowLoad {
  ulonglong2 x[kPairs];
  uint64_t edge;
  int head, pairs, count;
  __device__ __forceinline__ void fetch(const uint64_t* g, int n) {
    count = n;
    head = min(n, (int)((reinterpret_cast<uintptr_t>(g) >> 3) & 1));
    pairs = (n - head) >> 1;
    const ulonglong2* g2 = reinterpret_cast<const ulonglong2*>(g + head);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < pairs) x[i] = g2[p];
    }
    if (threadIdx.x == 0 && head) edge = g[0];
    if (threadIdx.x == 1 && head + 2 * pairs < n) edge = g[n - 1];
  }
  __device__ __forceinline__ void put(uint64_t* s) const {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < pairs) {
        const int r = head + 2 * p;
        s[pad(r)] = x[i].x;
        s[pad(r + 1)] = x[i].y;
      }
    }
    if (threadIdx.x == 0 && head) s[pad(0)] = edge;
    if (threadIdx.x == 1 && head + 2 * pairs < count) s[pad(count - 1)] = edge;
  }
};

// The mirror of RowLoad: s[pad(r)] to rows [0, count) of g.
__device__ __forceinline__ void store_rows(uint64_t* g, int count, const uint64_t* s) {
  const int head = min(count, (int)((reinterpret_cast<uintptr_t>(g) >> 3) & 1));
  const int pairs = (count - head) >> 1;
  ulonglong2* g2 = reinterpret_cast<ulonglong2*>(g + head);
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < pairs) {
      const int r = head + 2 * p;
      ulonglong2 x;
      x.x = s[pad(r)];
      x.y = s[pad(r + 1)];
      g2[p] = x;
    }
  }
  if (threadIdx.x == 0 && head) g[0] = s[pad(0)];
  if (threadIdx.x == 1 && head + 2 * pairs < count) g[count - 1] = s[pad(count - 1)];
}

// Flag bytes [0, count) of g: one 16-byte load a thread from each aligned
// chunk, the bytes before the first chunk and after the last one a byte a
// thread. put() stores byte r at s[off + r], off = g's address mod 16, so
// that every chunk lands on an aligned shared address, and returns off.
struct FlagLoad {
  uint4 x;
  uint8_t first, last;
  int off, head, chunks, tail, count;
  __device__ __forceinline__ void fetch(const uint8_t* g, int n) {
    count = n;
    off = (int)(reinterpret_cast<uintptr_t>(g) & 15);
    head = min(n, (16 - off) & 15);
    chunks = (n - head) >> 4;
    tail = head + 16 * chunks;
    if ((int)threadIdx.x < chunks) x = reinterpret_cast<const uint4*>(g + head)[threadIdx.x];
    if ((int)threadIdx.x < head) first = g[threadIdx.x];
    if ((int)threadIdx.x < n - tail) last = g[tail + threadIdx.x];
  }
  __device__ __forceinline__ int put(uint8_t* s) const {
    if ((int)threadIdx.x < chunks) reinterpret_cast<uint4*>(s + off + head)[threadIdx.x] = x;
    if ((int)threadIdx.x < head) s[off + threadIdx.x] = first;
    if ((int)threadIdx.x < count - tail) s[off + tail + threadIdx.x] = last;
    return off;
  }
};

// One tile of kernel L in shared memory: load, read a row, write a row's
// result in place, store.
struct LexTile {
  using M = LexMax;
  struct Smem {
    uint64_t a[kLbPadded];
    uint64_t b[kLbPadded];
    alignas(16) uint8_t f[kTile + 16];
  };
  const uint8_t* flags;
  const uint64_t* k1;
  const uint64_t* k2;
  uint64_t* o1;
  uint64_t* o2;
  __device__ int load(Smem& s, int64_t at, int count) const {
    RowLoad a, b;
    FlagLoad f;
    a.fetch(k1 + at, count);
    b.fetch(k2 + at, count);
    f.fetch(flags + at, count);
    a.put(s.a);
    b.put(s.b);
    return f.put(s.f);
  }
  __device__ Elem<M> get(const Smem& s, int off, int m) const {
    return Elem<M>{M::V{s.a[pad(m)], s.b[pad(m)]}, s.f[off + m] ? 1u : 0u};
  }
  __device__ void put(Smem& s, int m, const M::V& v) const {
    s.a[pad(m)] = v.a;
    s.b[pad(m)] = v.b;
  }
  __device__ void store(const Smem& s, int64_t at, int count) const {
    store_rows(o1 + at, count, s.a);
    store_rows(o2 + at, count, s.b);
  }
};

// One tile of kernel S in shared memory.
struct SumTile {
  using M = Sum;
  struct Smem {
    uint64_t v[kLbPadded];
    alignas(16) uint8_t f[kTile + 16];
  };
  const uint8_t* flags;
  const uint64_t* v;
  uint64_t* out;
  __device__ int load(Smem& s, int64_t at, int count) const {
    RowLoad a;
    FlagLoad f;
    a.fetch(v + at, count);
    f.fetch(flags + at, count);
    a.put(s.v);
    return f.put(s.f);
  }
  __device__ Elem<M> get(const Smem& s, int off, int m) const {
    return Elem<M>{s.v[pad(m)], s.f[off + m] ? 1u : 0u};
  }
  __device__ void put(Smem& s, int m, uint64_t x) const { s.v[pad(m)] = x; }
  __device__ void store(const Smem& s, int64_t at, int count) const { store_rows(out + at, count, s.v); }
};

// Published state of every tile of one call. A value is written before
// its status word (a fence between), and read only after the status word
// has been seen with this call's epoch (a fence between), both past L1.
template <class M>
struct LookBack {
  uint32_t* status;  // per tile: epoch << 3 | flag << 2 | kAggregate or kInclusive
  typename M::V* agg;
  typename M::V* inc;
  uint32_t epoch;

  __device__ void publish(int64_t tile, const Elem<M>& e, uint32_t state) const {
    M::publish((state == kInclusive ? inc : agg) + tile, e.v);
    __threadfence();
    *reinterpret_cast<volatile uint32_t*>(status + tile) = epoch << 3 | e.f << 2 | state;
  }

  // Called by all 32 lanes of one warp: the exclusive prefix of `tile`,
  // from its predecessors' state, 32 tiles a step with the nearest in lane
  // 31. A step that holds an inclusive prefix or a flagged aggregate ends
  // the walk there. Lane 31 returns the prefix.
  __device__ Elem<M> exclusive_prefix(int64_t tile) const {
    const int lane = threadIdx.x & 31;
    Elem<M> prefix = identity<M>();
    for (int64_t last = tile - 1;; last -= 32) {
      const int64_t t = last - 31 + lane;
      uint32_t st = 0;
      for (;;) {
        if (t >= 0) st = *reinterpret_cast<const volatile uint32_t*>(status + t);
        if (__all_sync(kFull, t < 0 || (st >> 3) == epoch)) break;
        __nanosleep(32);
      }
      __threadfence();
      Elem<M> e = identity<M>();
      if (t >= 0) e = Elem<M>{M::read(((st & 3) == kInclusive ? inc : agg) + t), (st >> 2) & 1u};
      const unsigned decisive = __ballot_sync(kFull, t >= 0 && ((st & 3) == kInclusive || e.f));
      if (decisive && lane < 31 - __clz((int)decisive)) e = identity<M>();
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        Elem<M> y = shfl_up<M>(e, d);
        if (lane >= d) e = combine<M>(y, e);
      }
      prefix = combine<M>(e, prefix);
      if (decisive) return prefix;
    }
  }
};

// Tile t covers scan positions [t*kTile, t*kTile + count). Forward, that
// is memory from `at` on; reversed, memory [n - t*kTile - count,
// n - t*kTile) read backwards, so the ragged tile lies at the start of
// memory. Blocks wait only on tiles of a lower blockIdx, which are
// dispatched before them.
template <class Tile>
__global__ void __launch_bounds__(kThreads) lookback_scan(Tile io, int64_t n, int reverse, LookBack<typename Tile::M> lb) {
  using M = typename Tile::M;
  __shared__ typename Tile::Smem s;
  __shared__ Elem<M> warp_tot[kWarps];
  __shared__ Elem<M> tile_prefix;
  const int64_t tile = blockIdx.x;
  const int64_t start = tile * kTile;
  const int count = (int)(n - start < kTile ? n - start : kTile);
  const int64_t at = reverse ? n - start - count : start;
  const int off = io.load(s, at, count);
  __syncthreads();
  const int base = threadIdx.x * kItems;
  Elem<M> acc = identity<M>();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = base + i;
    if (j < count) acc = combine<M>(acc, io.get(s, off, reverse ? count - 1 - j : j));
  }
  Elem<M> total;
  Elem<M> run = block_exclusive<M>(acc, warp_tot, total);
  if (threadIdx.x < 32) {
    // Lane 31 publishes both states, so the inclusive one lands last.
    const int lane = threadIdx.x;
    if (lane == 31) lb.publish(tile, total, tile == 0 || total.f ? kInclusive : kAggregate);
    Elem<M> prefix = identity<M>();
    // Only rows before the tile's first segment start need the prefix.
    if (tile > 0 && !io.get(s, off, reverse ? count - 1 : 0).f) {
      prefix = lb.exclusive_prefix(tile);
      if (lane == 31 && !total.f) lb.publish(tile, combine<M>(prefix, total), kInclusive);
    }
    if (lane == 31) tile_prefix = prefix;
  }
  __syncthreads();
  run = combine<M>(tile_prefix, run);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = base + i;
    if (j < count) {
      const int m = reverse ? count - 1 - j : j;
      run = combine<M>(run, io.get(s, off, m));
      io.put(s, m, run.v);
    }
  }
  __syncthreads();
  io.store(s, at, count);
}

int64_t status_bytes(int64_t tiles) { return (tiles * 4 + 15) / 16 * 16; }

template <class Tile>
int run_lookback(const Tile& io, int64_t n, int reverse, void* scratch, int64_t scratch_tiles,
                 uint32_t epoch, cudaStream_t stream) {
  using V = typename Tile::M::V;
  if (n <= 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > scratch_tiles || tiles > 0x7fffffff || epoch == 0 || epoch >= kEpochLimit)
    return (int)cudaErrorInvalidValue;
  uint8_t* base = static_cast<uint8_t*>(scratch);
  V* agg = reinterpret_cast<V*>(base + status_bytes(scratch_tiles));
  LookBack<typename Tile::M> lb{reinterpret_cast<uint32_t*>(base), agg, agg + scratch_tiles, epoch};
  lookback_scan<Tile><<<(unsigned)tiles, kThreads, 0, stream>>>(io, n, reverse, lb);
  return (int)cudaGetLastError();
}

// ---- X: three-phase reduce-then-scan ------------------------------------

struct XorIO {
  const uint8_t* flags;
  const uint32_t* v;
  uint32_t* out;
  __device__ Elem<Xor> load(int64_t p) const {
    return Elem<Xor>{v[p], flags[p] ? 1u : 0u};
  }
  __device__ void store(int64_t p, uint32_t x) const { out[p] = x; }
};

// Phase A: one aggregate per tile.
template <class M, class IO>
__global__ void __launch_bounds__(kThreads) tile_reduce(IO io, int64_t n, Elem<M>* aggs) {
  __shared__ Elem<M> warp_tot[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  Elem<M> acc = identity<M>();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = base + i;
    if (j < n) acc = combine<M>(acc, io.load(j));
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
__global__ void __launch_bounds__(kThreads) tile_scan(IO io, int64_t n, const Elem<M>* prefix) {
  __shared__ Elem<M> warp_tot[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  Elem<M> items[kItems];
  Elem<M> acc = identity<M>();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = base + i;
    items[i] = j < n ? io.load(j) : identity<M>();
    acc = combine<M>(acc, items[i]);
  }
  Elem<M> total;
  Elem<M> run = block_exclusive<M>(acc, warp_tot, total);
  if (prefix != nullptr) run = combine<M>(prefix[blockIdx.x], run);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = base + i;
    run = combine<M>(run, items[i]);
    if (j < n) io.store(j, run.v);
  }
}

template <class M, class IO>
int run_scan(const IO& io, int64_t n, void* scratch, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Elem<M>* aggs = static_cast<Elem<M>*>(scratch);
  if (tiles > 1) {
    tile_reduce<M, IO><<<(unsigned)tiles, kThreads, 0, stream>>>(io, n, aggs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan_aggregates<M><<<1, kThreads, 0, stream>>>(aggs, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  tile_scan<M, IO><<<(unsigned)tiles, kThreads, 0, stream>>>(io, n, tiles > 1 ? aggs : nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per block of the look-back scans (L and S).
long long evolu_seg_scan_tile_rows(void) { return kTile; }

// Bytes of look-back scratch for `tiles` tiles: status words, then the
// aggregates and the inclusive prefixes, sized for L's 16-byte values
// (S uses the first half of each). Zero it once; the epoch does the rest.
long long evolu_seg_scan_lookback_bytes(long long tiles) {
  return status_bytes(tiles) + 2 * tiles * (long long)sizeof(LexMax::V);
}

// Kernel L. flags: n bytes (0/1); k1, k2: n u64; o1, o2: n u64 outputs.
// scratch: evolu_seg_scan_lookback_bytes(scratch_tiles) bytes; epoch in
// [1, 2^29), a value no earlier call on this scratch used since it was
// last zeroed.
int evolu_seg_lex_max_scan(const void* flags, const void* k1, const void* k2, void* o1, void* o2,
                           long long n, int reverse, void* scratch, long long scratch_tiles,
                           unsigned epoch, void* stream) {
  LexTile io{static_cast<const uint8_t*>(flags), static_cast<const uint64_t*>(k1),
             static_cast<const uint64_t*>(k2), static_cast<uint64_t*>(o1), static_cast<uint64_t*>(o2)};
  return run_lookback(io, n, reverse, scratch, scratch_tiles, epoch, static_cast<cudaStream_t>(stream));
}

// Kernel S. flags: n bytes (0/1), segment starts; v: n u64; out: n u64;
// scratch and epoch as for kernel L.
int evolu_seg_sum_scan(const void* flags, const void* v, void* out, long long n, void* scratch,
                       long long scratch_tiles, unsigned epoch, void* stream) {
  SumTile io{static_cast<const uint8_t*>(flags), static_cast<const uint64_t*>(v),
             static_cast<uint64_t*>(out)};
  return run_lookback(io, n, 0, scratch, scratch_tiles, epoch, static_cast<cudaStream_t>(stream));
}

// Bytes of device scratch kernel X needs for n rows.
long long evolu_seg_xor_scan_scratch_bytes(long long n) {
  return ((n + kTile - 1) / kTile) * (long long)sizeof(Elem<Xor>);
}

// Kernel X. flags: n bytes (0/1); v: n u32; out: n u32.
int evolu_seg_xor_scan(const void* flags, const void* v, void* out, long long n, void* scratch,
                       void* stream) {
  XorIO io{static_cast<const uint8_t*>(flags), static_cast<const uint32_t*>(v),
           static_cast<uint32_t*>(out)};
  return run_scan<Xor>(io, n, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

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
// L, X and S are one kernel per call, a single-pass scan with decoupled
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
//     16 bytes of rows (2 u64 rows of L and S, 4 u32 rows of X; flags 16
//     bytes a thread), every load of the tile in flight before the first
//     lands in shared memory, padded so that each thread's run of rows (8
//     for L and S, 16 for X) reads without bank conflicts (one u64 in 16,
//     one u32 in 32). The rows before the first 16-byte boundary and after
//     the last 16-byte load load alone, so any contiguous view works.
//  3. The wrapper's fixed cost. Status words carry a per-call epoch, so a
//     stale word never reads as ready: the wrapper keeps one scratch per
//     device and stream, shared by the three scans, clears it only when
//     the epoch wraps, and makes one launch per call with no allocation
//     but the outputs. X's 4-byte values fit the slots sized for L's 16.

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
  __device__ static void publish(V* p, V x) { *reinterpret_cast<volatile uint32_t*>(p) = x; }
  __device__ static V read(const V* p) { return *reinterpret_cast<const volatile uint32_t*>(p); }
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

// ---- L, X and S: single pass with decoupled look-back ---------------------

constexpr uint32_t kAggregate = 1, kInclusive = 2;
constexpr uint32_t kEpochLimit = 1u << 29;  // status = epoch << 3 | flag << 2 | state

// X's tile is twice L's and S's, 16 rows a thread: its rows are 4 bytes,
// and a block's life (load, reduce, publish, look back, rescan, store) has
// a fixed latency that 8 rows of 9 bytes a thread do not cover. The scratch
// sized in tiles of kTile rows holds X's fewer, larger tiles too.
constexpr int kXorRows = 2 * kTile;
static_assert(kXorRows / 16 <= kThreads, "one 16-byte flag chunk a thread");

// Shared-memory slot of tile row r of a column of T (8 or 4 bytes): one T
// of padding after every 128 bytes of rows, so that a thread's run of rows
// (8 u64 rows of L and S, 16 u32 rows of X) and the rows of a warp's
// 16-byte loads both hit distinct banks. For u64, row r at slot r + r/16:
// thread t's rows 8t..8t+7 hit 16 distinct 8-byte banks. For u32:
//
//   row   0 .. 31 | -- | 32 .. 63 | -- | 64 .. 95 | -- | ...
//   slot  0 .. 31 | 32 | 33 .. 64 | 65 | 66 .. 97 | 98 | ...
//
// - thread t's run of 16 rows, row 16t + i at slot 16t + i + t/2: across a
//   warp's lanes l that is bank 16(l % 2) + l/2 + i + const (mod 32),
//   distinct for the 32 lanes;
// - a 16-byte load c (rows 4c..4c+3), row 4c + j at slot 4c + c/8 + j:
//   bank 4(l % 8) + l/8 + j + const, distinct too (a ragged head of 1-3
//   rows shifts them, and then at most two lanes share a bank).
// pad<T>(kRows) is the slots a tile of kRows rows takes.
template <class T>
__host__ __device__ constexpr int pad(int r) {
  static_assert(sizeof(T) == 8 || sizeof(T) == 4, "u64 or u32 rows");
  return r + (r >> (sizeof(T) == 8 ? 4 : 5));
}

// Rows of g before its first 16-byte boundary, at most n. g is
// sizeof(T)-aligned, as every tensor's data is.
template <class T>
__device__ __forceinline__ int head_rows(const T* g, int n) {
  return min(n, (int)(((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) / sizeof(T)));
}

// 16 bytes of rows: one load or store.
template <class T>
union Chunk {
  uint4 raw;
  T row[16 / sizeof(T)];
};

// Rows [0, count) of one column g of T, loaded 16 bytes (kVec rows) a
// thread from the first 16-byte-aligned row on, every load of a thread in
// flight before any lands in shared memory; the 0 to kVec - 1 rows before
// the first aligned load go one a thread (threads 0..), likewise those
// after the last one (threads kVec..). put() stores row r at s[pad<T>(r)].
template <class T, int kRows>
struct RowLoad {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLoads = kRows / kVec / kThreads;
  Chunk<T> x[kLoads];
  T edge;
  int head, vecs, count;
  __device__ __forceinline__ void fetch(const T* g, int n) {
    count = n;
    head = head_rows(g, n);
    vecs = (unsigned)(n - head) / kVec;
    const uint4* g4 = reinterpret_cast<const uint4*>(g + head);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < vecs) x[i].raw = g4[p];
    }
    const int t = threadIdx.x, tail = head + kVec * vecs;
    if (t < head) edge = g[t];
    if (t >= kVec && t - kVec < n - tail) edge = g[tail + t - kVec];
  }
  __device__ __forceinline__ void put(T* s) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < vecs) {
        const int r = head + kVec * p;
#pragma unroll
        for (int j = 0; j < kVec; ++j) s[pad<T>(r + j)] = x[i].row[j];
      }
    }
    const int t = threadIdx.x, tail = head + kVec * vecs;
    if (t < head) s[pad<T>(t)] = edge;
    if (t >= kVec && t - kVec < count - tail) s[pad<T>(tail + t - kVec)] = edge;
  }
};

// The mirror of RowLoad: s[pad<T>(r)] to rows [0, count) of g.
template <class T, int kRows>
__device__ __forceinline__ void store_rows(T* g, int count, const T* s) {
  constexpr int kVec = RowLoad<T, kRows>::kVec;
  const int head = head_rows(g, count);
  const int vecs = (unsigned)(count - head) / kVec;
  const int tail = head + kVec * vecs;
  uint4* g4 = reinterpret_cast<uint4*>(g + head);
#pragma unroll
  for (int i = 0; i < RowLoad<T, kRows>::kLoads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < vecs) {
      const int r = head + kVec * p;
      Chunk<T> c;
#pragma unroll
      for (int j = 0; j < kVec; ++j) c.row[j] = s[pad<T>(r + j)];
      g4[p] = c.raw;
    }
  }
  const int t = threadIdx.x;
  if (t < head) g[t] = s[pad<T>(t)];
  if (t >= kVec && t - kVec < count - tail) g[tail + t - kVec] = s[pad<T>(tail + t - kVec)];
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
  static constexpr int kRows = kTile;
  struct Smem {
    uint64_t a[pad<uint64_t>(kRows)];
    uint64_t b[pad<uint64_t>(kRows)];
    alignas(16) uint8_t f[kRows + 16];
  };
  const uint8_t* flags;
  const uint64_t* k1;
  const uint64_t* k2;
  uint64_t* o1;
  uint64_t* o2;
  __device__ int load(Smem& s, int64_t at, int count) const {
    RowLoad<uint64_t, kRows> a, b;
    FlagLoad f;
    a.fetch(k1 + at, count);
    b.fetch(k2 + at, count);
    f.fetch(flags + at, count);
    a.put(s.a);
    b.put(s.b);
    return f.put(s.f);
  }
  __device__ Elem<M> get(const Smem& s, int off, int m) const {
    return Elem<M>{M::V{s.a[pad<uint64_t>(m)], s.b[pad<uint64_t>(m)]}, s.f[off + m] ? 1u : 0u};
  }
  __device__ void put(Smem& s, int m, const M::V& v) const {
    s.a[pad<uint64_t>(m)] = v.a;
    s.b[pad<uint64_t>(m)] = v.b;
  }
  __device__ void store(const Smem& s, int64_t at, int count) const {
    store_rows<uint64_t, kRows>(o1 + at, count, s.a);
    store_rows<uint64_t, kRows>(o2 + at, count, s.b);
  }
};

// One tile of kernel S or X in shared memory: one column of T, combined by M.
template <class Monoid, class T, int kTileRows>
struct ColumnTile {
  using M = Monoid;
  static constexpr int kRows = kTileRows;
  struct Smem {
    T v[pad<T>(kRows)];
    alignas(16) uint8_t f[kRows + 16];
  };
  const uint8_t* flags;
  const T* v;
  T* out;
  __device__ int load(Smem& s, int64_t at, int count) const {
    RowLoad<T, kRows> a;
    FlagLoad f;
    a.fetch(v + at, count);
    f.fetch(flags + at, count);
    a.put(s.v);
    return f.put(s.f);
  }
  __device__ Elem<M> get(const Smem& s, int off, int m) const {
    return Elem<M>{s.v[pad<T>(m)], s.f[off + m] ? 1u : 0u};
  }
  __device__ void put(Smem& s, int m, T x) const { s.v[pad<T>(m)] = x; }
  __device__ void store(const Smem& s, int64_t at, int count) const { store_rows<T, kRows>(out + at, count, s.v); }
};

using SumTile = ColumnTile<Sum, uint64_t, kTile>;
using XorTile = ColumnTile<Xor, uint32_t, kXorRows>;

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

// Tile t covers scan positions [t*R, t*R + count), R = Tile::kRows.
// Forward, that is memory from `at` on; reversed, memory [n - t*R - count,
// n - t*R) read backwards, so the ragged tile lies at the start of
// memory. Blocks wait only on tiles of a lower blockIdx, which are
// dispatched before them.
template <class Tile>
__global__ void __launch_bounds__(kThreads) lookback_scan(Tile io, int64_t n, int reverse, LookBack<typename Tile::M> lb) {
  using M = typename Tile::M;
  __shared__ typename Tile::Smem s;
  __shared__ Elem<M> warp_tot[kWarps];
  __shared__ Elem<M> tile_prefix;
  const int64_t tile = blockIdx.x;
  constexpr int kRows = Tile::kRows, kItemsT = kRows / kThreads;
  const int64_t start = tile * kRows;
  const int count = (int)(n - start < kRows ? n - start : kRows);
  const int64_t at = reverse ? n - start - count : start;
  const int off = io.load(s, at, count);
  __syncthreads();
  const int base = threadIdx.x * kItemsT;
  Elem<M> acc = identity<M>();
#pragma unroll
  for (int i = 0; i < kItemsT; ++i) {
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
  for (int i = 0; i < kItemsT; ++i) {
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
  const int64_t tiles = (n + Tile::kRows - 1) / Tile::kRows;
  if (tiles > scratch_tiles || tiles > 0x7fffffff || epoch == 0 || epoch >= kEpochLimit)
    return (int)cudaErrorInvalidValue;
  uint8_t* base = static_cast<uint8_t*>(scratch);
  V* agg = reinterpret_cast<V*>(base + status_bytes(scratch_tiles));
  LookBack<typename Tile::M> lb{reinterpret_cast<uint32_t*>(base), agg, agg + scratch_tiles, epoch};
  lookback_scan<Tile><<<(unsigned)tiles, kThreads, 0, stream>>>(io, n, reverse, lb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile of the look-back scans L and S, the unit of the scratch
// (X's tiles are twice as large, so it needs fewer).
long long evolu_seg_scan_tile_rows(void) { return kTile; }

// Bytes of look-back scratch for `tiles` tiles: status words, then the
// aggregates and the inclusive prefixes, sized for L's 16-byte values
// (S uses the first half of each, X the first quarter). Zero it once; the
// epoch does the rest.
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

// Kernel X. flags: n bytes (0/1), segment starts; v: n u32; out: n u32;
// scratch and epoch as for kernel L.
int evolu_seg_xor_scan(const void* flags, const void* v, void* out, long long n, void* scratch,
                       long long scratch_tiles, unsigned epoch, void* stream) {
  XorTile io{static_cast<const uint8_t*>(flags), static_cast<const uint32_t*>(v),
             static_cast<uint32_t*>(out)};
  return run_lookback(io, n, 0, scratch, scratch_tiles, epoch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

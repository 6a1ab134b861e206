// Power-distributor kernels of the correlated field, for Hopper (sm_90a).
//
//   bin_gather:       out[b, j] = table[b, idx[j]]
//   bin_segment_sum:  out[b, k] = sum_{j : idx[j] = k} cot[b, j]
//
// One shared index map serves every batch row.  These two kernels replace
// all four Pallas kernels of nifty_tpu/ops/pallas_gather.py: the gather
// replaces the select loop _pallas_gather (:184, K1) and the MXU one-hot
// _pallas_gather_mxu (:369, K3); the segment sum replaces _pallas_scatter
// (:228, K2) and _pallas_scatter_mxu (:406, K4).  A Hopper block holds a
// 1621-entry float64 table (13 KB) or a 113-entry one in shared memory, so
// the TPU's split by table size has no counterpart here.
//
// bin_gather.  Its two main-path shapes are bound by different things:
//  - 4096^2 with 128 log bins, a (1, 113) table over the 2049^2 quarter
//    map (K1's shape): device-memory traffic, the index read plus the
//    sizeof(T) store per entry.
//    * The index map is read at the narrowest width that holds the bin
//      count (uint8 up to 256 bins, int16 up to 32,768, else int32;
//      BinIndex.idx_narrow), so a float64 entry moves 9 B, not 12.
//    * Entries go in groups of 16 / sizeof(T), one 16-byte double2/float4
//      store each, and every warp instruction covers one contiguous span:
//      thread t of the grid takes groups t, t + T, ... (T threads), four
//      float64 groups (two float32) a step, loaded before any is stored.
//      (Eight consecutive entries per thread, i.e. a 64-byte stride
//      between the lanes of one store, took 2.5x as long.)
//    * Stores are streaming (st.global.cs): on an H100 80GB HBM3 at
//      700 W they halved the kernel's time at this shape against
//      write-back stores; the next op then finds less of the output in L2,
//      which costs it less than the kernel saves.
//    * The grid holds at most four waves of resident blocks, so the last
//      wave is short; a block strides over the map beyond that.
//  - 128^2 unbinned, an (8, 1621) table over 128^2 entries in the stacked
//    KL stage (K3's shape): the host's launch path, as the device moves
//    1 MB in a few microseconds.  The launcher queries each device's
//    constants once (SM count, shared memory, resident blocks per
//    instantiation), calls cudaFuncSetAttribute only when a launch needs
//    more dynamic shared memory than was set before, and then launches.
// Rows: each block stages the tables of a tile of rows in shared memory,
// and one index load serves every row of the tile.  A tile holds as many
// rows as fit in half an SM's shared memory (so two blocks still fit on
// an SM), and rows are split further only while the grid would have
// fewer blocks than the card has SMs: 128^2 with B = 8 then runs one row
// per tile on 64 blocks instead of all 8 rows on 8 blocks (2.6 against
// 7.1 us on the card above, with write-back stores).
//  - Grid-scale unbinned maps (82,799 modes on the 513^2 quarter map of a
//    1024^2 grid, 1,197,363 on the 2049^2 one of 4096^2): the table, 662 KB
//    to 9.6 MB a float64 row, is above the 227 KB opt-in limit of shared
//    memory and sits in L2, where every entry costs a 32-byte sector and
//    its own line look-up in L1 for 8 useful bytes; with an int32 index the
//    kernel is bound by those scattered reads, not by device memory.
//    * With one or two rows the table is read as it is (__ldg), one row a
//      tile (nothing is shared between rows but the index load, an L2 hit)
//      and one 16-byte group a thread and step, so that the grid fills the
//      card at one row.
//    * Where the host passes scratch for it (from three rows on, if the
//      copy fits in half of L2: rows_innermost_columns in
//      ops/bin_gather.py holds the rule), the table is
//      first copied rows-innermost, (nb, B), so that one entry's rows are
//      one or two sectors of one line, and the gather turns each warp's
//      span through shared memory for the 16-byte stores (see "gather from
//      a rows-innermost copy" below): two kernels a call.
// Row starts are 16-byte aligned only when B * n keeps them so (n odd and
// B > 1 does not): a misaligned row stores its groups one entry at a
// time, and the last n % (16 / sizeof(T)) entries of every row are a
// scalar tail of the last block.  Both stay inside the one kernel.
//
// bin_segment_sum is a gather through the permutation of a stable sort
// plus a segmented reduction over its CSR offsets, with no atomics, so its
// results are bitwise reproducible.  The host cuts the segments into work
// from the offsets and a few constants alone (see "segment sum" below), so
// the order of every bin's additions is fixed by the map:
//  - a bin of at most 32 entries (every bin of an unbinned map, nearly:
//    mean length 3.2 to 3.5 on the quarter maps of 1024^2 to 4096^2 grids,
//    99 % of the bins 8 entries or less) shares its warp with others: by
//    its length alone it belongs to a class of width 4, 8 or 32 lanes, and
//    w adjacent lanes sum it, one lane an entry, with a butterfly over
//    those lanes, which gives the bits of a whole warp's butterfly; each
//    class is a list of bin number, segment start and length (9 bytes a
//    bin), cut into pieces that the blocks take in bin order;
//  - a longer bin is cut into chunks of at most C = kChunk entries, each
//    one block: thread t adds entries t, t + 256, ... of its chunk in
//    order, then a butterfly in each warp and one over the warps' sums; a
//    bin of more than one chunk writes one partial per chunk, and a second
//    small kernel sums each such bin's partials (a warp per bin and row,
//    lane l taking chunks l, l + 32, ...), so a call is one launch where no
//    bin is split (the unbinned maps) and two where one is (4096^2 with
//    128 log bins);
//  - a block serves a tile of up to 8 rows and loads each permutation
//    entry once for all of them.
// What bounds it: at 4096^2 with 128 log bins (4,198,401 entries in 113
// bins, the largest 366,891) the 4 B permutation plus sizeof(T) B
// cotangent read per entry, 50.4 MB in float64, on ~2100 blocks; the
// cotangent read is a gather, coalesced where the permutation runs over
// consecutive entries (108 on average there).  At 128^2 unbinned (1621
// bins of at most 32 entries, 8 rows in the stacked KL stage) the data
// (1 MB) sits in L2 and the time is a few microseconds of latency.
// C = 2048: at 4096^2 C = 4096 took 2-6 % longer and C = 8192 60 % longer
// (fewer, fatter blocks) on an H100 80GB HBM3 at 700 W.  At the unbinned
// quarter maps the cotangent reads are scattered 8-byte reads, a 32-byte
// sector each, from L2 at 1024^2 and from device memory at 4096^2, where
// the order of the blocks decides how often a sector is fetched.

// The C entry points return the number of kernels they launched, or the
// cudaError_t that stopped them (cudaGetLastError() after a launch)
// negated.  The Python wrapper raises on an error.
// Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // gather elements per thread and step, staged tables
constexpr int kInnerRows = 8;  // rows of a rows-innermost tile
constexpr int kWaves = 4;  // gather grid: at most this many waves of resident blocks
constexpr int kMaxDevices = 64;

// -- gather: index loads and stores ---------------------------------------
// The map is split into groups of V = 16 / sizeof(T) entries, one 16-byte
// store each.  Thread t of a step takes groups t, t + T, t + 2T, ... (T
// threads in the grid), so every load and store instruction of a warp
// covers one contiguous span.  The map is 16-byte aligned (checked by the
// launcher), so a group's V entries are one aligned load of V * sizeof(I)
// bytes.

template <int kBytes> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

template <typename I, int V>
__device__ __forceinline__ void load_group(const I* idx, long long g, int (&k)[V]) {
  using W = typename Word<V * sizeof(I)>::type;
  union { W w; I e[V]; } u;
  u.w = __ldg(reinterpret_cast<const W*>(idx) + g);
#pragma unroll
  for (int e = 0; e < V; ++e) k[e] = u.e[e];  // entries are in [0, nb): no sign
}

__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// -- gather kernel --------------------------------------------------------
// blockIdx.y: a tile of up to `tile_rows` rows; blockIdx.x strides over the
// groups.  kStaged: the tile's tables sit in dynamic shared memory; else
// they are read through __ldg, one row a tile and one group a thread and
// step.

template <typename T, typename I, bool kStaged>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ table, const I* __restrict__ idx,
              T* __restrict__ out, long long n, int nb, int nrows, int tile_rows) {
  constexpr int V = 16 / sizeof(T);  // entries per group
  constexpr int U = kStaged ? kVec / V : 1;  // groups per thread and step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r0 = blockIdx.y * tile_rows;
  const int nr = min(tile_rows, nrows - r0);
  const T* gtab = table + static_cast<long long>(r0) * nb;
  T* stab = reinterpret_cast<T*>(smem_raw);
  if constexpr (kStaged) {
    // the tile's rows are one contiguous span of nr * nb entries
    const int total = nr * nb;
    for (int k = threadIdx.x; k < total; k += kThreads) stab[k] = __ldg(gtab + k);
    __syncthreads();
  }
  auto lookup = [&](int r, int k) -> T {
    if constexpr (kStaged) return stab[r * nb + k];
    else return __ldg(gtab + static_cast<long long>(r) * nb + k);
  };
  T* orow = out + static_cast<long long>(r0) * n;
  const long long groups = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       g0 < groups; g0 += U * stride) {
    int k[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (g0 + u * stride < groups) load_group<I, V>(idx, g0 + u * stride, k[u]);
    }
    // one index load serves every row of the tile
    for (int r = 0; r < nr; ++r) {
      T* o = orow + r * n;
      // a row starts off a 16-byte boundary when (r0 + r) * n is not a
      // multiple of V: its groups store one entry at a time
      const bool aligned = (reinterpret_cast<uintptr_t>(o) & 15) == 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long g = g0 + u * stride;
        if (g < groups) {
          T v[V];
#pragma unroll
          for (int e = 0; e < V; ++e) v[e] = lookup(r, k[u][e]);
          if (aligned) {
            store16(o + g * V, v);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) __stcs(o + g * V + e, v[e]);
          }
        }
      }
    }
  }
  // the ragged end of each row: the last n % V entries, one thread each
  const long long j = groups * V + threadIdx.x;
  if (blockIdx.x == gridDim.x - 1 && j < n) {
    const int kj = idx[j];
    for (int r = 0; r < nr; ++r) __stcs(orow + r * n + j, lookup(r, kj));
  }
}

// -- gather from a rows-innermost copy of a large table -------------------
// A table too large to stage costs a 32-byte sector of L2 traffic, and a
// cache line's tag look-up in L1, for every entry and row.  With several
// rows the (B, nb) table is first copied to (nb, Bp) (Bp: B rounded up to a
// 16-byte group), so that one entry's rows are contiguous: 64 bytes, two
// sectors of one line, for 8 float64 rows instead of eight lines.  In the
// gather kInnerLanes adjacent lanes then load one entry's rows of a tile of
// kInnerRows with one 16-byte load each, so a warp instruction covers
// 32 / kInnerLanes entries, one line each; a warp takes 32 groups of V
// entries at a time, turns them through shared memory, and stores one
// 16-byte group a lane to each row, every store instruction on one
// contiguous span as above.

// One thread a 16-byte group of the copy: V rows of one bin.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_innermost_kernel(const T* __restrict__ table, T* __restrict__ tt, int nb, int nrows,
                      int bp) {
  constexpr int V = 16 / sizeof(T);
  const int per_bin = bp / V;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(nb) * per_bin) return;
  const int k = static_cast<int>(t / per_bin);
  const int r = static_cast<int>(t % per_bin) * V;
  T w[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    w[e] = r + e < nrows ? __ldg(table + static_cast<long long>(r + e) * nb + k) : T(0);
  }
  // a plain store: the gather reads it next
  T* dst = tt + t * V;
  if constexpr (sizeof(T) == 8) *reinterpret_cast<double2*>(dst) = make_double2(w[0], w[1]);
  else *reinterpret_cast<float4*>(dst) = make_float4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, T (&v)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 8) {
    const double2 w = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = w.x; v[1] = w.y;
  } else {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
}

// blockIdx.y: a tile of kInnerRows rows; the warps of blockIdx.x stride
// over spans of 32 groups.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows_innermost_kernel(const T* __restrict__ tt, const I* __restrict__ idx,
                             T* __restrict__ out, long long n, int nrows, int bp) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kInnerLanes = kInnerRows / V;  // lanes an entry
  constexpr int E = 32 / kInnerLanes;          // entries a load instruction
  constexpr int kSpan = 32 * V;                // entries a warp and step
  constexpr int kPitch = kSpan + V;            // a row of the turn, padded against bank conflicts
  __shared__ __align__(16) T turn[kThreads / 32][kInnerRows][kPitch];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * kInnerRows;
  const int nr = min(kInnerRows, nrows - r0);
  const T* trow = tt + r0;
  T* orow = out + static_cast<long long>(r0) * n;
  const long long groups = n / V;
  const long long whole = groups * V;  // entries in whole groups
  const int e = lane / kInnerLanes;
  const int q = lane % kInnerLanes * V;  // first row of this lane's load
  const long long stride = static_cast<long long>(gridDim.x) * (kThreads / 32) * kSpan;
  for (long long base = (static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp) * kSpan;
       base < whole; base += stride) {
    int k[kSpan / E];
#pragma unroll
    for (int i = 0; i < kSpan / E; ++i) {
      const long long j = base + i * E + e;
      k[i] = j < whole ? static_cast<int>(idx[j]) : -1;
    }
#pragma unroll
    for (int i = 0; i < kSpan / E; ++i) {
      if (k[i] >= 0 && q < nr) {
        T w[V];
        load16(trow + static_cast<long long>(k[i]) * bp + q, w);
#pragma unroll
        for (int x = 0; x < V; ++x) turn[warp][q + x][i * E + e] = w[x];
      }
    }
    __syncwarp();
    const long long g = base / V + lane;
    if (g < groups) {
#pragma unroll
      for (int r = 0; r < kInnerRows; ++r) {
        if (r < nr) {
          T w[V];
#pragma unroll
          for (int x = 0; x < V; ++x) w[x] = turn[warp][r][lane * V + x];
          T* o = orow + r * n + g * V;
          // a row starts off a 16-byte boundary when (r0 + r) * n is not a
          // multiple of V: its groups store one entry at a time
          if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
            store16(o, w);
          } else {
#pragma unroll
            for (int x = 0; x < V; ++x) __stcs(o + x, w[x]);
          }
        }
      }
    }
    __syncwarp();
  }
  // the ragged end of each row: the last n % V entries, one thread each
  const long long j = whole + threadIdx.x;
  if (blockIdx.x == gridDim.x - 1 && j < n) {
    const long long kj = idx[j];
    for (int r = 0; r < nr; ++r) __stcs(orow + r * n + j, __ldg(trow + kj * bp + r));
  }
}

// -- gather launch path ---------------------------------------------------

struct DeviceInfo {
  std::atomic<int> ready{0};
  int sms = 0, optin = 0, smem_per_sm = 0, reserved = 0, l2 = 0;
  // per instantiation, [float, double] x [uint8, int16, int32] x
  // [__ldg, staged]: resident blocks per SM as registers allow (0: not yet
  // asked), and the dynamic shared memory set with cudaFuncSetAttribute
  std::atomic<int> blocks[2][3][2] = {};
  std::atomic<int> inner_blocks[2][3] = {};  // the rows-innermost gather's
  std::atomic<int> smem_set[2][3] = {};
};

DeviceInfo g_devices[kMaxDevices];
std::mutex g_mutex;

cudaError_t device_info(int dev, DeviceInfo** out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_devices[dev];
  if (!d.ready.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (!d.ready.load(std::memory_order_relaxed)) {
      const struct { int* dst; cudaDeviceAttr attr; } q[] = {
          {&d.sms, cudaDevAttrMultiProcessorCount},
          {&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin},
          {&d.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor},
          {&d.reserved, cudaDevAttrReservedSharedMemoryPerBlock},
          {&d.l2, cudaDevAttrL2CacheSize},
      };
      for (const auto& e : q) {
        const cudaError_t err = cudaDeviceGetAttribute(e.dst, e.attr, dev);
        if (err != cudaSuccess) return err;
      }
      d.ready.store(1, std::memory_order_release);
    }
  }
  *out = &d;
  return cudaSuccess;
}

template <typename I> constexpr int index_slot();
template <> constexpr int index_slot<uint8_t>() { return 0; }
template <> constexpr int index_slot<int16_t>() { return 1; }
template <> constexpr int index_slot<int32_t>() { return 2; }

// Resident blocks per SM of `kernel` as its registers allow, asked once.
template <typename K>
cudaError_t blocks_per_sm(std::atomic<int>& cache, K kernel, int* out) {
  int v = cache.load(std::memory_order_acquire);
  if (v == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (v < 1) v = 1;
    cache.store(v, std::memory_order_release);
  }
  *out = v;
  return cudaSuccess;
}

// The gather through a rows-innermost copy `tt` (scratch of nb * Bp values,
// Bp = nrows rounded up to a 16-byte group): two kernels.
template <typename T, typename I>
cudaError_t launch_gather_rows_innermost(DeviceInfo* d, const T* table, const I* idx, T* tt,
                                         T* out, long long n, int nb, int nrows,
                                         cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int bp = (nrows + V - 1) / V * V;
  const long long copy_threads = static_cast<long long>(nb) * (bp / V);
  rows_innermost_kernel<T><<<static_cast<unsigned>((copy_threads + kThreads - 1) / kThreads),
                             kThreads, 0, stream>>>(table, tt, nb, nrows, bp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = blocks_per_sm(d->inner_blocks[sizeof(T) == 8][index_slot<I>()],
                      gather_rows_innermost_kernel<T, I>, &per_sm);
  if (err != cudaSuccess) return err;
  const long long tiles = (nrows + kInnerRows - 1) / kInnerRows;
  const long long per_block = static_cast<long long>(kThreads) * V;
  const long long gx_need = n >= per_block ? (n + per_block - 1) / per_block : 1;
  long long gx = static_cast<long long>(kWaves) * d->sms * per_sm / tiles;
  if (gx < 1) gx = 1;
  if (gx > gx_need) gx = gx_need;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(tiles));
  gather_rows_innermost_kernel<T, I><<<grid, kThreads, 0, stream>>>(tt, idx, out, n, nrows, bp);
  return cudaGetLastError();
}

// `kernels`: the number launched.  `tt`: scratch for the rows-innermost
// copy, or NULL for the direct routes.
template <typename T, typename I>
cudaError_t launch_gather_on(const T* table, const I* idx, T* tt, T* out, long long n,
                             int nb, int nrows, int dev, cudaStream_t stream, int* kernels) {
  DeviceInfo* d = nullptr;
  cudaError_t err = device_info(dev, &d);
  if (err != cudaSuccess) return err;
  if (tt != nullptr) {
    *kernels = 2;
    return launch_gather_rows_innermost<T, I>(d, table, idx, tt, out, n, nb, nrows, stream);
  }
  *kernels = 1;

  constexpr int V = 16 / sizeof(T);
  const long long row_bytes = static_cast<long long>(nb) * sizeof(T);
  const bool staged = row_bytes <= d->optin;
  // entries a block takes a step
  const long long per_block =
      static_cast<long long>(kThreads) * (staged ? kVec : V);
  const long long gx_need = n >= per_block ? (n + per_block - 1) / per_block : 1;
  // staged rows per tile: as many as fit in half an SM's shared memory, then
  // split further while the grid has fewer blocks than the card has SMs.
  // Nothing is shared between the rows of a table read from global memory
  // but the index load, an L2 hit: one row a tile.
  long long tiles = nrows;
  if (staged) {
    long long budget = d->smem_per_sm / 2 - d->reserved;
    if (budget < row_bytes) budget = row_bytes;
    const long long fit = budget / row_bytes;
    tiles = (nrows + fit - 1) / fit;
    const long long fill = (d->sms + gx_need - 1) / gx_need;
    if (tiles < fill) tiles = fill < nrows ? fill : nrows;
  }
  const long long tile_rows = (nrows + tiles - 1) / tiles;
  tiles = (nrows + tile_rows - 1) / tile_rows;
  const long long smem = staged ? tile_rows * row_bytes : 0;

  // a few waves of resident blocks, so that the last wave is short
  int by_regs = 0;
  std::atomic<int>& cache = d->blocks[sizeof(T) == 8][index_slot<I>()][staged];
  err = staged ? blocks_per_sm(cache, gather_kernel<T, I, true>, &by_regs)
               : blocks_per_sm(cache, gather_kernel<T, I, false>, &by_regs);
  if (err != cudaSuccess) return err;
  long long per_sm = by_regs;
  if (staged) {
    const long long by_smem = d->smem_per_sm / (smem + d->reserved);
    if (by_smem < per_sm) per_sm = by_smem;
  }
  if (per_sm < 1) per_sm = 1;
  long long gx = kWaves * d->sms * per_sm / tiles;
  if (gx < 1) gx = 1;
  if (gx > gx_need) gx = gx_need;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(tiles));

  if (staged) {
    std::atomic<int>& set = d->smem_set[sizeof(T) == 8][index_slot<I>()];
    if (smem > 48 * 1024 && smem > set.load(std::memory_order_acquire)) {
      std::lock_guard<std::mutex> lock(g_mutex);
      if (smem > set.load(std::memory_order_relaxed)) {
        err = cudaFuncSetAttribute(gather_kernel<T, I, true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        set.store(static_cast<int>(smem), std::memory_order_release);
      }
    }
    gather_kernel<T, I, true><<<grid, kThreads, smem, stream>>>(
        table, idx, out, n, nb, nrows, static_cast<int>(tile_rows));
  } else {
    gather_kernel<T, I, false><<<grid, kThreads, 0, stream>>>(
        table, idx, out, n, nb, nrows, static_cast<int>(tile_rows));
  }
  return cudaGetLastError();
}

// Run `launch` with `dev`, the device that holds the tensors, current:
// switch to it only when it is not already, and back afterwards.
template <typename F>
int on_device(int dev, F&& launch) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cur != dev && (err = cudaSetDevice(dev)) != cudaSuccess) return static_cast<int>(err);
  err = launch();
  if (cur != dev) {
    const cudaError_t back = cudaSetDevice(cur);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// The number of kernels launched (0, 1, or 2 with the rows-innermost copy),
// or the cudaError_t that stopped the call, negated.
template <typename T, typename I>
int launch_gather(const void* table, const void* idx, void* scratch, void* out, long long n,
                  int nb, int nrows, int dev, void* stream) {
  if (n == 0 || nrows == 0) return 0;
  if (reinterpret_cast<uintptr_t>(idx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return -static_cast<int>(cudaErrorMisalignedAddress);
  }
  int kernels = 0;
  const int err = on_device(dev, [&] {
    return launch_gather_on<T, I>(static_cast<const T*>(table), static_cast<const I*>(idx),
                                  static_cast<T*>(scratch), static_cast<T*>(out), n, nb,
                                  nrows, dev, static_cast<cudaStream_t>(stream), &kernels);
  });
  return err != 0 ? -err : kernels;
}

// -- segment sum ----------------------------------------------------------
// The host (BinIndex, segment_work_items in ops/bin_gather.py) cuts the CSR
// segments of the stable sort into work from the offsets and the constants
// below alone.
//  - Short bins (at most kShort = 32 entries, empty ones too) go by length
//    into classes of width w in kWidths: a bin of at most w entries is
//    summed by w adjacent lanes, one lane an entry, with a butterfly over
//    those w lanes, so a warp serves 32 / w bins.  Each class is a list of
//    {bin number, segment start, length} in bin order (int32, int32 and
//    uint8 side by side, so that a group's three loads go out together),
//    cut into pieces that the blocks take in the order of the pieces'
//    first bins.  The w-lane butterfly gives the bits of a whole warp's:
//    with at most w entries the 32-lane butterfly's steps 16 ... w add exact
//    zeros (only the sign of a zero sum can differ).
//  - Longer bins are cut into block items {bin, lo, hi, slot} of at most
//    kChunk entries.  A chunk of a split bin writes its partial to
//    partials[row, slot]; every other item writes out[row, bin] itself.
// Each bin's order of additions is fixed by its length and these constants,
// never by the grid, the card or the number of rows, so two cards give the
// same bits.

// The host's work uses the same sizes (SEGMENT_CHUNK, SHORT_SEGMENT,
// SHORT_WIDTHS and SHORT_VALUES in ops/bin_gather.py); its loader checks
// them against bin_segment_sum_chunk(), bin_segment_sum_short(),
// bin_segment_sum_widths() and bin_segment_sum_values().
constexpr int kChunk = 2048;  // entries of a block's item at most
constexpr int kShort = 32;    // entries of a short bin at most
constexpr int kWidths[] = {4, 8, 32};  // lanes a short bin, by class
constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);
constexpr int kMaxWidths = 4;  // class counts a C entry takes
static_assert(kNumWidths <= kMaxWidths, "the C entries take kMaxWidths class counts");
static_assert(kWidths[kNumWidths - 1] == kShort && kShort == 32,
              "the widest class is one warp, one lane per entry");
constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kPerThread = kChunk / kSegThreads;  // entries a thread adds
constexpr int kRowTile = kSegWarps;               // rows a block serves
static_assert(kChunk % kSegThreads == 0, "a chunk is a whole number of strides");

struct ShortCounts { int n[kMaxWidths]; };  // bins in each class

// Cotangent values a lane of a short bin holds at once: with R rows in
// registers a lane group takes U = kShortValues / R bins (at least one),
// all their loads issued before any sum.  A class's list is cut into
// pieces of kShortValues * kSegThreads / w bins, U of them a block; the
// host lists the pieces' starts in the order of their first bins
// (`pieces`), so that blocks run over the map in bin order whatever their
// class: bins next to each other share cotangent sectors, and a map too
// large for L2 would read them once for each class otherwise.
constexpr int kShortValues = 2;
__host__ __device__ constexpr int short_unroll(int rows) {
  return kShortValues > rows ? kShortValues / rows : 1;
}

// A butterfly over groups of W adjacent lanes: every lane of a group ends
// with the group's sum (addition commutes), in an order fixed by the lanes
// alone.
template <int W, typename T>
__device__ __forceinline__ T lanes_sum(T v) {
#pragma unroll
  for (int s = W / 2; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) { return lanes_sum<32>(v); }

// One block's share of a class of bins of at most W entries: the bins
// `first` ... of the list `bins`, up to `end`; W lanes a bin, R rows of the
// tile in registers, each permutation entry loaded once for all of them.  A
// lane group takes bins g, g + G, ... (G groups a block), so that each
// store instruction of a warp goes to bins next to each other in the class.
template <typename T, int R, int W>
__device__ __forceinline__ void short_bins_sum(
    const T* __restrict__ crow, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ bins, const int32_t* __restrict__ los,
    const uint8_t* __restrict__ lens, T* __restrict__ orow, long long n, int nb, int first,
    int end, int nr) {
  constexpr int U = short_unroll(R);
  constexpr int G = kSegThreads / W;
  const int g0 = first + threadIdx.x / W;
  const int sub = threadIdx.x % W;
  int bin[U], lo[U], len[U], j[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int g = g0 + u * G;
    bin[u] = g < end ? __ldg(bins + g) : -1;
    lo[u] = g < end ? __ldg(los + g) : 0;
    len[u] = g < end ? __ldg(lens + g) : 0;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) j[u] = sub < len[u] ? __ldg(perm + lo[u] + sub) : -1;
  T v[U][R];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[u][r] = j[u] >= 0 && r < nr ? __ldg(crow + r * n + j[u]) : T(0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        const T sum = lanes_sum<W>(v[u][r]);
        if (bin[u] >= 0 && sub == 0) orow[static_cast<long long>(r) * nb + bin[u]] = sum;
      }
    }
  }
}

// The class C or later whose part [begin, begin + counts.n[C]) of the list
// holds the piece that starts at `start`; `part`: this block's part of the
// piece.
template <typename T, int R, int C>
__device__ __forceinline__ void short_class(
    const T* __restrict__ crow, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ bins, const int32_t* __restrict__ los,
    const uint8_t* __restrict__ lens, T* __restrict__ orow, long long n, int nb,
    const ShortCounts& counts, int begin, int start, int part, int nr) {
  if constexpr (C < kNumWidths) {
    constexpr int W = kWidths[C];
    const int end = begin + counts.n[C];
    if (start < end) {
      const int first = start + part * (kSegThreads / W * short_unroll(R));
      short_bins_sum<T, R, W>(crow, perm, bins, los, lens, orow, n, nb, first, end, nr);
    } else {
      short_class<T, R, C + 1>(crow, perm, bins, los, lens, orow, n, nb, counts, end, start,
                               part, nr);
    }
  }
}

// blockIdx.x < short_blocks: the short bins, kShortValues / U blocks a
// piece; else one block item, thread t adding entries lo + t + i * 256 in
// order of i, then a butterfly in each warp and one over the warps' sums.
// blockIdx.y: a tile of up to kRowTile rows, each permutation entry loaded
// once for all of them.  R: the rows the short bins' lanes hold in
// registers, the least power of two that holds the tile.
template <typename T, int R>
__global__ void __launch_bounds__(kSegThreads)
segment_sum_kernel(const T* __restrict__ cot, const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ bins, const int32_t* __restrict__ los,
                   const uint8_t* __restrict__ lens, const int32_t* __restrict__ pieces,
                   const ShortCounts counts,
                   const int4* __restrict__ items,
                   T* __restrict__ out, T* __restrict__ partials, long long n, int nb,
                   int short_blocks, int n_slots, int nrows) {
  const int r0 = blockIdx.y * kRowTile;
  const int nr = min(kRowTile, nrows - r0);
  const T* crow = cot + static_cast<long long>(r0) * n;
  if (static_cast<int>(blockIdx.x) < short_blocks) {
    constexpr int kParts = kShortValues / short_unroll(R);  // blocks a piece
    const int start = __ldg(pieces + blockIdx.x / kParts);
    short_class<T, R, 0>(crow, perm, bins, los, lens, out + static_cast<long long>(r0) * nb,
                         n, nb, counts, 0, start, blockIdx.x % kParts, nr);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ T part[kRowTile][kSegWarps];
  const int4 it = __ldg(items + (blockIdx.x - short_blocks));
  const int len = it.z - it.y;
  int j[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int q = threadIdx.x + i * kSegThreads;
    j[i] = q < len ? __ldg(perm + it.y + q) : -1;
  }
#pragma unroll 1
  for (int r = 0; r < nr; ++r) {
    const T* c = crow + r * n;
    T v[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) v[i] = j[i] >= 0 ? __ldg(c + j[i]) : T(0);
    T acc = v[0];
#pragma unroll
    for (int i = 1; i < kPerThread; ++i) acc += v[i];
    acc = warp_sum(acc);
    if (lane == 0) part[r][warp] = acc;
  }
  __syncthreads();
  // warp r sums row r over the warps
  if (warp < nr) {
    const T sum = warp_sum(lane < kSegWarps ? part[warp][lane] : T(0));
    if (lane == 0) {
      const long long r = r0 + warp;
      if (it.w < 0) out[r * nb + it.x] = sum;
      else partials[r * n_slots + it.w] = sum;
    }
  }
}

// The second pass, for split bins only: a warp per (split bin, row) sums
// the bin's chunk partials {bin, first slot, chunks}; lane l takes chunks
// l, l + 32, ... in order, then a butterfly.
template <typename T>
__global__ void __launch_bounds__(kSegThreads)
combine_kernel(const T* __restrict__ partials, const int4* __restrict__ split,
               T* __restrict__ out, int nb, int n_split, int n_slots) {
  const int s = blockIdx.x * kSegWarps + (threadIdx.x >> 5);
  if (s >= n_split) return;
  const int lane = threadIdx.x & 31;
  const int4 sp = __ldg(split + s);
  const long long r = blockIdx.y;
  const T* prow = partials + r * n_slots + sp.y;
  T acc = T(0);
  for (int c = lane; c < sp.z; c += 32) acc += prow[c];
  acc = warp_sum(acc);
  if (lane == 0) out[r * nb + sp.x] = acc;
}

template <typename T>
cudaError_t launch_segment_sum_on(const T* cot, const int32_t* perm, const int32_t* bins,
                                  const int32_t* los, const uint8_t* lens,
                                  const int32_t* pieces, const ShortCounts& counts,
                                  const int4* items,
                                  const int4* split, T* partials, T* out, long long n, int nb,
                                  int n_pieces, int n_items, int n_split, int n_slots,
                                  int nrows, cudaStream_t stream) {
  // every bin is short or has a block item, so the grid is never empty
  // the short bins' lanes hold no more rows than the call has
  const int rows = nrows == 1 ? 1 : nrows == 2 ? 2 : nrows <= 4 ? 4 : 8;
  const int short_blocks = n_pieces * (kShortValues / short_unroll(rows));
  const dim3 grid(static_cast<unsigned>(short_blocks + n_items),
                  static_cast<unsigned>((nrows + kRowTile - 1) / kRowTile));
  const auto kernel = rows == 1   ? segment_sum_kernel<T, 1>
                      : rows == 2 ? segment_sum_kernel<T, 2>
                      : rows == 4 ? segment_sum_kernel<T, 4>
                                  : segment_sum_kernel<T, 8>;
  kernel<<<grid, kSegThreads, 0, stream>>>(cot, perm, bins, los, lens, pieces, counts, items,
                                           out, partials, n, nb, short_blocks, n_slots, nrows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return err;
  const dim3 grid2(static_cast<unsigned>((n_split + kSegWarps - 1) / kSegWarps),
                   static_cast<unsigned>(nrows));
  combine_kernel<T><<<grid2, kSegThreads, 0, stream>>>(partials, split, out, nb, n_split,
                                                        n_slots);
  return cudaGetLastError();
}

// The number of kernels launched (0, 1, or 2 where a bin is split), or the
// cudaError_t that stopped the call, negated.  `bins`, `los`, `lens`: the
// short bins' numbers, segment starts and lengths, class after class, `c0`
// ... `c3` of them in the classes of kWidths; `pieces`: where in those
// lists each of the n_pieces pieces starts; `items`: the n_items block
// items.
template <typename T>
int launch_segment_sum(const void* cot, const void* perm, const void* bins, const void* los,
                       const void* lens, const void* pieces, const void* items,
                       const void* split, void* partials, void* out, long long n, int nb,
                       int c0, int c1, int c2, int c3, int n_pieces, int n_items, int n_split,
                       int n_slots, int nrows, int dev, void* stream) {
  if (nb == 0 || nrows == 0) return 0;
  if (reinterpret_cast<uintptr_t>(items) % 16 != 0 ||
      (n_split > 0 && reinterpret_cast<uintptr_t>(split) % 16 != 0)) {
    return -static_cast<int>(cudaErrorMisalignedAddress);
  }
  const ShortCounts counts = {{c0, c1, c2, c3}};
  for (int c = kNumWidths; c < kMaxWidths; ++c) {
    if (counts.n[c] != 0) return -static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = on_device(dev, [&] {
    return launch_segment_sum_on<T>(
        static_cast<const T*>(cot), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(bins), static_cast<const int32_t*>(los),
        static_cast<const uint8_t*>(lens), static_cast<const int32_t*>(pieces), counts,
        static_cast<const int4*>(items),
        static_cast<const int4*>(split), static_cast<T*>(partials), static_cast<T*>(out), n,
        nb, n_pieces, n_items, n_split, n_slots, nrows, static_cast<cudaStream_t>(stream));
  });
  if (err != 0) return -err;
  return n_split > 0 ? 2 : 1;
}

}  // namespace

extern "C" {

#define BIN_GATHER_ENTRY(name, T, I)                                                  \
  int name(const void* table, const void* idx, void* scratch, void* out, long long n, \
           int nb, int nrows, int dev, void* stream) {                                \
    return launch_gather<T, I>(table, idx, scratch, out, n, nb, nrows, dev, stream);  \
  }

BIN_GATHER_ENTRY(bin_gather_f32_u8, float, uint8_t)
BIN_GATHER_ENTRY(bin_gather_f32_i16, float, int16_t)
BIN_GATHER_ENTRY(bin_gather_f32_i32, float, int32_t)
BIN_GATHER_ENTRY(bin_gather_f64_u8, double, uint8_t)
BIN_GATHER_ENTRY(bin_gather_f64_i16, double, int16_t)
BIN_GATHER_ENTRY(bin_gather_f64_i32, double, int32_t)

#define BIN_SEGMENT_SUM_ENTRY(name, T)                                                    \
  int name(const void* cot, const void* perm, const void* bins, const void* los,          \
           const void* lens, const void* pieces, const void* items, const void* split,    \
           void* partials, void* out, long long n, int nb, int c0, int c1, int c2,        \
           int c3, int n_pieces, int n_items, int n_split, int n_slots, int nrows,        \
           int dev, void* stream) {                                                       \
    return launch_segment_sum<T>(cot, perm, bins, los, lens, pieces, items, split,        \
                                 partials, out, n, nb, c0, c1, c2, c3, n_pieces, n_items, \
                                 n_split, n_slots, nrows, dev, stream);                   \
  }

BIN_SEGMENT_SUM_ENTRY(bin_segment_sum_f32, float)
BIN_SEGMENT_SUM_ENTRY(bin_segment_sum_f64, double)

// The sizes the kernels were built for; the host's work must use them.
int bin_segment_sum_chunk() { return kChunk; }
int bin_segment_sum_short() { return kShort; }
// Writes the short classes' widths to `out` (room for 4); returns their number.
int bin_segment_sum_widths(int* out) {
  for (int c = 0; c < kNumWidths; ++c) out[c] = kWidths[c];
  return kNumWidths;
}
// Cotangent values a short bin's lane holds; a piece of a class of width w
// is this times 256 / w bins.
int bin_segment_sum_values() { return kShortValues; }
// Writes to `out` the largest table row in bytes that a block stages in
// shared memory on device `dev` (larger tables are read from global
// memory) and the bytes of its L2 cache; returns 0 or the cudaError_t.
int bin_gather_device_limits(int dev, int* out) {
  DeviceInfo* d = nullptr;
  const cudaError_t err = device_info(dev, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = d->optin;
  out[1] = d->l2;
  return 0;
}

}  // extern "C"

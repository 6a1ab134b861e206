// Iterative charted refinement (ICR): one refinement step and its
// transpose, for Hopper (sm_90a).
//
//   fine[b, i(s, f)]   = sum_w olf[m(s), f, w] coarse[b, c(s, w)]
//                      + sum_e ker[m(s), f, e] xi[b, s F + e]
//   cot_xi[b, s F + e] = sum_f ker[m(s), f, e] cot[b, i(s, f)]
//   cot_coarse[b, c]   = sum_{(s, w): c(s, w) = c} sum_f olf[m(s), f, w] cot[b, i(s, f)]
//
// for rows b, refinement sites s, window slots w < W and children f < F.
// The JAX package computes this step in XLA, with no Pallas kernel:
// nifty_tpu/refine/charted_field.py:283-303 (a stack of strided slices or
// an index gather, two per-site einsums and the interleave of the
// children) and nifty_tpu/refine/healpix_field.py:190-222 (a neighbour
// gather and the same einsums).  Because an ICR field is linear in its
// excitations, the metric matvec of a geoVI update is these two kernels,
// level after level, forwards and back.
//
// Geometry.  Every chart the port has is separable: the coarse grid has d
// axes of extents nc[a]; along axis a there are ns[a] sites, each of which
// reads nw[a] coarse indices from a small table wtab[a] (ns[a] x nw[a]:
// the clamped or periodic window starts of a CoordinateChart, the nested
// neighbours of a HEALPix level, q, q + 1, q + 2 along a radial axis) and
// places nf[a] children at fine position s_a nf[a] + f_a.  A site's window
// slot w and child f are row-major over the axes (W = prod nw, F = prod
// nf), the fine grid is row-major over the extents ns[a] nf[a], and the
// site's matrices are olf[m(s)] (F x W) and ker[m(s)] (F x F) with m(s) =
// sum_a mstride[a] s_a, mstride 0 along the axes where the matrices are
// broadcast.  So no table of the size of the field is ever built: a
// 4100^2 level reads two tables of 2050 x 3 entries.
//
// Bound.  Device memory: a step reads the coarse field, the excitations
// and the matrices once and writes the fine field once, against at most
// 2 (W + F) operations a fine entry; the transpose reads the cotangent and
// the matrices once and writes both cotangents once.  On the 4100^2 chart
// the matrices are shared along axis 1 and the bytes are the fields' (303
// MB at the last level); on HEALPix and sphere x radius every site has its
// own pair, and at the last sphere x radius level they are 936 MB of the
// 993.
//
// Routes.  The host picks one for each direction of a level from the
// level's tables alone (ops/icr_refine.py, choose_routes) and passes it in
// the geometry.  The compiled routes serve the (slots, children) shapes the
// cells launch (Line3, Nest9, Plane, Shell below); a tile of sites is a
// block's, and the tile's matrices, a contiguous range of the stack since
// m(s) rises by 0 or 1 from one site to the next, are copied into shared
// memory with 16-byte cp.async where staging pays, so every byte of them is
// read once and coalesced.
//   step "thread"     one thread a site, all its children: a 2-D level whose
//                     matrices are shared along its last axis (the 4100^2
//                     chart, deformed along its first).  The block's few
//                     matrix pairs sit in shared memory and the warp reads
//                     each value at once; the excitations and each pair of
//                     children along the last fine axis move as one 16-byte
//                     vector, so a warp's loads and stores are contiguous.
//   step "group"      a lane group a site, lane f computing child f: the
//                     other compiled levels (every site its own matrices:
//                     HEALPix, sphere x radius, demo 9).  The lanes of a site
//                     write neighbouring children; a lane reads its row of
//                     the matrices from shared memory, free of bank
//                     conflicts, where they are staged (sphere x radius, 280
//                     values a site), or in place, where a warp's rows are
//                     one contiguous run that L1 holds (HEALPix, 52); the
//                     excitations are read once, coalesced, and passed on by
//                     shuffles.  A block takes every row, so the matrices
//                     are read once whatever the rows, unless the tiles
//                     alone would leave the card idle (then the rows are
//                     split over blocks).
//   step "entry"      one thread a fine entry, for any other level.
//   transpose "box"   one pass, no scratch, where the sites that read a box
//                     of coarse entries lie in a compact halo along every
//                     axis and the boxes fill the card (the larger chart
//                     levels: windows that are runs) or one block holds the
//                     level.  A block owns a box: it computes the slot
//                     cotangents of every site of the box's halo into shared
//                     memory (reading each site's children in pairs, its
//                     matrices staged where they vary by row alone), writes
//                     cot_xi of the sites it owns (every site has one owner),
//                     then sums each coarse entry's (site, slot) pairs from
//                     shared memory in the CSR order below.
//   transpose "group" two passes: the site pass (tiles, lane groups and
//                     staging as the step; slot cotangents into scratch,
//                     slot-major, so that the gather pass reads them
//                     coalesced along the last site axis) and the gather
//                     pass: the compiled levels whose halos are not compact
//                     (the HEALPix pixel axes) or too few.
//   transpose "entry" the same two passes, one thread a (site, slot or
//                     excitation) and site-major scratch, for any other
//                     level.
// The gather sums, for every coarse entry, the slots that read it over a
// CSR inverse of each axis's table (inv_off[a], inv[a]: the positions s_a
// nw[a] + w_a that read coarse index c_a, in increasing order), built on
// the host, walked over the product of the entry's axes' lists in that
// fixed order (the last axis fastest), with no atomics.  A HEALPix window
// that names its centre twice appears twice in the inverse and is added
// twice.  Every route sums in the same order: sum_w olf coarse, then
// sum_e ker xi, each from 0 in slot and child order with fused
// multiply-adds; the slot cotangents sum_f in child order; the coarse
// cotangent over the CSR product.  So the routes give the same bits.
// Indices within a row are 32-bit on the compiled routes (the host routes
// a level whose rows exceed 2^31 entries to "entry", which takes 64-bit
// indices there); compile-time axis counts 1 to 4 serve "entry" (charts
// of more axes, up to kMaxAxes, take a runtime-count instance).
//
// C entries (plain C interface for ctypes, stream-ordered, nothing
// allocated or synchronised):
//   icr_refine_{f32,f64}(coarse, xi, olf, ker, fine, geom, tables, nrows, dev, stream)
//   icr_refine_transpose_{f32,f64}(cot, olf, ker, scratch, cot_coarse, cot_xi, geom,
//                                  tables, nrows, dev, stream)
//   icr_refine_describe_{f32,f64}(geom, tables, transpose, info, dev)
// geom (host, int64): ndim, then ns, nw, nf, nc and mstride, each ndim
// entries, the step's and the transpose's routes (Route below), then the
// box extents, the boxes and the largest halo (sites) along each axis (box
// route); tables (host array of device pointers): wtab[0..d),
// inv_off[0..d), inv[0..d) (int32), then for the box route halo[0..d)
// ((boxes, 2): the sites [lo, hi) that read box k) and owner[0..d) (the box
// that owns site s: the one holding its first window entry); scratch:
// nrows x S x W values, NULL on the box route.  They return the number of
// kernels launched (1 for the step and the box route, 2 for the two
// passes; 0 for an empty output) or the cudaError that stopped them,
// negated.  describe fills, for each kernel a call would launch (rows 1),
// its registers, local (spill) bytes, static and dynamic shared memory,
// blocks and threads, and returns how many it described.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxAxes = 16;
constexpr int kThreads = 256;
constexpr int kInfo = 6;  // describe: values a kernel
// Blocks that fill an H100 (four an SM): the site routes split their rows
// over blocks where the tiles alone launch fewer.
constexpr int kFillBlocks = 4 * 132;
// Blocks an SM the site kernels are held to (registers at most 64),
// unless their staged matrices leave room for fewer (min_blocks).
constexpr int kMinBlocks = 4;
// Shared memory of an H100 SM, and what the card reserves a block.
constexpr int kSmemPerSm = 228 * 1024, kSmemReserved = 1024;

enum Route { kEntry = 0, kGroup = 1, kBox = 2, kThread = 3 };

struct Geometry {
  int ndim;
  int ns[kMaxAxes];              // sites along each axis
  int nw[kMaxAxes];              // window slots along each axis
  int nf[kMaxAxes];              // children along each axis
  int nc[kMaxAxes];              // coarse extent of each axis
  long long mstride[kMaxAxes];   // matrix-stack stride (0: broadcast)
  long long fstride[kMaxAxes];   // fine-grid stride (row-major)
  const int32_t* wtab[kMaxAxes];     // (ns, nw) coarse index along the axis
  const int32_t* inv_off[kMaxAxes];  // (nc + 1) CSR offsets of the inverse
  const int32_t* inv[kMaxAxes];      // positions s nw + w, by coarse index
  int step_route, transpose_route;
  int box[kMaxAxes];                 // coarse entries a box along each axis
  int nbox[kMaxAxes];                // boxes along each axis
  int halo_max[kMaxAxes];            // the largest halo (sites) along each axis
  const int32_t* halo[kMaxAxes];     // (nbox, 2): sites [lo, hi) that read box k
  const int32_t* owner[kMaxAxes];    // (ns): the box that owns site s
  int W, F;                      // window slots and children a site
  long long S, n_coarse, n_fine;     // sites, coarse and fine entries (a row)
};

// -- the compiled shapes ------------------------------------------------------

// A level's (slots, children) along its one or two axes, and whether the
// lane-group routes stage a tile's matrices in shared memory (where every
// site has its own pair of many values and a lane's row would otherwise be
// read a sector at a time) or read them where they lie.
template <int ND_, bool STAGE_, int NW0_, int NF0_, int NW1_ = 1, int NF1_ = 1>
struct Shape {
  static constexpr int ND = ND_, NW0 = NW0_, NF0 = NF0_, NW1 = NW1_, NF1 = NF1_;
  static constexpr bool STAGE = STAGE_;
  static constexpr int W = NW0 * NW1, F = NF0 * NF1;
};
using Line3 = Shape<1, true, 3, 2>;        // a 1-D chart
using Nest9 = Shape<1, false, 9, 4>;       // a HEALPix level: 9 neighbours, 4 children
using Plane = Shape<2, true, 3, 2, 3, 2>;  // a 2-D chart
using Shell = Shape<2, true, 9, 4, 3, 2>;  // sphere x radius

template <class Sh>
bool matches(const Geometry& g) {
  if (g.ndim != Sh::ND || g.nw[0] != Sh::NW0 || g.nf[0] != Sh::NF0) return false;
  return Sh::ND == 1 || (g.nw[1] == Sh::NW1 && g.nf[1] == Sh::NF1);
}

// Calls fn(Sh{}) for the compiled shape of the level; false for none.
template <typename Fn>
bool with_shape(const Geometry& g, Fn&& fn) {
  if (matches<Line3>(g)) return fn(Line3{}), true;
  if (matches<Nest9>(g)) return fn(Nest9{}), true;
  if (matches<Plane>(g)) return fn(Plane{}), true;
  if (matches<Shell>(g)) return fn(Shell{}), true;
  return false;
}

template <class Sh>
__device__ __forceinline__ void split_site(int s, const Geometry& g, int* sa) {
  if (Sh::ND == 1) {
    sa[0] = s;
  } else {
    sa[0] = s / g.ns[1];
    sa[1] = s - sa[0] * g.ns[1];
  }
}

template <class Sh>
__device__ __forceinline__ int site_of(const int* sa, const Geometry& g) {
  return Sh::ND == 1 ? sa[0] : sa[0] * g.ns[1] + sa[1];
}

template <class Sh>
__device__ __forceinline__ int matrix_of(const int* sa, const Geometry& g) {
  int m = static_cast<int>(g.mstride[0]) * sa[0];
  if (Sh::ND == 2) m += static_cast<int>(g.mstride[1]) * sa[1];
  return m;
}

// The fine index (within a row) of child f of the site.
template <class Sh>
__device__ __forceinline__ int fine_of(const int* sa, int f, const Geometry& g) {
  if (Sh::ND == 1) return sa[0] * Sh::NF0 + f;
  const int f0 = f / Sh::NF1, f1 = f - f0 * Sh::NF1;
  return (sa[0] * Sh::NF0 + f0) * (g.ns[1] * Sh::NF1) + sa[1] * Sh::NF1 + f1;
}

// The coarse indices (within a row) of the site's window slots.
template <class Sh>
__device__ __forceinline__ void window_of(const int* sa, const Geometry& g, int* cw) {
  if (Sh::ND == 1) {
#pragma unroll
    for (int w = 0; w < Sh::W; ++w) cw[w] = __ldg(g.wtab[0] + sa[0] * Sh::NW0 + w);
  } else {
    int c1[Sh::NW1];
#pragma unroll
    for (int j = 0; j < Sh::NW1; ++j) c1[j] = __ldg(g.wtab[1] + sa[1] * Sh::NW1 + j);
#pragma unroll
    for (int i = 0; i < Sh::NW0; ++i) {
      const int c0 = __ldg(g.wtab[0] + sa[0] * Sh::NW0 + i) * g.nc[1];
#pragma unroll
      for (int j = 0; j < Sh::NW1; ++j) cw[i * Sh::NW1 + j] = c0 + c1[j];
    }
  }
}

// -- staging the matrices of a tile of sites ------------------------------------

// Sites a tile (a block) of the lane-group routes.
template <class Sh>
__host__ __device__ constexpr int tile_sites() { return kThreads / Sh::F; }

// The blocks an SM the lane-group kernels are held to: kMinBlocks, or as
// many as a tile's staged matrices (every site its own pair) fit in shared
// memory, so that registers are not spilled for blocks that could not be
// resident anyway (three for sphere x radius in float64).
template <typename T, class Sh>
__host__ __device__ constexpr int min_blocks() {
  constexpr int smem =
      Sh::STAGE ? tile_sites<Sh>() * Sh::F * (Sh::W + Sh::F) * static_cast<int>(sizeof(T)) : 0;
  constexpr int fit = smem ? kSmemPerSm / (smem + kSmemReserved) : kMinBlocks;
  return fit < 1 ? 1 : (fit < kMinBlocks ? fit : kMinBlocks);
}

// The most matrix pairs a tile of TS sites uses: the matrix index is the
// site's flat index over the leading axes along which the matrices vary
// (the host routes no other level here), so it rises by 1 every `suffix`
// sites, the product of the other axes' sites.
template <class Sh, int TS>
__host__ __device__ int tile_matrices(const Geometry& g) {
  long long suffix = 1;
  for (int a = 0; a < Sh::ND; ++a) {
    if (g.mstride[a] == 0) suffix *= g.ns[a];
  }
  const long long span = (TS - 1) / suffix + 2;
  return static_cast<int>(span < TS ? span : TS);
}

// Values of shared memory before the kernel matrices (16-byte aligned),
// and bytes in all; each region has room for one more 16-byte phase.
template <typename T, class Sh, int TS>
__host__ __device__ int ker_region(const Geometry& g) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  return (tile_matrices<Sh, TS>(g) * Sh::F * Sh::W + 2 * V - 1) / V * V;
}
template <typename T, class Sh, int TS = tile_sites<Sh>()>
size_t site_smem_bytes(const Geometry& g) {
  if (!Sh::STAGE) return 0;
  return (ker_region<T, Sh, TS>(g) + tile_matrices<Sh, TS>(g) * Sh::F * Sh::F +
          16 / sizeof(T)) * sizeof(T);
}

// Starts the asynchronous copy of n values from `src` (global) into shared
// memory at `base` (16-byte aligned, room for n + 16 / sizeof(T) values),
// at src's 16-byte phase so that the body moves in 16-byte pieces; returns
// where the values start.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ T* stage(T* base, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  T* dst = base + phase;
  const int head = min(n, (V - phase) % V);
  const int body = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  }
  for (int i = threadIdx.x; i < body; i += blockDim.x) {
    __pipeline_memcpy_async(dst + head + i * V, src + head + i * V, 16);
  }
  for (int i = head + body * V + threadIdx.x; i < n; i += blockDim.x) {
    __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  }
  return dst;
}

// The tile's TS sites [first, last], their matrices' range and where the
// copies of those land.
template <typename T, class Sh, int TS = tile_sites<Sh>()>
struct Tile {
  int first, last, m_lo;
  const T* olf;
  const T* ker;

  __device__ __forceinline__ Tile(T* smem, const T* olf_g, const T* ker_g, const Geometry& g) {
    constexpr int F = Sh::F, W = Sh::W;
    first = static_cast<int>(blockIdx.x) * TS;
    last = min(first + TS, static_cast<int>(g.S)) - 1;
    int sa[Sh::ND];
    split_site<Sh>(first, g, sa);
    m_lo = matrix_of<Sh>(sa, g);
    olf = olf_g + static_cast<long long>(m_lo) * F * W;
    ker = ker_g + static_cast<long long>(m_lo) * F * F;
    if constexpr (Sh::STAGE) {
      split_site<Sh>(last, g, sa);
      const int nm = matrix_of<Sh>(sa, g) - m_lo + 1;
      olf = stage(smem, olf, nm * F * W);
      ker = stage(smem + ker_region<T, Sh, TS>(g), ker, nm * F * F);
      __pipeline_commit();
    }
  }

  __device__ __forceinline__ void wait() const {
    if constexpr (Sh::STAGE) {
      __pipeline_wait_prior(0);
      __syncthreads();
    }
  }
};

// A lane's site: its index (the tile's last site for a lane past the end,
// whose results are dropped: the shuffles need every lane), whether it is
// live, its matrix pair (from the tile's first) and its axes.
template <class Sh>
struct Site {
  int s, m;
  bool live;
  int sa[Sh::ND];

  template <typename T, int TS>
  __device__ __forceinline__ Site(const Tile<T, Sh, TS>& tile, int lane_site,
                                  const Geometry& g) {
    s = tile.first + lane_site;
    live = s <= tile.last;
    s = live ? s : tile.last;
    split_site<Sh>(s, g, sa);
    m = matrix_of<Sh>(sa, g) - tile.m_lo;
  }
};

// Route "group": lane f of a lane group computes child f of its site; the
// window's indices are read while the staged matrices arrive.
template <typename T, class Sh>
__global__ void __launch_bounds__(kThreads, min_blocks<T, Sh>()) refine_site_kernel(
    const T* __restrict__ coarse, const T* __restrict__ xi, const T* __restrict__ olf,
    const T* __restrict__ ker, T* __restrict__ fine, const Geometry g, int nrows, int rows) {
  constexpr int W = Sh::W, F = Sh::F;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile<T, Sh> tile(reinterpret_cast<T*>(smem_raw), olf, ker, g);
  const int f = static_cast<int>(threadIdx.x) % F;
  const Site<Sh> site(tile, static_cast<int>(threadIdx.x) / F, g);
  const int i = fine_of<Sh>(site.sa, f, g);
  int cw[W];
  window_of<Sh>(site.sa, g, cw);
  const T* o = tile.olf + (site.m * F + f) * W;
  const T* k = tile.ker + (site.m * F + f) * F;
  const int S = static_cast<int>(g.S);
  const int b0 = static_cast<int>(blockIdx.y) * rows, b1 = min(nrows, b0 + rows);
  for (int b = b0; b < b1; ++b) {
    const T* __restrict__ crow = coarse + static_cast<long long>(b) * g.n_coarse;
    if (b == b0) tile.wait();
    const T x = __ldg(xi + static_cast<long long>(b) * S * F + site.s * F + f);
    T acc = T(0);
#pragma unroll
    for (int w = 0; w < W; ++w) acc = fma(o[w], __ldg(crow + cw[w]), acc);
#pragma unroll
    for (int e = 0; e < F; ++e) acc = fma(k[e], __shfl_sync(0xffffffffu, x, e, F), acc);
    if (site.live) fine[static_cast<long long>(b) * g.n_fine + i] = acc;
  }
}

template <typename T>
struct Pair;
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

// Route "thread" (a 2-D level whose matrices are shared along its last
// axis, as on a chart deformed along its first): one thread a site, all F
// children.  The block's few matrix pairs are staged in shared memory and
// read there by the whole warp at once; the excitations and each pair of
// children along the last fine axis move as one vector (16 bytes in
// float64), so a warp's loads and stores are contiguous.  A row's
// excitations and coarse window are loaded while the matrices arrive.
template <typename T, class Sh>
__global__ void __launch_bounds__(kThreads, kMinBlocks) refine_thread_kernel(
    const T* __restrict__ coarse, const T* __restrict__ xi, const T* __restrict__ olf,
    const T* __restrict__ ker, T* __restrict__ fine, const Geometry g, int nrows, int rows) {
  static_assert(Sh::ND == 2 && Sh::NF1 == 2 && Sh::F % 2 == 0, "pairs along the last axis");
  constexpr int W = Sh::W, F = Sh::F;
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile<T, Sh, kThreads> tile(reinterpret_cast<T*>(smem_raw), olf, ker, g);
  const int S = static_cast<int>(g.S);
  const int s0 = tile.first + static_cast<int>(threadIdx.x);
  const bool live = s0 <= tile.last;
  const int s = live ? s0 : tile.last;
  int sa[2];
  split_site<Sh>(s, g, sa);
  const int m = matrix_of<Sh>(sa, g) - tile.m_lo;
  int cw[W];
  window_of<Sh>(sa, g, cw);
  const int b0 = static_cast<int>(blockIdx.y) * rows, b1 = min(nrows, b0 + rows);
  for (int b = b0; b < b1; ++b) {
    const T* __restrict__ crow = coarse + static_cast<long long>(b) * g.n_coarse;
    const T2* __restrict__ xp =
        reinterpret_cast<const T2*>(xi + static_cast<long long>(b) * S * F + s * F);
    T x[F], c[W];
#pragma unroll
    for (int p = 0; p < F / 2; ++p) {
      const T2 v = __ldg(xp + p);
      x[2 * p] = v.x;
      x[2 * p + 1] = v.y;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] = __ldg(crow + cw[w]);
    if (b == b0) tile.wait();
    const T* o = tile.olf + m * F * W;
    const T* k = tile.ker + m * F * F;
    T acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = T(0);
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fma(o[f * W + w], c[w], acc[f]);
    }
#pragma unroll
    for (int e = 0; e < F; ++e) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fma(k[f * F + e], x[e], acc[f]);
    }
    if (!live) continue;
    T* __restrict__ out = fine + static_cast<long long>(b) * g.n_fine;
#pragma unroll
    for (int f0 = 0; f0 < Sh::NF0; ++f0) {
      T2 v;
      v.x = acc[2 * f0];
      v.y = acc[2 * f0 + 1];
      *reinterpret_cast<T2*>(out + fine_of<Sh>(sa, 2 * f0, g)) = v;
    }
  }
}

// ND > 0: the axis count at compile time; ND == 0: g.ndim at run time.
template <int ND>
__device__ __forceinline__ int axes(const Geometry& g) { return ND ? ND : g.ndim; }

// Route "entry": one thread a fine entry.  I: the type of indices within a
// row (uint32_t where every row size of the level fits in it).
template <typename T, int ND, typename I>
__global__ void __launch_bounds__(kThreads) refine_entry_kernel(
    const T* __restrict__ coarse, const T* __restrict__ xi, const T* __restrict__ olf,
    const T* __restrict__ ker, T* __restrict__ fine, const Geometry g) {
  constexpr int A = ND ? ND : kMaxAxes;
  const int nd = axes<ND>(g);
  const I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<I>(g.n_fine)) return;
  const long long b = blockIdx.y;
  // the fine index -> (site, child) along each axis
  int s_ax[A], w_ax[A], f_ax[A];
  I rem = i, s = 0, m = 0;
  int f = 0;
#pragma unroll
  for (int a = A - 1; a >= 0; --a) {
    if (a >= nd) continue;
    const I ext = static_cast<I>(g.ns[a]) * g.nf[a];
    const int ia = static_cast<int>(rem % ext);
    rem /= ext;
    s_ax[a] = ia / g.nf[a];
    f_ax[a] = ia - s_ax[a] * g.nf[a];
    w_ax[a] = 0;
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    if (a >= nd) continue;
    s = s * g.ns[a] + s_ax[a];
    f = f * g.nf[a] + f_ax[a];
    m += static_cast<I>(g.mstride[a]) * s_ax[a];
  }
  const T* __restrict__ crow = coarse + b * g.n_coarse;
  const T* __restrict__ o = olf + (static_cast<long long>(m) * g.F + f) * g.W;
  T acc = T(0);
  for (int w = 0; w < g.W; ++w) {
    I c = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (a >= nd) continue;
      c = c * g.nc[a] + __ldg(g.wtab[a] + s_ax[a] * g.nw[a] + w_ax[a]);
    }
    acc += o[w] * crow[c];
    // next slot, the last axis fastest
    bool carry = true;
#pragma unroll
    for (int a = A - 1; a >= 0; --a) {
      if (a >= nd || !carry) continue;
      if (++w_ax[a] < g.nw[a]) {
        carry = false;
      } else {
        w_ax[a] = 0;
      }
    }
  }
  const T* __restrict__ k = ker + (static_cast<long long>(m) * g.F + f) * g.F;
  const T* __restrict__ x = xi + b * g.S * g.F + static_cast<long long>(s) * g.F;
  for (int e = 0; e < g.F; ++e) acc += k[e] * x[e];
  fine[b * g.n_fine + i] = acc;
}

// -- transpose, route "box" ---------------------------------------------------

// Matrix pairs a box stages in shared memory: the range its halo uses
// where the matrices are shared along the last axis (or the level has one
// axis), so that they vary by row and the range is the halo's rows; none
// (read where they lie) otherwise.
template <class Sh>
__host__ __device__ int box_matrices(const Geometry& g) {
  if (Sh::ND == 2 && g.mstride[Sh::ND - 1] != 0) return 0;
  return static_cast<int>(g.mstride[0]) * (g.halo_max[0] - 1) + 1;
}

// Values of a box's slot cotangents (rounded up to 16 bytes), where its
// kernel matrices start, and its bytes of shared memory in all.
template <typename T, class Sh>
__host__ __device__ int box_slot_values(const Geometry& g) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  int n = Sh::W;
  for (int a = 0; a < Sh::ND; ++a) n *= g.halo_max[a];
  return (n + V - 1) / V * V;
}
template <typename T, class Sh>
__host__ __device__ int box_ker_region(const Geometry& g) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  return box_slot_values<T, Sh>(g) + (box_matrices<Sh>(g) * Sh::F * Sh::W + 2 * V - 1) / V * V;
}
template <typename T, class Sh>
size_t box_smem_bytes(const Geometry& g) {
  const int nm = box_matrices<Sh>(g);
  const int values = nm ? box_ker_region<T, Sh>(g) + nm * Sh::F * Sh::F + 16 / sizeof(T)
                        : box_slot_values<T, Sh>(g);
  return static_cast<size_t>(values) * sizeof(T);
}

// One block a box of coarse entries: the slot cotangents of the box's halo
// sites into shared memory (t[w][h], h row-major over the halo), the
// excitations' cotangents of the sites the box owns, then each coarse
// entry's sum over its CSR product.  `pairs`: cot and cot_xi are aligned
// for two values at once (each pair of children along the last fine axis,
// each pair of excitations).
template <typename T, class Sh>
__global__ void __launch_bounds__(kThreads) transpose_box_kernel(
    const T* __restrict__ cot, const T* __restrict__ olf, const T* __restrict__ ker,
    T* __restrict__ cot_coarse, T* __restrict__ cot_xi, const Geometry g, bool pairs) {
  constexpr int ND = Sh::ND, W = Sh::W, F = Sh::F;
  static_assert(F % 2 == 0 && (ND == 1 || Sh::NF1 == 2), "pairs of children");
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t_sh = reinterpret_cast<T*>(smem_raw);
  const long long b = blockIdx.y;
  int k[ND], hlo[ND], hn[ND];
  int rem = static_cast<int>(blockIdx.x);
#pragma unroll
  for (int a = ND - 1; a >= 0; --a) {
    k[a] = rem % g.nbox[a];
    rem /= g.nbox[a];
    hlo[a] = __ldg(g.halo[a] + 2 * k[a]);
    hn[a] = __ldg(g.halo[a] + 2 * k[a] + 1) - hlo[a];
  }
  const int n_halo = ND == 1 ? hn[0] : hn[0] * hn[ND - 1];
  // the halo's matrices: staged (from the pair of its first site) or in place
  const T* olf_b = olf;
  const T* ker_b = ker;
  int m_lo = 0;
  if (box_matrices<Sh>(g) > 0 && n_halo > 0) {
    int sa[ND];
#pragma unroll
    for (int a = 0; a < ND; ++a) sa[a] = hlo[a];
    m_lo = matrix_of<Sh>(sa, g);
#pragma unroll
    for (int a = 0; a < ND; ++a) sa[a] = hlo[a] + hn[a] - 1;
    const int nm = matrix_of<Sh>(sa, g) - m_lo + 1;
    olf_b = stage(t_sh + box_slot_values<T, Sh>(g), olf + static_cast<long long>(m_lo) * F * W,
                  nm * F * W);
    ker_b = stage(t_sh + box_ker_region<T, Sh>(g), ker + static_cast<long long>(m_lo) * F * F,
                  nm * F * F);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  const int S = static_cast<int>(g.S);
  const T* __restrict__ crow = cot + b * g.n_fine;
  for (int h = threadIdx.x; h < n_halo; h += kThreads) {
    int sa[ND];
    if (ND == 1) {
      sa[0] = hlo[0] + h;
    } else {
      const int h0 = h / hn[ND - 1];
      sa[0] = hlo[0] + h0;
      sa[ND - 1] = hlo[ND - 1] + (h - h0 * hn[ND - 1]);
    }
    T c[F];
    if (pairs) {
#pragma unroll
      for (int p = 0; p < F / 2; ++p) {
        const T2 v = __ldg(reinterpret_cast<const T2*>(crow + fine_of<Sh>(sa, 2 * p, g)));
        c[2 * p] = v.x;
        c[2 * p + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) c[f] = __ldg(crow + fine_of<Sh>(sa, f, g));
    }
    const long long m = matrix_of<Sh>(sa, g) - m_lo;
    const T* o = olf_b + m * F * W;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      T acc = T(0);
#pragma unroll
      for (int f = 0; f < F; ++f) acc = fma(o[f * W + w], c[f], acc);
      t_sh[w * n_halo + h] = acc;
    }
    bool own = true;
#pragma unroll
    for (int a = 0; a < ND; ++a) own = own && __ldg(g.owner[a] + sa[a]) == k[a];
    if (own) {
      const T* kk = ker_b + m * F * F;
      T x[F];
#pragma unroll
      for (int e = 0; e < F; ++e) {
        T acc = T(0);
#pragma unroll
        for (int f = 0; f < F; ++f) acc = fma(kk[f * F + e], c[f], acc);
        x[e] = acc;
      }
      T* __restrict__ out = cot_xi + b * S * F + static_cast<long long>(site_of<Sh>(sa, g)) * F;
      if (pairs) {
#pragma unroll
        for (int p = 0; p < F / 2; ++p) {
          T2 v;
          v.x = x[2 * p];
          v.y = x[2 * p + 1];
          reinterpret_cast<T2*>(out)[p] = v;
        }
      } else {
#pragma unroll
        for (int e = 0; e < F; ++e) out[e] = x[e];
      }
    }
  }
  __syncthreads();
  int clo[ND], cn[ND];
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    clo[a] = k[a] * g.box[a];
    cn[a] = min(g.box[a], g.nc[a] - clo[a]);
  }
  const int n_box = ND == 1 ? cn[0] : cn[0] * cn[ND - 1];
  for (int j = threadIdx.x; j < n_box; j += kThreads) {
    T acc = T(0);
    if (ND == 1) {
      const int c0 = clo[0] + j;
      const int lo0 = __ldg(g.inv_off[0] + c0), hi0 = __ldg(g.inv_off[0] + c0 + 1);
      for (int p0 = lo0; p0 < hi0; ++p0) {
        const int q0 = __ldg(g.inv[0] + p0);
        const int s0 = q0 / Sh::NW0, w0 = q0 - s0 * Sh::NW0;
        acc += t_sh[w0 * n_halo + (s0 - hlo[0])];
      }
      cot_coarse[b * g.n_coarse + c0] = acc;
    } else {
      const int j0 = j / cn[ND - 1];
      const int c0 = clo[0] + j0, c1 = clo[ND - 1] + (j - j0 * cn[ND - 1]);
      const int lo0 = __ldg(g.inv_off[0] + c0), hi0 = __ldg(g.inv_off[0] + c0 + 1);
      const int lo1 = __ldg(g.inv_off[ND - 1] + c1), hi1 = __ldg(g.inv_off[ND - 1] + c1 + 1);
      for (int p0 = lo0; p0 < hi0; ++p0) {
        const int q0 = __ldg(g.inv[0] + p0);
        const int s0 = q0 / Sh::NW0, w0 = q0 - s0 * Sh::NW0;
        const int row = (s0 - hlo[0]) * hn[ND - 1];
        for (int p1 = lo1; p1 < hi1; ++p1) {
          const int q1 = __ldg(g.inv[ND - 1] + p1);
          const int s1 = q1 / Sh::NW1, w1 = q1 - s1 * Sh::NW1;
          acc += t_sh[(w0 * Sh::NW1 + w1) * n_halo + row + (s1 - hlo[ND - 1])];
        }
      }
      cot_coarse[b * g.n_coarse + static_cast<long long>(c0) * g.nc[ND - 1] + c1] = acc;
    }
  }
}

// -- transpose, route "group": two passes --------------------------------------

// The site pass: lane f of a lane group reads child f of its site; the
// group's lanes then share the F values and each computes every F-th of
// the site's W slot cotangents (into t, slot-major: t[b, w S + s]) and F
// excitation cotangents.
template <typename T, class Sh>
__global__ void __launch_bounds__(kThreads, min_blocks<T, Sh>()) transpose_site_kernel(
    const T* __restrict__ cot, const T* __restrict__ olf, const T* __restrict__ ker,
    T* __restrict__ t_out, T* __restrict__ cot_xi, const Geometry g, int nrows, int rows) {
  constexpr int W = Sh::W, F = Sh::F;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile<T, Sh> tile(reinterpret_cast<T*>(smem_raw), olf, ker, g);
  const int f = static_cast<int>(threadIdx.x) % F;
  const Site<Sh> site(tile, static_cast<int>(threadIdx.x) / F, g);
  const int i = fine_of<Sh>(site.sa, f, g);
  const T* o = tile.olf + site.m * F * W;
  const T* k = tile.ker + site.m * F * F;
  const int S = static_cast<int>(g.S);
  const int b0 = static_cast<int>(blockIdx.y) * rows, b1 = min(nrows, b0 + rows);
  for (int b = b0; b < b1; ++b) {
    const T cv = __ldg(cot + static_cast<long long>(b) * g.n_fine + i);
    if (b == b0) tile.wait();
    T c[F];
#pragma unroll
    for (int ff = 0; ff < F; ++ff) c[ff] = __shfl_sync(0xffffffffu, cv, ff, F);
    if (!site.live) continue;
#pragma unroll
    for (int q = 0; q < (W + F + F - 1) / F; ++q) {
      const int jj = f + q * F;
      if (jj < W) {
        T acc = T(0);
#pragma unroll
        for (int ff = 0; ff < F; ++ff) acc = fma(o[ff * W + jj], c[ff], acc);
        t_out[static_cast<long long>(b) * S * W + static_cast<long long>(jj) * S + site.s] = acc;
      } else if (jj < W + F) {
        const int e = jj - W;
        T acc = T(0);
#pragma unroll
        for (int ff = 0; ff < F; ++ff) acc = fma(k[ff * F + e], c[ff], acc);
        cot_xi[static_cast<long long>(b) * S * F + site.s * F + e] = acc;
      }
    }
  }
}

// The gather pass of route "group": cot_coarse[b, c], one thread a coarse
// entry, the slot-major t over the product of its axes' inverse lists.
template <typename T, class Sh>
__global__ void __launch_bounds__(kThreads) transpose_gather_slot_kernel(
    const T* __restrict__ t_in, T* __restrict__ cot_coarse, const Geometry g) {
  constexpr int ND = Sh::ND;
  const int c = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= g.n_coarse) return;
  const long long b = blockIdx.y;
  const int S = static_cast<int>(g.S);
  const T* __restrict__ trow = t_in + b * S * Sh::W;
  T acc = T(0);
  if (ND == 1) {
    const int lo0 = __ldg(g.inv_off[0] + c), hi0 = __ldg(g.inv_off[0] + c + 1);
    for (int p0 = lo0; p0 < hi0; ++p0) {
      const int q0 = __ldg(g.inv[0] + p0);
      const int s0 = q0 / Sh::NW0, w0 = q0 - s0 * Sh::NW0;
      acc += __ldg(trow + w0 * S + s0);
    }
  } else {
    const int c0 = c / g.nc[ND - 1], c1 = c - c0 * g.nc[ND - 1];
    const int lo0 = __ldg(g.inv_off[0] + c0), hi0 = __ldg(g.inv_off[0] + c0 + 1);
    const int lo1 = __ldg(g.inv_off[ND - 1] + c1), hi1 = __ldg(g.inv_off[ND - 1] + c1 + 1);
    const int ns1 = g.ns[ND - 1];
    for (int p0 = lo0; p0 < hi0; ++p0) {
      const int q0 = __ldg(g.inv[0] + p0);
      const int s0 = q0 / Sh::NW0, w0 = q0 - s0 * Sh::NW0;
      for (int p1 = lo1; p1 < hi1; ++p1) {
        const int q1 = __ldg(g.inv[ND - 1] + p1);
        const int s1 = q1 / Sh::NW1, w1 = q1 - s1 * Sh::NW1;
        acc += __ldg(trow + (w0 * Sh::NW1 + w1) * S + s0 * ns1 + s1);
      }
    }
  }
  cot_coarse[b * g.n_coarse + c] = acc;
}

// -- transpose, route "entry": two passes --------------------------------------

// The site pass: for site s and j < W + F, one thread,
//   j < W:  t[b, s W + j]          = sum_f olf[m(s), f, j] cot[b, i(s, f)]
//   else:   cot_xi[b, s F + j - W] = sum_f ker[m(s), f, j - W] cot[b, i(s, f)]
template <typename T, int ND, typename I>
__global__ void __launch_bounds__(kThreads) transpose_entry_kernel(
    const T* __restrict__ cot, const T* __restrict__ olf, const T* __restrict__ ker,
    T* __restrict__ t_out, T* __restrict__ cot_xi, const Geometry g) {
  constexpr int A = ND ? ND : kMaxAxes;
  const int nd = axes<ND>(g);
  const int width = g.W + g.F;
  const I t = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<I>(g.S) * width) return;
  const long long b = blockIdx.y;
  const I s = t / width;
  const int j = static_cast<int>(t - s * width);
  int f_ax[A];
  I rem = s, m = 0, base = 0;
#pragma unroll
  for (int a = A - 1; a >= 0; --a) {
    if (a >= nd) continue;
    const int sa = static_cast<int>(rem % g.ns[a]);
    rem /= g.ns[a];
    m += static_cast<I>(g.mstride[a]) * sa;
    base += static_cast<I>(sa) * g.nf[a] * static_cast<I>(g.fstride[a]);
    f_ax[a] = 0;
  }
  const T* __restrict__ crow = cot + b * g.n_fine;
  // the column of olf (stride W) or of ker (stride F) this thread sums over
  const bool slot = j < g.W;
  const int stride = slot ? g.W : g.F;
  const T* __restrict__ col = slot ? olf + static_cast<long long>(m) * g.F * g.W + j
                                   : ker + static_cast<long long>(m) * g.F * g.F + (j - g.W);
  T acc = T(0);
  for (int f = 0; f < g.F; ++f) {
    I i = base;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (a < nd) i += f_ax[a] * static_cast<I>(g.fstride[a]);
    }
    acc += col[f * stride] * crow[i];
    bool carry = true;
#pragma unroll
    for (int a = A - 1; a >= 0; --a) {
      if (a >= nd || !carry) continue;
      if (++f_ax[a] < g.nf[a]) {
        carry = false;
      } else {
        f_ax[a] = 0;
      }
    }
  }
  if (slot) {
    t_out[b * g.S * g.W + static_cast<long long>(s) * g.W + j] = acc;
  } else {
    cot_xi[b * g.S * g.F + static_cast<long long>(s) * g.F + (j - g.W)] = acc;
  }
}

// The gather pass: cot_coarse[b, c], one thread a coarse entry, the sum of
// the site-major slot cotangents t that read it, over the product of its
// axes' inverse lists in order.
template <typename T, int ND, typename I>
__global__ void __launch_bounds__(kThreads) transpose_gather_entry_kernel(
    const T* __restrict__ t_in, T* __restrict__ cot_coarse, const Geometry g) {
  constexpr int A = ND ? ND : kMaxAxes;
  const int nd = axes<ND>(g);
  const I c = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= static_cast<I>(g.n_coarse)) return;
  const long long b = blockIdx.y;
  int pos[A], hi[A], lo[A];
  bool empty = false;
  I rem = c;
#pragma unroll
  for (int a = A - 1; a >= 0; --a) {
    if (a >= nd) continue;
    const int ca = static_cast<int>(rem % g.nc[a]);
    rem /= g.nc[a];
    lo[a] = pos[a] = __ldg(g.inv_off[a] + ca);
    hi[a] = __ldg(g.inv_off[a] + ca + 1);
    empty |= lo[a] == hi[a];
  }
  T acc = T(0);
  const T* __restrict__ trow = t_in + b * g.S * g.W;
  while (!empty) {
    I s = 0;
    int w = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (a >= nd) continue;
      const int k = __ldg(g.inv[a] + pos[a]);
      const int sa = k / g.nw[a];
      s = s * g.ns[a] + sa;
      w = w * g.nw[a] + (k - sa * g.nw[a]);
    }
    acc += trow[static_cast<long long>(s) * g.W + w];
    // next (site, slot) pair, the last axis fastest
    bool carry = true;
#pragma unroll
    for (int a = A - 1; a >= 0; --a) {
      if (a >= nd || !carry) continue;
      if (++pos[a] < hi[a]) {
        carry = false;
      } else {
        pos[a] = lo[a];
      }
    }
    if (carry) break;
  }
  cot_coarse[b * g.n_coarse + c] = acc;
}

// -- host side ----------------------------------------------------------------

// The geometry from the host's int64 array and pointer array; false for
// an axis count or a route the kernels do not take.
bool make_geometry(const long long* geom, const void* const* tables, Geometry* g) {
  const int nd = static_cast<int>(geom[0]);
  if (nd < 1 || nd > kMaxAxes) return false;
  g->ndim = nd;
  g->W = g->F = 1;
  g->S = g->n_coarse = 1;
  for (int a = 0; a < nd; ++a) {
    g->ns[a] = static_cast<int>(geom[1 + a]);
    g->nw[a] = static_cast<int>(geom[1 + nd + a]);
    g->nf[a] = static_cast<int>(geom[1 + 2 * nd + a]);
    g->nc[a] = static_cast<int>(geom[1 + 3 * nd + a]);
    g->mstride[a] = geom[1 + 4 * nd + a];
    g->box[a] = static_cast<int>(geom[3 + 5 * nd + a]);
    g->nbox[a] = static_cast<int>(geom[3 + 6 * nd + a]);
    g->halo_max[a] = static_cast<int>(geom[3 + 7 * nd + a]);
    g->wtab[a] = static_cast<const int32_t*>(tables[a]);
    g->inv_off[a] = static_cast<const int32_t*>(tables[nd + a]);
    g->inv[a] = static_cast<const int32_t*>(tables[2 * nd + a]);
    g->halo[a] = static_cast<const int32_t*>(tables[3 * nd + a]);
    g->owner[a] = static_cast<const int32_t*>(tables[4 * nd + a]);
    g->W *= g->nw[a];
    g->F *= g->nf[a];
    g->S *= g->ns[a];
    g->n_coarse *= g->nc[a];
  }
  g->step_route = static_cast<int>(geom[1 + 5 * nd]);
  g->transpose_route = static_cast<int>(geom[2 + 5 * nd]);
  long long stride = 1;
  for (int a = nd - 1; a >= 0; --a) {
    g->fstride[a] = stride;
    stride *= static_cast<long long>(g->ns[a]) * g->nf[a];
  }
  g->n_fine = stride;
  const bool known = (g->step_route == kEntry || g->step_route == kGroup ||
                      g->step_route == kThread) &&
                     g->transpose_route >= kEntry && g->transpose_route <= kBox;
  return known;
}

// Whether every index within a row of the level (fine, coarse, site pass,
// scratch and matrix entries) fits in 32 bits.
bool narrow_rows(const Geometry& g) {
  const long long limit = 1ll << 31;  // with a block of headroom below 2^32
  long long mats = 0;
  for (int a = 0; a < g.ndim; ++a) mats += g.mstride[a] * (g.ns[a] - 1);
  return g.n_fine < limit && g.n_coarse < limit && g.S * (g.W + g.F) < limit &&
         (mats + 1) * g.F * (g.W + g.F) < limit;
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// Rows a block and the blocks of the rows, where `tiles` blocks take a row.
dim3 split_rows(long long tiles, int nrows) {
  long long splits = kFillBlocks / tiles;
  splits = splits < 1 ? 1 : (splits > nrows ? nrows : splits);
  const long long rows = (nrows + splits - 1) / splits;
  return dim3(static_cast<unsigned>(tiles), static_cast<unsigned>((nrows + rows - 1) / rows));
}

dim3 thread_grid(const Geometry& g, int nrows) { return split_rows(blocks_for(g.S), nrows); }

// The site routes' grid: a block a tile, and the rows split over blocks
// (evenly) where the tiles alone do not fill the card; a block takes every
// row otherwise, so the matrices are read once.
template <class Sh>
dim3 site_grid(const Geometry& g, int nrows) {
  return split_rows((g.S + tile_sites<Sh>() - 1) / tile_sites<Sh>(), nrows);
}

// Launches kernels on a stream, or (with `info`) describes them.
struct Launcher {
  cudaStream_t stream;
  long long* info;  // NULL: launch
  int count;

  template <typename... P, typename... A>
  cudaError_t operator()(void (*kernel)(P...), dim3 grid, size_t smem, A... args) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    if (info != nullptr) {
      cudaFuncAttributes at;
      const cudaError_t e = cudaFuncGetAttributes(&at, kernel);
      if (e != cudaSuccess) return e;
      long long* out = info + kInfo * count++;
      out[0] = at.numRegs;
      out[1] = static_cast<long long>(at.localSizeBytes);
      out[2] = static_cast<long long>(at.sharedSizeBytes);
      out[3] = static_cast<long long>(smem);
      out[4] = static_cast<long long>(grid.x) * grid.y;
      out[5] = kThreads;
      return cudaSuccess;
    }
    ++count;
    kernel<<<grid, kThreads, smem, stream>>>(args...);
    return cudaGetLastError();
  }
};

// `Entry<ND, I>::run(...)` instantiated for the level's axis count and
// index width.
template <template <int, typename> class Entry, typename... Args>
cudaError_t with_axes(const Geometry& g, Args&&... args) {
  const bool narrow = narrow_rows(g);
#define ICR_CASE(ND)                                              \
  return narrow ? Entry<ND, uint32_t>::run(g, args...)            \
                : Entry<ND, unsigned long long>::run(g, args...);
  switch (g.ndim) {
    case 1: ICR_CASE(1)
    case 2: ICR_CASE(2)
    case 3: ICR_CASE(3)
    case 4: ICR_CASE(4)
    default: ICR_CASE(0)
  }
#undef ICR_CASE
}

template <typename T>
struct RefineEntry {
  template <int ND, typename I>
  struct L {
    static cudaError_t run(const Geometry& g, Launcher& go, const T* coarse, const T* xi,
                           const T* olf, const T* ker, T* fine, int nrows) {
      return go(refine_entry_kernel<T, ND, I>, dim3(blocks_for(g.n_fine), nrows), 0, coarse, xi,
                olf, ker, fine, g);
    }
  };
};

template <typename T>
struct TransposeEntry {
  template <int ND, typename I>
  struct L {
    static cudaError_t run(const Geometry& g, Launcher& go, const T* cot, const T* olf,
                           const T* ker, T* scratch, T* cot_coarse, T* cot_xi, int nrows) {
      cudaError_t e = go(transpose_entry_kernel<T, ND, I>,
                         dim3(blocks_for(g.S * (g.W + g.F)), nrows), 0, cot, olf, ker, scratch,
                         cot_xi, g);
      if (e != cudaSuccess) return e;
      return go(transpose_gather_entry_kernel<T, ND, I>, dim3(blocks_for(g.n_coarse), nrows), 0,
                scratch, cot_coarse, g);
    }
  };
};

template <typename T>
cudaError_t run_refine(const Geometry& g, Launcher& go, const T* coarse, const T* xi, const T* olf,
                       const T* ker, T* fine, int nrows) {
  if (g.step_route == kEntry) {
    return with_axes<RefineEntry<T>::template L>(g, go, coarse, xi, olf, ker, fine, nrows);
  }
  if (!narrow_rows(g)) return cudaErrorInvalidValue;
  cudaError_t e = cudaErrorInvalidValue;
  with_shape(g, [&](auto shape) {
    using Sh = decltype(shape);
    if constexpr (Sh::ND == 2 && Sh::NF1 == 2) {
      // the vectors want pairs aligned to twice the value's size
      const bool aligned = (reinterpret_cast<uintptr_t>(xi) | reinterpret_cast<uintptr_t>(fine)) %
                               (2 * sizeof(T)) == 0;
      if (g.step_route == kThread && aligned) {
        const dim3 grid = thread_grid(g, nrows);
        e = go(refine_thread_kernel<T, Sh>, grid, site_smem_bytes<T, Sh, kThreads>(g), coarse, xi,
               olf, ker, fine, g, nrows, (nrows + grid.y - 1) / grid.y);
        return;
      }
    }
    if (g.step_route == kEntry) return;
    const dim3 grid = site_grid<Sh>(g, nrows);
    e = go(refine_site_kernel<T, Sh>, grid, site_smem_bytes<T, Sh>(g), coarse, xi, olf, ker,
           fine, g, nrows, (nrows + grid.y - 1) / grid.y);
  });
  return e;
}

template <typename T>
cudaError_t run_transpose(const Geometry& g, Launcher& go, const T* cot, const T* olf,
                          const T* ker, T* scratch, T* cot_coarse, T* cot_xi, int nrows) {
  if (g.transpose_route == kEntry) {
    return with_axes<TransposeEntry<T>::template L>(g, go, cot, olf, ker, scratch, cot_coarse,
                                                    cot_xi, nrows);
  }
  if (!narrow_rows(g)) return cudaErrorInvalidValue;
  cudaError_t e = cudaErrorInvalidValue;
  if (g.transpose_route == kBox) {
    with_shape(g, [&](auto shape) {
      using Sh = decltype(shape);
      long long boxes = 1;
      for (int a = 0; a < Sh::ND; ++a) boxes *= g.nbox[a];
      const bool pairs = (reinterpret_cast<uintptr_t>(cot) | reinterpret_cast<uintptr_t>(cot_xi)) %
                             (2 * sizeof(T)) == 0;
      e = go(transpose_box_kernel<T, Sh>, dim3(static_cast<unsigned>(boxes), nrows),
             box_smem_bytes<T, Sh>(g), cot, olf, ker, cot_coarse, cot_xi, g, pairs);
    });
    return e;
  }
  with_shape(g, [&](auto shape) {
    using Sh = decltype(shape);
    const dim3 grid = site_grid<Sh>(g, nrows);
    e = go(transpose_site_kernel<T, Sh>, grid, site_smem_bytes<T, Sh>(g), cot, olf, ker, scratch,
           cot_xi, g, nrows, (nrows + grid.y - 1) / grid.y);
    if (e != cudaSuccess) return;
    e = go(transpose_gather_slot_kernel<T, Sh>, dim3(blocks_for(g.n_coarse), nrows), 0, scratch,
           cot_coarse, g);
  });
  return e;
}

// Run `body` with `dev`, the device that holds the tensors, current;
// returns its error.
template <typename F>
cudaError_t on_device(int dev, F body) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  if (cur != dev && (err = cudaSetDevice(dev)) != cudaSuccess) return err;
  err = body();
  if (cur != dev) {
    const cudaError_t back = cudaSetDevice(cur);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

template <typename T>
int refine(const T* coarse, const T* xi, const T* olf, const T* ker, T* fine,
           const long long* geom, const void* const* tables, int nrows, int dev, void* stream) {
  Geometry g;
  if (!make_geometry(geom, tables, &g)) return -static_cast<int>(cudaErrorInvalidValue);
  if (nrows <= 0 || g.n_fine == 0) return 0;
  Launcher go{static_cast<cudaStream_t>(stream), nullptr, 0};
  const cudaError_t err = on_device(
      dev, [&] { return run_refine(g, go, coarse, xi, olf, ker, fine, nrows); });
  return err == cudaSuccess ? go.count : -static_cast<int>(err);
}

template <typename T>
int transpose(const T* cot, const T* olf, const T* ker, T* scratch, T* cot_coarse, T* cot_xi,
              const long long* geom, const void* const* tables, int nrows, int dev,
              void* stream) {
  Geometry g;
  if (!make_geometry(geom, tables, &g)) return -static_cast<int>(cudaErrorInvalidValue);
  if (nrows <= 0 || g.n_fine == 0) return 0;
  if (g.transpose_route != kBox && scratch == nullptr) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  Launcher go{static_cast<cudaStream_t>(stream), nullptr, 0};
  const cudaError_t err = on_device(dev, [&] {
    return run_transpose(g, go, cot, olf, ker, scratch, cot_coarse, cot_xi, nrows);
  });
  return err == cudaSuccess ? go.count : -static_cast<int>(err);
}

template <typename T>
int describe(const long long* geom, const void* const* tables, int transposed, long long* info,
             int dev) {
  Geometry g;
  if (!make_geometry(geom, tables, &g)) return -static_cast<int>(cudaErrorInvalidValue);
  Launcher go{nullptr, info, 0};
  T* none = nullptr;
  const cudaError_t err = on_device(dev, [&] {
    return transposed ? run_transpose<T>(g, go, none, none, none, none, none, none, 1)
                      : run_refine<T>(g, go, none, none, none, none, none, 1);
  });
  return err == cudaSuccess ? go.count : -static_cast<int>(err);
}

}  // namespace

extern "C" {

int icr_refine_max_axes() { return kMaxAxes; }

// The compiled shapes, (ndim, nw0, nf0, nw1, nf1) each, into `out`
// (room for 5 x cap); returns how many there are.
int icr_refine_shapes(int* out, int cap) {
  const int shapes[][5] = {{Line3::ND, Line3::NW0, Line3::NF0, Line3::NW1, Line3::NF1},
                           {Nest9::ND, Nest9::NW0, Nest9::NF0, Nest9::NW1, Nest9::NF1},
                           {Plane::ND, Plane::NW0, Plane::NF0, Plane::NW1, Plane::NF1},
                           {Shell::ND, Shell::NW0, Shell::NF0, Shell::NW1, Shell::NF1}};
  const int n = static_cast<int>(sizeof(shapes) / sizeof(shapes[0]));
  for (int i = 0; i < n && i < cap; ++i) {
    for (int j = 0; j < 5; ++j) out[5 * i + j] = shapes[i][j];
  }
  return n;
}

// Threads a block of every kernel (the host sizes its tiles by it).
int icr_refine_threads() { return kThreads; }

int icr_refine_f32(const float* coarse, const float* xi, const float* olf, const float* ker,
                   float* fine, const long long* geom, const void* const* tables, int nrows,
                   int dev, void* stream) {
  return refine(coarse, xi, olf, ker, fine, geom, tables, nrows, dev, stream);
}

int icr_refine_f64(const double* coarse, const double* xi, const double* olf, const double* ker,
                   double* fine, const long long* geom, const void* const* tables, int nrows,
                   int dev, void* stream) {
  return refine(coarse, xi, olf, ker, fine, geom, tables, nrows, dev, stream);
}

int icr_refine_transpose_f32(const float* cot, const float* olf, const float* ker,
                             float* scratch, float* cot_coarse, float* cot_xi,
                             const long long* geom, const void* const* tables, int nrows,
                             int dev, void* stream) {
  return transpose(cot, olf, ker, scratch, cot_coarse, cot_xi, geom, tables, nrows, dev, stream);
}

int icr_refine_transpose_f64(const double* cot, const double* olf, const double* ker,
                             double* scratch, double* cot_coarse, double* cot_xi,
                             const long long* geom, const void* const* tables, int nrows,
                             int dev, void* stream) {
  return transpose(cot, olf, ker, scratch, cot_coarse, cot_xi, geom, tables, nrows, dev, stream);
}

int icr_refine_describe_f32(const long long* geom, const void* const* tables, int transposed,
                            long long* info, int dev) {
  return describe<float>(geom, tables, transposed, info, dev);
}

int icr_refine_describe_f64(const long long* geom, const void* const* tables, int transposed,
                            long long* info, int dev) {
  return describe<double>(geom, tables, transposed, info, dev);
}

}  // extern "C"

// K11: the line-of-sight ray integral and its transpose, for Hopper (sm_90a).
//
//   forward:  y[b, r] = s[r] * sum_{e < E} w[r, e] * f[b, idx[r, e]]     (entries with idx < 0 skipped)
//   adjoint:  g[b, n] = sum_{(r, e) : idx[r, e] = n} w[r, e] * (s[r] * ybar[b, r])
//
// A ray r of the tomography response samples the field at P points; each
// point interpolates from the 2^d corners of its cell (order 1) or from
// one cell (order 0), so a ray holds E = P * 2^d (or P) entries of cell
// index and weight, in (point, corner) order, and s[r] = |end - start| / P.
// The host builds those tables once (ops/los_interp.py: los_tables); an
// entry whose corner lies outside the grid has index -1 and contributes
// nothing here (the wrapper adds NaN to its ray's value, as the JAX
// package's map_coordinates with cval = NaN gives).  Structured kernel
// interpolation is the same pair with P = 1, s = 1 and clipped indices.
//
// Replaces the XLA gather of nifty_tpu/responses/los.py:39 (map_coordinates
// in _ray_integral, vmapped over rays) and the scatter-add that autodiff
// makes of it, and ski.py:85-96 (apply_interpolation, adjoint_interpolation):
// XLA ops in the JAX package, not Pallas kernels.
//
// What bounds it.  The forward: its tables.  At the 256^3 tomography (1024
// rays x 256 points x 8 corners, float64) it reads the 8.4 MB index table,
// the 16.8 MB weights and the touched cells' values (6.1 MB): 0.0093 ms at
// 3.35 TB/s.  It reads the tables with streaming loads, so that L1 and L2
// keep the field values that neighbouring points share.  The adjoint: its
// output, the 134 MB grid written once (0.048 ms with its 25 MB CSR).
// Both would wait on the latency of dependent loads (an index before its
// field value; a cell's offsets before its rays' cotangents), so each
// thread issues its loads in batches before it adds them, and the
// adjoint's zeros are written apart from its sums, at the write rate.
//
// los_forward: a group of G lanes a ray, G a power of two from E alone: E
// rounded up while E <= 16 (SKI's 2^d corners, several rays a warp), else
// 32 W lanes (W warps, 1, 2, 4 or 8: E / 256 rounded up).  A block of 256
// threads holds 256 / G rays and a tile of 1, 2 or 4 rows (blockIdx.y), so
// each entry's index and weight are loaded once for the tile's rows; the
// host picks one row a block while the rays' blocks times the row tiles
// leave SMs idle, and up to kRowTile once they fill the card.  Lane t of a
// group takes entries t, t + G, ... kBatch at a time: their indices and
// weights first, then their field values, then it adds them in order,
// skipping index -1.  A butterfly in each warp (offsets below G) and, for
// W > 1, the warps' sums in warp order finish the ray.
//
// los_slab_forward: the (ray, row) partials of a rank's slab of the grid
// (ops/los_interp.py: LosSlab), y[b, (row - r0) * R + ray], in one launch.
// A *virtual ray* is a ray's valid entries in one row, in entry order, and
// its partial is the sum los_forward gives a ray of its entry count c: the
// lanes a group depend on c only through the power of two above it, so the
// partials have the bits of los_forward on tables padded to that power
// with index -1, and of every slab that holds the row.  The host keeps the
// virtual rays compact: a CSR of int32 cells and weights, each one's s_r
// and destination, sorted by group width, and a descriptor (first, end,
// group) for each block.  Fill blocks spread among those write +0 to the
// pairs a bit mask marks as holding no virtual ray, so every output is
// written once and nothing else is launched.  What bounds it: the valid
// entries (1.07 M at a 256^3 half slab, 12.8 MB in float64) and the
// partials written; but a virtual ray is short (27
// entries on average there), so a lane a thread would leave each thread
// one chain of dependent loads (descriptor, offsets, index, field value)
// with one entry at its end, and the grid several waves of such latency.
// So a thread plays several lanes of a group of a warp or less, as many
// (up to kBatch) as leave it at most kBatch entries: it walks the lanes'
// entries with their stride and loads them all before it adds any, each
// into its lane's sum, and adds its lanes with the butterfly's larger
// offsets itself.  Every thread then loads one batch.  Lanes, and so the
// bits, stay those of los_forward; the host picks the lanes a thread.
//
// los_adjoint: no atomics, and each output element is written once.  The
// host sorts the valid entries by cell (stable, so in (ray, entry) order
// within a cell): a CSR over the touched cells (cells, seg_off, seg_ray,
// seg_w), and a bit mask of one 32-bit word for 32 cells.  One launch holds
// two kinds of block on disjoint cells, the sum blocks spread evenly among
// the fill blocks so that the latency-bound sums run beside the zeros from
// the start:
//   - a fill block reads the mask alone and writes the zeros of the 32-byte
//     sectors that hold no touched cell, whole, as 16-byte stores with
//     consecutive threads on consecutive addresses, at the write rate;
//   - a sum block takes 256 touched cells of the compact list in CSR order,
//     one thread a cell, one row a thread for a one-row call and kRowTile
//     rows otherwise.  It first stages the scaled cotangents
//     s[r] * ybar[b, r] of its rows in shared memory where R x rows fits
//     kStageBytes (else each is computed from global memory where it is
//     used), then loads kBatch entries' rays and weights before it adds
//     them: an 88-entry segment costs 11 batches of loads, not 88 chains of
//     them.  The thread writes its cell's sum and the zeros of its sector's
//     untouched cells up to the next touched cell (the sector's first
//     touched cell also those before it), so no sector is written in part
//     by two blocks at different times, which makes the memory read it
//     back to merge the parts.
// Rows that do not start on a 32-byte boundary make the sector one cell.
//
// The bits do not depend on this design.  Every output element's sum
// takes the same terms in the same order from the same +0 as one thread
// walking the entries in order: lane t of a ray's group its entries t,
// t + G, ... (G from E alone), then the butterfly and the warps in order;
// a touched cell its segment in CSR order.  Each term is the same rounded
// product (s[r] * ybar is rounded before it is staged, as before it is
// used), and acc += w * x is written so that nvcc contracts it to one fma.
// A group narrower than a warp drops only butterfly steps that add an exact
// +0 (lanes past E, whose sums start at +0 and so are never -0), and a
// row's sums do not depend on the rows a block or a thread serves.  So the
// kernels give the bits of a whole warp a ray and one thread a grid cell,
// at every shape and number of rows.
//
// The C entry points launch on the caller's stream and return the number
// of kernels launched (1; 0 for an empty call), or the cudaError_t that
// stopped them (cudaGetLastError() after the launch) negated.  Nothing here
// allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 4;         // most rows a block serves; gridDim.y covers the rest
constexpr int kBatch = 8;           // entries a thread loads before it adds them
constexpr int kFillStores = 8;      // 16-byte stores a fill thread makes
constexpr int kStageBytes = 32768;  // most shared memory the staged cotangents take
constexpr int kMaxGridY = 65535;

// Warps a ray's group holds beyond 16 entries: E / 256 rounded up to a
// power of two, at most 8.
int warps_per_ray(int nent) {
  int w = 1;
  while (w < kWarps && w * kThreads < nent) w <<= 1;
  return w;
}

// Lanes a ray's group holds: E rounded up to a power of two while E <= 16,
// else 32 W.
int lanes_per_ray(int nent) {
  if (nent > 16) return 32 * warps_per_ray(nent);
  int g = 1;
  while (g < nent) g <<= 1;
  return g;
}

// The butterfly over the lanes of a group (offsets below `width`).
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < width) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One ray's sums over a tile's nb rows, by a group of `group` lanes (a
// power of two) played K lanes a thread: the group's span = group / K
// threads are consecutive, t the thread's place among them, and it plays
// lanes t, t + span, ..., t + (K - 1) span.  Lane l takes entries l,
// l + group, ... of the ray's `nent` at ir / wr, so the thread walks
// entries t, t + span, ... kBatch at a time (their indices and weights
// first, with streaming loads, then their field values, then the adds in
// order, skipping index -1), its n-th entry into lane n % K's sum.  The
// butterfly then adds lanes l and l + o for offsets o from group / 2 down:
// within the thread while o >= span, by shuffles below; for a group wider
// than a warp (K = 1), the warps' sums follow in warp order through
// `partial`.  The group's first thread writes row k's sum times *sp to
// out[k * stride] where `live`.  Every thread of the block calls it with
// the block's `group` and K.
template <typename T, int TILE, int K>
__device__ __forceinline__ void ray_forward(const T* __restrict__ fb, const int* __restrict__ ir,
                                            const T* __restrict__ wr, int nent, int t, int group,
                                            int nb, long long ncells, bool live,
                                            const T* __restrict__ sp, T* __restrict__ out,
                                            long long stride, T (*partial)[TILE]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int span = group / K;
  T acc[K][TILE];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int k = 0; k < TILE; ++k) acc[j][k] = T(0);
  for (int e0 = t; e0 < nent; e0 += kBatch * span) {
    int i[kBatch];
    T we[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      const int e = e0 + m * span;
      i[m] = e < nent ? __ldcs(ir + e) : -1;
      we[m] = e < nent ? __ldcs(wr + e) : T(0);
    }
    T v[kBatch][TILE];
#pragma unroll
    for (int m = 0; m < kBatch; ++m)
#pragma unroll
      for (int k = 0; k < TILE; ++k)
        v[m][k] = (i[m] >= 0 && k < nb) ? __ldg(fb + k * ncells + i[m]) : T(0);
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      if (i[m] < 0) continue;
#pragma unroll
      for (int k = 0; k < TILE; ++k)
        if (k < nb) acc[m % K][k] += we[m] * v[m][k];
    }
  }
#pragma unroll
  for (int h = K / 2; h > 0; h >>= 1)
#pragma unroll
    for (int j = 0; j < h; ++j)
#pragma unroll
      for (int k = 0; k < TILE; ++k) acc[j][k] += acc[j + h][k];
#pragma unroll
  for (int k = 0; k < TILE; ++k) acc[0][k] = group_sum(acc[0][k], span);
  if (group <= 32) {
    if (live && t == 0) {
      const T sr = __ldg(sp);
      for (int k = 0; k < nb; ++k) out[k * stride] = acc[0][k] * sr;
    }
    return;
  }
  const int wpr = group >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < TILE; ++k) partial[warp][k] = acc[0][k];
  }
  __syncthreads();
  if (live && lane == 0 && warp % wpr == 0) {
    const T sr = __ldg(sp);
    for (int k = 0; k < nb; ++k) {
      T v = partial[warp][k];
      for (int j = 1; j < wpr; ++j) v += partial[warp + j][k];
      out[k * stride] = v * sr;
    }
  }
}

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads)
    los_forward(const T* __restrict__ f, const int* __restrict__ idx, const T* __restrict__ w,
                const T* __restrict__ s, T* __restrict__ y, int nrays, int nent,
                long long ncells, int nrows, int group) {
  __shared__ T partial[kWarps][TILE];
  const int ray = blockIdx.x * (kThreads / group) + threadIdx.x / group;
  const bool live = ray < nrays;
  const int r = live ? ray : 0;
  const int b0 = blockIdx.y * TILE;
  ray_forward<T, TILE, 1>(f + static_cast<long long>(b0) * ncells,
                          idx + static_cast<long long>(r) * nent,
                          w + static_cast<long long>(r) * nent, live ? nent : 0,
                          threadIdx.x % group, group, min(TILE, nrows - b0), ncells, live, s + r,
                          y + static_cast<long long>(b0) * nrays + r, nrays, partial);
}

// Zeros to the (row, ray) pairs without a virtual ray among fill block
// `blk`'s kFillStores * kThreads pairs, in each of the tile's nb rows:
// the mask words first (a warp's 32 pairs share one), then the stores,
// consecutive threads on consecutive pairs.
template <typename T>
__device__ __forceinline__ void fill_empty_pairs(const uint32_t* __restrict__ empty,
                                                 T* __restrict__ y, long long nout, int b0,
                                                 int nb, int blk) {
  const long long first = static_cast<long long>(blk) * (kFillStores * kThreads) + threadIdx.x;
  uint32_t bits[kFillStores];
#pragma unroll
  for (int c = 0; c < kFillStores; ++c) {
    const long long p = first + c * kThreads;
    bits[c] = p < nout ? (__ldg(empty + (p >> 5)) >> (p & 31)) & 1u : 0u;
  }
  for (int k = 0; k < nb; ++k) {
    T* row = y + static_cast<long long>(b0 + k) * nout;
#pragma unroll
    for (int c = 0; c < kFillStores; ++c)
      if (bits[c]) row[first + c * kThreads] = T(0);
  }
}

// The (ray, row) partials of a slab, y[b, dest[v]] for every virtual ray v
// and +0 at the pairs that hold none.  Block x is a virtual-ray block where
// the count of them up to it steps (spread evenly among the fill blocks):
// its descriptor (first, end, group, lanes) gives its virtual rays
// [first, end), all of one group width, played `lanes` lanes a thread
// (1, 2, 4 or 8, and 1 for a group wider than a warp): kThreads / span of
// them, each summed by ray_forward on span = group / lanes threads as
// los_forward sums a ray of its entry count on `group` lanes.
template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads)
    los_slab_forward(const T* __restrict__ f, const int* __restrict__ off,
                     const int* __restrict__ idx, const T* __restrict__ w,
                     const T* __restrict__ vscale, const int* __restrict__ dest,
                     const int* __restrict__ blocks, const uint32_t* __restrict__ empty,
                     T* __restrict__ y, long long ncells, long long nout, int nrows, int nvblk,
                     int nfill) {
  __shared__ T partial[kWarps][TILE];
  const int b0 = blockIdx.y * TILE;
  const int nb = min(TILE, nrows - b0);
  const long long nblocks = static_cast<long long>(nvblk) + nfill;
  const long long bx = blockIdx.x;
  const long long before = bx * nvblk / nblocks;
  if ((bx + 1) * nvblk / nblocks == before) {
    fill_empty_pairs(empty, y, nout, b0, nb, static_cast<int>(bx - before));
    return;
  }
  const int4 desc = __ldg(reinterpret_cast<const int4*>(blocks) + before);
  const int group = desc.z, lanes = desc.w;
  const int span = group / lanes;
  const int v = desc.x + threadIdx.x / span;
  const bool live = v < desc.y;
  const int lo = live ? __ldg(off + v) : 0;
  const int nent = live ? __ldg(off + v + 1) - lo : 0;
  const long long d = live ? __ldg(dest + v) : 0;
  const T* fb = f + static_cast<long long>(b0) * ncells;
  const int t = threadIdx.x % span;
  T* out = y + static_cast<long long>(b0) * nout + d;
  const T* sp = vscale + (live ? v : 0);
  switch (lanes) {
    case 8:
      ray_forward<T, TILE, 8>(fb, idx + lo, w + lo, nent, t, group, nb, ncells, live, sp, out,
                              nout, partial);
      break;
    case 4:
      ray_forward<T, TILE, 4>(fb, idx + lo, w + lo, nent, t, group, nb, ncells, live, sp, out,
                              nout, partial);
      break;
    case 2:
      ray_forward<T, TILE, 2>(fb, idx + lo, w + lo, nent, t, group, nb, ncells, live, sp, out,
                              nout, partial);
      break;
    default:
      ray_forward<T, TILE, 1>(fb, idx + lo, w + lo, nent, t, group, nb, ncells, live, sp, out,
                              nout, partial);
  }
}

// Zeros to the sectors without a touched cell among fill block `blk`'s, in
// one row of the tile's `rows` (blk % rows), as 16-byte stores of half a
// sector, consecutive threads on consecutive halves: kFillStores runs of
// kThreads halves, the mask words first, then the stores.
template <typename T>
__device__ __forceinline__ void fill_untouched(const uint32_t* __restrict__ mask,
                                               T* __restrict__ g, long long ncells, int b0,
                                               int nb, int rows, int blk, int sector) {
  const int k = blk % rows;
  if (k >= nb) return;
  T* out = g + static_cast<long long>(b0 + k) * ncells;
  const int per = sector > 1 ? sector / 2 : 1;  // cells a store
  const long long first = static_cast<long long>(blk / rows) * (kFillStores * kThreads) +
                          threadIdx.x;
  uint32_t bits[kFillStores];
#pragma unroll
  for (int c = 0; c < kFillStores; ++c) {
    const long long n0 = (first + c * kThreads) * per;
    const long long base = n0 - (n0 & (sector - 1));  // the sector's first cell
    bits[c] = n0 < ncells ? __ldg(mask + (base >> 5)) >> (base & 31) : 1u;
  }
#pragma unroll
  for (int c = 0; c < kFillStores; ++c) {
    const long long n0 = (first + c * kThreads) * per;
    if (bits[c] & ((1u << sector) - 1u)) continue;
    if (sector == 1)
      out[n0] = T(0);
    else
      *reinterpret_cast<int4*>(out + n0) = make_int4(0, 0, 0, 0);
  }
}

// TILE rows a thread (1, or kRowTile for calls of more than one row);
// `sector` the cells of a 32-byte sector (4 float64, 8 float32) where every
// row starts on a sector boundary, else 1.
template <typename T, int TILE, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    los_adjoint(const T* __restrict__ ybar, const uint32_t* __restrict__ mask,
                const int* __restrict__ cells, const int* __restrict__ seg_off,
                const int* __restrict__ seg_ray, const T* __restrict__ seg_w,
                const T* __restrict__ s, T* __restrict__ g, long long ncells, int nrays,
                int ntouched, int nrows, int nsum, int nfill, int sector) {
  const int b0 = blockIdx.y * TILE;
  const int nb = min(TILE, nrows - b0);
  // block x is a sum block where the count of sum blocks up to it steps
  const long long nblocks = static_cast<long long>(nsum) + nfill;
  const long long bx = blockIdx.x;
  const long long sums_before = bx * nsum / nblocks;
  if ((bx + 1) * nsum / nblocks == sums_before) {
    fill_untouched(mask, g, ncells, b0, nb, min(TILE, nrows), static_cast<int>(bx - sums_before),
                   sector);
    return;
  }
  // the cell and its segment, loaded beside the staging
  const int u = static_cast<int>(sums_before) * kThreads + threadIdx.x;
  const bool live = u < ntouched;
  const int n = live ? __ldg(cells + u) : 0;
  const int lo = live ? __ldg(seg_off + u) : 0;
  const int hi = live ? __ldg(seg_off + u + 1) : 0;
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  T* scaled = reinterpret_cast<T*>(stage_bytes);
  const T* yb = ybar + static_cast<long long>(b0) * nrays;
  if (STAGED) {
    for (int i = threadIdx.x; i < nb * nrays; i += kThreads)
      scaled[i] = __ldg(s + i % nrays) * __ldg(yb + i);
    __syncthreads();
  }
  if (!live) return;
  // the touched cells of n's sector, bit q for cell n - p + q
  const int p = n & (sector - 1);
  const uint32_t near = (__ldg(mask + (n >> 5)) >> ((n & 31) - p)) & ((1u << sector) - 1u);
  T acc[TILE];
#pragma unroll
  for (int k = 0; k < TILE; ++k) acc[k] = T(0);
  for (int j0 = lo; j0 < hi; j0 += kBatch) {
    // the batch's rays and weights, then its scaled cotangents (row and ray
    // clamped into the tables: a batch past the segment's end and rows past
    // the call's are loaded but not added), then the sums in order
    int r[kBatch];
    T we[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      r[m] = j0 + m < hi ? __ldg(seg_ray + j0 + m) : 0;
      we[m] = j0 + m < hi ? __ldg(seg_w + j0 + m) : T(0);
    }
    T sc[kBatch][TILE];
#pragma unroll
    for (int m = 0; m < kBatch; ++m)
#pragma unroll
      for (int k = 0; k < TILE; ++k) {
        const int row = min(k, nb - 1) * nrays + r[m];
        sc[m][k] = STAGED ? scaled[row] : __ldg(s + r[m]) * __ldg(yb + row);
      }
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      if (j0 + m >= hi) break;
#pragma unroll
      for (int k = 0; k < TILE; ++k) acc[k] += we[m] * (sc[m][k]);
    }
  }
  // zeros from the sector's start (where n is its first touched cell) or
  // from n up to the next touched cell or the sector's end
  const uint32_t above = near >> (p + 1);
  const int from = (near & ((1u << p) - 1u)) ? p : 0;
  const int to = above ? p + __ffs(above) : sector;
  for (int k = 0; k < nb; ++k) {
    T* row = g + static_cast<long long>(b0 + k) * ncells + (n - p);
    for (int q = from; q < to; ++q) row[q] = q == p ? acc[k] : T(0);
  }
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

constexpr int kInvalid = -static_cast<int>(cudaErrorInvalidValue);

template <typename T>
int launch_forward(const void* f, const void* idx, const void* w, const void* s, void* y,
                   int nrays, int nent, long long ncells, int nrows, int tile, int dev,
                   void* stream) {
  if (nrays == 0 || nrows == 0) return 0;
  const int tiles = (nrows + tile - 1) / tile;
  if ((tile != 1 && tile != 2 && tile != kRowTile) || tiles > kMaxGridY) return kInvalid;
  const int group = lanes_per_ray(nent);
  const int rays_per_block = kThreads / group;
  const dim3 grid((nrays + rays_per_block - 1) / rays_per_block, tiles);
  const int err = on_device(dev, [&]() {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const T* fp = static_cast<const T*>(f);
    const int* ip = static_cast<const int*>(idx);
    const T* wp = static_cast<const T*>(w);
    const T* sp = static_cast<const T*>(s);
    T* yp = static_cast<T*>(y);
    if (tile == 1)
      los_forward<T, 1><<<grid, kThreads, 0, st>>>(fp, ip, wp, sp, yp, nrays, nent, ncells, nrows, group);
    else if (tile == 2)
      los_forward<T, 2><<<grid, kThreads, 0, st>>>(fp, ip, wp, sp, yp, nrays, nent, ncells, nrows, group);
    else
      los_forward<T, kRowTile><<<grid, kThreads, 0, st>>>(fp, ip, wp, sp, yp, nrays, nent, ncells,
                                                          nrows, group);
    return cudaGetLastError();
  });
  return err != 0 ? -err : 1;
}

template <typename T>
int launch_slab_forward(const void* f, const void* off, const void* idx, const void* w,
                        const void* vscale, const void* dest, const void* blocks,
                        const void* empty, void* y, long long ncells, long long nout, int nrows,
                        int nvblk, int tile, int dev, void* stream) {
  if (nout == 0 || nrows == 0) return 0;
  const int tiles = (nrows + tile - 1) / tile;
  if ((tile != 1 && tile != 2 && tile != kRowTile) || tiles > kMaxGridY || nvblk < 0)
    return kInvalid;
  const long long per_block = static_cast<long long>(kFillStores) * kThreads;
  const long long nfill = (nout + per_block - 1) / per_block;
  if (nvblk + nfill > 0x7fffffffLL) return kInvalid;
  const dim3 grid(static_cast<unsigned>(nvblk + nfill), tiles);
  const int err = on_device(dev, [&]() {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto run = [&](auto kernel) {
      kernel<<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(f), static_cast<const int*>(off), static_cast<const int*>(idx),
          static_cast<const T*>(w), static_cast<const T*>(vscale),
          static_cast<const int*>(dest), static_cast<const int*>(blocks),
          static_cast<const uint32_t*>(empty), static_cast<T*>(y), ncells, nout, nrows, nvblk,
          static_cast<int>(nfill));
    };
    if (tile == 1)
      run(los_slab_forward<T, 1>);
    else if (tile == 2)
      run(los_slab_forward<T, 2>);
    else
      run(los_slab_forward<T, kRowTile>);
    return cudaGetLastError();
  });
  return err != 0 ? -err : 1;
}

template <typename T>
int launch_adjoint(const void* ybar, const void* mask, const void* cells, const void* seg_off,
                   const void* seg_ray, const void* seg_w, const void* s, void* g,
                   long long ncells, int nrays, int ntouched, int nrows, int dev, void* stream) {
  if (ncells == 0 || nrows == 0) return 0;
  const int tile = nrows == 1 ? 1 : kRowTile;
  const int tiles = (nrows + tile - 1) / tile;
  if (tiles > kMaxGridY) return kInvalid;
  // whole 32-byte sectors where every row starts on a sector boundary
  const int wide = 32 / static_cast<int>(sizeof(T));
  const int sector = reinterpret_cast<uintptr_t>(g) % 32 == 0 && ncells % wide == 0 ? wide : 1;
  const long long per_block = static_cast<long long>(kFillStores) * kThreads *
                              (sector > 1 ? sector / 2 : 1);
  const long long nfill = (nrows < tile ? nrows : tile) * ((ncells + per_block - 1) / per_block);
  const long long nsum = (static_cast<long long>(ntouched) + kThreads - 1) / kThreads;
  if (nfill + nsum > 0x7fffffffLL) return kInvalid;
  const long long stage = static_cast<long long>(nrows < tile ? nrows : tile) * nrays *
                          static_cast<long long>(sizeof(T));
  const dim3 grid(static_cast<unsigned>(nsum + nfill), tiles);
  const int err = on_device(dev, [&]() {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto run = [&](auto kernel, size_t smem) {
      kernel<<<grid, kThreads, smem, st>>>(
          static_cast<const T*>(ybar), static_cast<const uint32_t*>(mask),
          static_cast<const int*>(cells), static_cast<const int*>(seg_off),
          static_cast<const int*>(seg_ray), static_cast<const T*>(seg_w),
          static_cast<const T*>(s), static_cast<T*>(g), ncells, nrays, ntouched, nrows,
          static_cast<int>(nsum), static_cast<int>(nfill), sector);
    };
    const bool staged = stage <= kStageBytes;
    if (tile == 1)
      staged ? run(los_adjoint<T, 1, true>, stage) : run(los_adjoint<T, 1, false>, 0);
    else
      staged ? run(los_adjoint<T, kRowTile, true>, stage)
             : run(los_adjoint<T, kRowTile, false>, 0);
    return cudaGetLastError();
  });
  return err != 0 ? -err : 1;
}

}  // namespace

extern "C" {

#define LOS_FORWARD_ENTRY(name, T)                                                          \
  int name(const void* f, const void* idx, const void* w, const void* s, void* y,         \
           int nrays, int nent, long long ncells, int nrows, int row_tile, int dev,       \
           void* stream) {                                                                \
    return launch_forward<T>(f, idx, w, s, y, nrays, nent, ncells, nrows, row_tile, dev,  \
                             stream);                                                     \
  }

LOS_FORWARD_ENTRY(los_forward_f32, float)
LOS_FORWARD_ENTRY(los_forward_f64, double)

#define LOS_ADJOINT_ENTRY(name, T)                                                          \
  int name(const void* ybar, const void* mask, const void* cells, const void* seg_off,    \
           const void* seg_ray, const void* seg_w, const void* s, void* g,                \
           long long ncells, int nrays, int ntouched, int nrows, int dev, void* stream) { \
    return launch_adjoint<T>(ybar, mask, cells, seg_off, seg_ray, seg_w, s, g, ncells,    \
                             nrays, ntouched, nrows, dev, stream);                        \
  }

LOS_ADJOINT_ENTRY(los_adjoint_f32, float)
LOS_ADJOINT_ENTRY(los_adjoint_f64, double)

#define LOS_SLAB_FORWARD_ENTRY(name, T)                                                     \
  int name(const void* f, const void* off, const void* idx, const void* w,                \
           const void* vscale, const void* dest, const void* blocks, const void* empty,   \
           void* y, long long ncells, long long nout, int nrows, int nvblk, int row_tile, \
           int dev, void* stream) {                                                       \
    return launch_slab_forward<T>(f, off, idx, w, vscale, dest, blocks, empty, y, ncells, \
                                  nout, nrows, nvblk, row_tile, dev, stream);             \
  }

LOS_SLAB_FORWARD_ENTRY(los_slab_forward_f32, float)
LOS_SLAB_FORWARD_ENTRY(los_slab_forward_f64, double)

// The most rows a block serves, the entries a thread loads before it adds
// them (which bound the lanes a thread of the slab forward plays), and the
// lanes a ray's group holds; the host checks each against its own.
int los_interp_row_tile() { return kRowTile; }
int los_interp_batch() { return kBatch; }
int los_interp_lanes_per_ray(int nent) { return lanes_per_ray(nent); }

}  // extern "C"

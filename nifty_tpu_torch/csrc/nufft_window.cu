// K7: the window pair of the non-uniform FFT, for Hopper (sm_90a).
//
//   interp:  v[b, j] = sum_{t in W^d} phi_t(x_j) * g[b, (i0_j + off_t) mod n]
//   spread:  g[b, c] = sum_{(j, t) : (i0_j + off_t) mod n = c} phi_t(x_j) * v[b, j]
//
// g is the complex oversampled spectrum, (B, n_0 * ... * n_{d-1}) row-major,
// x_j the position of point j on that grid (its frequency times n_os / n),
// i0_j = floor(x_j) per axis, off_t = t - W/2 + 1 for t < W per axis, and
// phi_t(x) the product over the axes of the exp-of-semicircle kernel
// exp(beta (sqrt(1 - s^2) - 1)) at s = (x_a - (i0_a + off_t_a)) / (W / 2),
// the first axis's factor first.  The host builds the tables
// (ops/nufft_window.py): the positions (npts, d); a CSR over the cells (the
// points sorted by the flat index of their base cell i0 mod n, stable, with
// each cell's offsets); each point's first tap cell per axis, wrapped, in
// CSR order; the spread's sum blocks and fill chunks.  nufft_factors builds
// the one device table, at a table's first use on the card: each point's
// d x W axis factors phi_t(x_a), in CSR order, (npts, d, W).
//
// Replaces the window gather of nifty_tpu/ops/nufft.py:204-247
// (interp_point vmapped over the points, and its sorted-gather variant
// :181-202) and the scatter-add that autodiff makes of it for nufft1
// (:251-265): XLA ops in the JAX package, not Pallas kernels.
//
// What bounds it.  The interp reads, for each point, its position and the
// W^d values of its window (neighbouring points share most of them) and
// writes its value: at phase 35's densest w-plane (423,235 points on a
// 2048^2 grid, 202,283 cells reached, float64) the reached cells once, the
// positions and the output, 0.0050 ms at 3.35 TB/s.  The spread writes
// every cell of the grid once (67 MB) and reads the positions and values,
// 0.024 ms.  W^d = 64 complex-by-real multiply-adds a point are far below
// either.  The factor table's build writes 54 MB there (0.019 ms).  What
// held the first kernels (commit c550464) back was latency and arithmetic
// that the bound does not count: every term recomputed its weights (a
// divide, a sqrt and an exp a factor, in double) at the end of the
// dependent chain csr_pts[k] -> xs[j] -> v[j], and the spread's blocks that
// no window reaches wrote their zeros from one thread in eight.  What holds
// these back: the interp its registers (occupancy), and the spread the
// longest walk of one lane, which the order fixes (2,004 terms on the
// 378,312-point plane, whose densest base cell holds 377 points).
//
// nufft_factors: one thread a factor, coalesced; es_weight is the code the
// first kernels inlined, so each factor carries the bits they computed.
// The interp reads 2W of them a point where it computed 2W exponentials,
// the spread 2 (3 in 3-D) a term where it computed 2W^d a point.
// nufft_gather: the rows' values in CSR order, vg[b, k] = v[b, csr_pts[k]],
// one thread an element, each call.
//
// nufft_interp: one thread a point in CSR order (writing out[b, csr_pts[k]]),
// one row b a block (blockIdx.y; a call of more than 65,535 rows launches
// again), the block's points' factors staged in shared memory.  The
// innermost axis's W factors and wrapped columns sit in registers; the
// leading taps are the rows, row-major, and a row's grid values are loaded
// 8 taps at a time before they are summed.  Fewer registers won over more
// loads in flight (chip_smoke.py phase 34 on an H100 at the densest plane):
// the next row's loads issued before this row's sums, 114 registers a
// thread, took 0.060 ms against 0.048 at 80; a tile of 4 rows a block,
// registers for 32 values in flight, took 0.25 ms.
//
// nufft_spread: keyed on the output, no atomics.  One launch holds two
// kinds of block on disjoint cells, the sum blocks spread evenly among the
// fill blocks (as in csrc/los_interp.cu) so that the latency-bound sums run
// beside the write-bound zeros from the start, and in the host's order of
// the blocks that some window reaches: the most terms first, so that the
// longest walks, at the dense centre of a uv coverage, start at once:
//   - a fill block writes the zeros of one chunk (at most kFillCells) of
//     cells of blocks that no window reaches, for each row of its tile,
//     with every thread: 16-byte stores by consecutive threads, so whole
//     32-byte sectors;
//   - a sum block takes kSpreadCells (32) consecutive cells along the
//     innermost axis of one line, a group of kLanes (8) threads a cell.  It
//     stages in shared memory the CSR offsets of the kSpreadCells + W - 1
//     base cells its windows reach along the innermost axis (wrapped), for
//     up to kStageRows leading taps at once (all W of them in 2-D), and
//     skips the walk where none holds a point.  A cell's items are its
//     (leading tap, innermost tap) pairs, each a base cell whose points it
//     walks in CSR order, item i of a stage to lane i % kLanes; each term
//     reads its point's factors and values at consecutive CSR positions, a
//     batch of terms' loads issued before their sums.  The lanes' sums meet
//     in a butterfly.
// A block serves 1 or kRowTile rows (blockIdx.y; one while a call has one
// row or its blocks of one row number at most kOneRowBlocks).
//
// The bits are the first kernels'.  Each output element takes the same
// terms in the same order from the same +0:
//   spread: a cell's items in stages of kStageRows leading taps, row-major
//     in a stage; item i to lane i % kLanes; a lane its items in turn and a
//     base cell's points in CSR order; each term
//     re = fma((double)(w_lead * w_inner), (double)val.x, re), the product
//     in R (in 3-D (w0 * w1) * w2), which is what nvcc made of their
//     re += (double)w * (double)val.x; the xor butterfly 4, 2, 1; a cell
//     that no window reaches +0;
//   interp: the W^d taps row-major (innermost fastest) on double
//     accumulators, each term an fma, the leading factor times the
//     innermost one in R (in 3-D (w0 * w1) * w_t).
// The factors are es_weight of the same operands, and the order of the
// blocks, the fill's chunks and the points' threads touch no sum.  So both
// kernels give the first kernels' bits at every shape and number of rows
// (chip_smoke.py phase 34 holds them to digests pinned from those at its
// shapes, and tests/test_torch_cuda_kernels.py at the card tests' cases).
//
// The C entry points return the number of kernels launched, or the
// cudaError_t that stopped them (cudaGetLastError() after the launch)
// negated.  Nothing here allocates or synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// the rows a spread block serves where a call has more than one row and
// more than kOneRowBlocks blocks of one row (below it the card has room to
// run each row apart: four blocks an SM of the H100's 132 would be 528;
// above it a block reads its tables once for kRowTile rows)
constexpr int kRowTile = 4;
constexpr long long kOneRowBlocks = 512;
constexpr int kMaxWidth = 16;
constexpr int kMaxGridY = 65535;
// the leading taps whose CSR offsets a spread block stages at once
constexpr int kStageRows = 16;
// a spread block's cells along the innermost axis, and the lanes a cell
constexpr int kLanes = 8;
constexpr int kSpreadCells = kThreads / kLanes;
// the most cells of a spread fill chunk
constexpr int kFillCells = 2048;
// the terms a spread lane loads before it adds them: kBatch1 for a tile of
// one row, kBatchTile for kRowTile rows (see walk)
constexpr int kBatch1 = 4;
constexpr int kBatchTile = 2;

struct Dims {
  int n[3];
};

template <typename R>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

__device__ __forceinline__ float k_exp(float x) { return expf(x); }
__device__ __forceinline__ double k_exp(double x) { return exp(x); }
__device__ __forceinline__ float k_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double k_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float k_floor(float x) { return floorf(x); }
__device__ __forceinline__ double k_floor(double x) { return floor(x); }
__device__ __forceinline__ float k_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double k_abs(double x) { return fabs(x); }
__device__ __forceinline__ float k_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double k_max(double a, double b) { return fmax(a, b); }
// 1 - s * s rounded twice, never contracted to one fma: near the window's
// edge (|s| -> 1) sqrt(1 - s^2) magnifies that rounding, so the kernel
// rounds as the plain versions and the JAX package do
__device__ __forceinline__ float k_one_minus_sq(float s) {
  return __fsub_rn(1.0f, __fmul_rn(s, s));
}
__device__ __forceinline__ double k_one_minus_sq(double s) {
  return __dsub_rn(1.0, __dmul_rn(s, s));
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

// The kernel at the tap whose cell is `cell` (i0 + off, unwrapped) for a
// point at `x`: phi((x - cell) / half), 0 outside |s| <= 1.
template <typename R>
__device__ __forceinline__ R es_weight(R x, int cell, R beta, R half) {
  const R s = (x - static_cast<R>(cell)) / half;
  const R arg = k_max(k_one_minus_sq(s), R(0));
  return k_abs(s) <= R(1) ? k_exp(beta * (k_sqrt(arg) - R(1))) : R(0);
}

// fac[k, a, t] = phi_t(x_a) of the point at CSR position k: one thread a
// factor, in the order they are stored.
template <typename R>
__global__ void __launch_bounds__(kThreads)
    nufft_factors(const R* __restrict__ xs, const int* __restrict__ csr_pts, R* __restrict__ fac,
                  long long nfac, int d, int width, R beta, R half) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nfac) return;
  const int t = static_cast<int>(i % width);
  const long long ka = i / width;
  const int a = static_cast<int>(ka % d);
  const R x = xs[static_cast<long long>(csr_pts[ka / d]) * d + a];
  fac[i] = es_weight(x, static_cast<int>(k_floor(x)) - (width / 2 - 1) + t, beta, half);
}

// vg[b, k] = v[b, csr_pts[k]]: the values of `nrows` rows in CSR order.
template <typename R>
__global__ void __launch_bounds__(kThreads)
    nufft_gather(const R* __restrict__ v, const int* __restrict__ csr_pts, R* __restrict__ vg,
                 int npts, long long n) {
  using V2 = typename Vec2<R>::type;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long row = i / npts;
  reinterpret_cast<V2*>(vg)[i] =
      reinterpret_cast<const V2*>(v)[row * npts + csr_pts[i - row * npts]];
}

template <typename R, int D, int MW>
__global__ void __launch_bounds__(kThreads)
    nufft_interp(const R* __restrict__ g, const R* __restrict__ fac,
                 const int* __restrict__ csr_first, const int* __restrict__ csr_pts,
                 R* __restrict__ out, int npts, Dims dims, int width) {
  using V2 = typename Vec2<R>::type;
  // the block's points' factors, copied with consecutive threads on
  // consecutive addresses, a point's d x W of them d x W + 1 apart
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  R* staged = reinterpret_cast<R*>(stage_bytes);
  const int stride = D * width, pitch = stride + 1;  // an odd pitch: no bank conflicts
  const int kb = blockIdx.x * kThreads;
  const int nk = npts - kb < kThreads ? npts - kb : kThreads;
  for (int i = threadIdx.x; i < nk * stride; i += kThreads)
    staged[(i / stride) * pitch + i % stride] = fac[static_cast<long long>(kb) * stride + i];
  __syncthreads();
  const int k = kb + threadIdx.x;
  if (k >= npts) return;
  const long long ncells = static_cast<long long>(dims.n[0]) * dims.n[1] * dims.n[2];
  const V2* gv = reinterpret_cast<const V2*>(g) + blockIdx.y * ncells;  // this block's row
  const R* f = staged + threadIdx.x * pitch;
  const int nl = dims.n[D - 1];

  // the innermost axis's factors and wrapped columns
  R wl[MW];
  int col[MW];
  {
    int c = csr_first[static_cast<long long>(k) * D + D - 1];
#pragma unroll
    for (int t = 0; t < MW; ++t) {
      wl[t] = t < width ? f[(D - 1) * width + t] : R(0);
      col[t] = c;
      c = c + 1 == nl ? 0 : c + 1;
    }
  }
  // the leading taps' wrapped coordinates, advanced row by row (row-major)
  int c0 = D > 1 ? csr_first[static_cast<long long>(k) * D] : 0;
  const int first1 = D > 2 ? csr_first[static_cast<long long>(k) * D + 1] : 0;
  int c1 = first1, t0 = 0, t1 = 0;

  // a leading row's values, 8 taps at a time, loaded before they are summed
  double re = 0.0, im = 0.0;
  const int nlead = D == 1 ? 1 : (D == 2 ? width : width * width);
#pragma unroll 1
  for (int row = 0; row < nlead; ++row) {
    long long line = 0;
    R w = R(1);  // the leading factor (in 3-D the product of two, first axis first)
    if constexpr (D == 2) {
      line = static_cast<long long>(c0) * nl;
      w = f[t0];
    }
    if constexpr (D == 3) {
      line = (static_cast<long long>(c0) * dims.n[1] + c1) * nl;
      w = f[t0] * f[width + t1];
    }
#pragma unroll
    for (int t8 = 0; t8 < MW; t8 += 8) {
      V2 vals[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (t8 + j < width) vals[j] = gv[line + col[t8 + j]];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (t8 + j < width) {
          R wt = wl[t8 + j];
          if constexpr (D > 1) wt = w * wl[t8 + j];
          re = fma(static_cast<double>(wt), static_cast<double>(vals[j].x), re);
          im = fma(static_cast<double>(wt), static_cast<double>(vals[j].y), im);
        }
      }
    }
    if constexpr (D == 2) {
      ++t0;
      c0 = c0 + 1 == dims.n[0] ? 0 : c0 + 1;
    }
    if constexpr (D == 3) {
      if (++t1 == width) {
        t1 = 0;
        c1 = first1;
        ++t0;
        c0 = c0 + 1 == dims.n[0] ? 0 : c0 + 1;
      } else {
        c1 = c1 + 1 == dims.n[1] ? 0 : c1 + 1;
      }
    }
  }
  V2 o;
  o.x = static_cast<R>(re);
  o.y = static_cast<R>(im);
  reinterpret_cast<V2*>(out)[static_cast<long long>(blockIdx.y) * npts + csr_pts[k]] = o;
}

// +0 to `count` cells from `dst`, every thread of the block: 16-byte
// stores by consecutive threads (a float2 cell before them where `dst` is
// not on a 16-byte boundary, and one after them where a cell is left).
template <typename V2>
__device__ __forceinline__ void zero_cells(V2* __restrict__ dst, int count) {
  constexpr int per = 16 / static_cast<int>(sizeof(V2));  // cells a store
  const int head = per > 1 && (reinterpret_cast<uintptr_t>(dst) & 15) && count > 0 ? 1 : 0;
  const int body = (count - head) / per;
  int4* q = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += kThreads) q[i] = make_int4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    V2 zero;
    zero.x = zero.y = 0;
    if (head) dst[0] = zero;
    for (int c = head + body * per; c < count; ++c) dst[c] = zero;
  }
}

// One lane's walk of the points at CSR positions [lo, hi) of a base cell:
// factors `lead` (and `mid` in 3-D) and `inner` of each point's d x W, the
// rows' values vv[r * npts + k]; a batch's loads (none past hi) before its
// sums, the sums in CSR order.  Batches of kBatch1 = 4 terms for a one-row
// tile: 8 terms, or loads clamped into the range instead of skipped past
// it, ran slower at phase 35's planes (most base cells hold 1 to 3 points).
template <typename R, int D, int RT>
__device__ __forceinline__ void walk(const R* __restrict__ fac,
                                     const typename Vec2<R>::type* __restrict__ vv, int lo,
                                     int hi, int stride, int lead, int mid, int inner, int npts,
                                     int nr, double (&re)[RT], double (&im)[RT]) {
  using V2 = typename Vec2<R>::type;
  constexpr int kBatch = RT == 1 ? kBatch1 : kBatchTile;
  for (int k0 = lo; k0 < hi; k0 += kBatch) {
    R fl[kBatch], fm[kBatch], fi[kBatch];
    V2 val[kBatch][RT];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      if (k0 + m < hi) {
        const int k = k0 + m;
        const R* fk = fac + static_cast<long long>(k) * stride;
        fi[m] = fk[inner];
        fl[m] = D > 1 ? fk[lead] : R(1);
        fm[m] = D > 2 ? fk[mid] : R(1);
#pragma unroll
        for (int r = 0; r < RT; ++r)
          if (r < nr) val[m][r] = vv[static_cast<long long>(r) * npts + k];
      }
    }
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      if (k0 + m < hi) {
        R w;
        if constexpr (D == 1) w = fi[m];
        if constexpr (D == 2) w = fl[m] * fi[m];
        if constexpr (D == 3) w = fl[m] * fm[m] * fi[m];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < nr) {
            re[r] = fma(static_cast<double>(w), static_cast<double>(val[m][r].x), re[r]);
            im[r] = fma(static_cast<double>(w), static_cast<double>(val[m][r].y), im[r]);
          }
        }
      }
    }
  }
}

template <typename R, int D, int RT>
__global__ void __launch_bounds__(kThreads)
    nufft_spread(const R* __restrict__ vg, const R* __restrict__ fac,
                 const int* __restrict__ csr_off, const int* __restrict__ sum_blocks,
                 const int2* __restrict__ fill, R* __restrict__ out, int npts, Dims dims,
                 int width, int nrows, int nsum, int nfill) {
  using V2 = typename Vec2<R>::type;
  constexpr int kSpan = kSpreadCells + kMaxWidth - 1;
  __shared__ int s_lo[kStageRows][kSpan];
  __shared__ int s_hi[kStageRows][kSpan];
  const int r0 = blockIdx.y * RT;
  const int nr = nrows - r0 < RT ? nrows - r0 : RT;
  const long long ncells = static_cast<long long>(dims.n[0]) * dims.n[1] * dims.n[2];
  // block x is a sum block where the count of sum blocks up to it steps
  const long long nblocks = static_cast<long long>(nsum) + nfill;
  const long long bx = blockIdx.x;
  const int sums_before = static_cast<int>(bx * nsum / nblocks);
  if ((bx + 1) * nsum / nblocks == sums_before) {  // a fill block: no window reaches these cells
    const int2 chunk = fill[bx - sums_before];
    for (int r = 0; r < nr; ++r)
      zero_cells(reinterpret_cast<V2*>(out) + (r0 + r) * ncells + chunk.x, chunk.y);
    return;
  }
  const int nl = dims.n[D - 1];
  const int segs = (nl + kSpreadCells - 1) / kSpreadCells;
  const int blk = sum_blocks[sums_before];
  const int line = blk / segs;  // the flat index of the leading coordinates
  const int s0 = (blk % segs) * kSpreadCells;
  const int cell = threadIdx.x / kLanes;  // this thread's cell in the block
  const int lane = threadIdx.x % kLanes;  // its lane in the cell's group
  const int c = s0 + cell;
  const bool valid = c < nl;
  const V2* vv = reinterpret_cast<const V2*>(vg) + static_cast<long long>(r0) * npts;
  V2* ov = reinterpret_cast<V2*>(out) + r0 * ncells + static_cast<long long>(line) * nl + c;
  const int lo_shift = width / 2 - 1;  // off_t = t - lo_shift
  const int span = kSpreadCells + width - 1;
  const int base_start = s0 - width + width / 2;  // the base cell of c = s0, t = W - 1
  const int stride = D * width;                   // factors a point

  int lead[2] = {0, 0};  // this line's leading coordinates
  if constexpr (D == 2) lead[0] = line;
  if constexpr (D == 3) {
    lead[0] = line / dims.n[1];
    lead[1] = line % dims.n[1];
  }
  // the base line of leading tap tl (row-major over the leading axes' taps)
  const auto base_line = [&](int tl) -> long long {
    if constexpr (D == 2) return wrap(lead[0] - (tl - lo_shift), dims.n[0]);
    if constexpr (D == 3)
      return static_cast<long long>(wrap(lead[0] - (tl / width - lo_shift), dims.n[0])) *
                 dims.n[1] +
             wrap(lead[1] - (tl % width - lo_shift), dims.n[1]);
    return 0;
  };

  double re[RT], im[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) re[r] = im[r] = 0.0;

  const int nlead = D == 1 ? 1 : (D == 2 ? width : width * width);
#pragma unroll 1
  for (int first = 0; first < nlead; first += kStageRows) {
    const int rows = nlead - first < kStageRows ? nlead - first : kStageRows;
    // stage the CSR offsets of the base cells this block's windows reach on
    // `rows` leading taps; skip the walk where none of them holds a point
    __syncthreads();  // the previous stage's offsets are read
    int any = 0;
    for (int i = threadIdx.x; i < rows * span; i += kThreads) {
      const int row = i / span, p = i % span;
      const long long b = base_line(first + row) * nl + wrap(base_start + p, nl);
      const int lo = csr_off[b], hi = csr_off[b + 1];
      s_lo[row][p] = lo;
      s_hi[row][p] = hi;
      any |= hi > lo;
    }
    if (!__syncthreads_or(any) || !valid) continue;
    // the stage's (row, tap) items in row-major order, item i to lane i % kLanes
#pragma unroll 1
    for (int i = lane; i < rows * width; i += kLanes) {
      const int row = i / width, t = i % width;
      const int tl = first + row;
      const int t0 = D == 3 ? tl / width : tl;
      const int t1 = D == 3 ? tl % width : 0;
      const int p = cell + width - 1 - t;
      walk<R, D, RT>(fac, vv, s_lo[row][p], s_hi[row][p], stride, t0, width + t1,
                     (D - 1) * width + t, npts, nr, re, im);
    }
  }
  // the cell's lanes summed by a butterfly: every lane ends with the same
  // bits (each step adds two equal pairs of operands, in either order)
#pragma unroll
  for (int m = kLanes / 2; m > 0; m /= 2) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      re[r] += __shfl_xor_sync(0xffffffffu, re[r], m);
      im[r] += __shfl_xor_sync(0xffffffffu, im[r], m);
    }
  }
  if (!valid || lane != 0) return;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r < nr) {
      V2 o;
      o.x = static_cast<R>(re[r]);
      o.y = static_cast<R>(im[r]);
      ov[r * ncells] = o;
    }
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
constexpr long long kMaxGridX = 0x7fffffffLL;
// the dynamic shared memory a block may take without opting in
constexpr int kDefaultSmem = 48 * 1024;

bool valid_geometry(int d, const Dims& dims, int width) {
  if (d < 1 || d > 3 || width < 1 || width > kMaxWidth) return false;
  for (int a = 0; a < 3; ++a)
    if (dims.n[a] < 1 || (a >= d && dims.n[a] != 1)) return false;
  return static_cast<long long>(dims.n[0]) * dims.n[1] * dims.n[2] < 0x7fffffffLL;
}

template <typename R>
int launch_factors(const void* xs, const void* csr_pts, void* fac, int npts, int d, int width,
                   double beta, int dev, void* stream) {
  if (d < 1 || d > 3 || width < 1 || width > kMaxWidth) return kInvalid;
  const long long nfac = static_cast<long long>(npts) * d * width;
  if (nfac == 0) return 0;
  const long long blocks = (nfac + kThreads - 1) / kThreads;
  if (blocks > kMaxGridX) return kInvalid;
  const R b = static_cast<R>(beta), half = static_cast<R>(width / 2.0);
  const int err = on_device(dev, [&]() {
    nufft_factors<R><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const R*>(xs), static_cast<const int*>(csr_pts), static_cast<R*>(fac), nfac,
        d, width, b, half);
    return cudaGetLastError();
  });
  return err != 0 ? -err : 1;
}

template <typename R>
int launch_gather(const void* v, const void* csr_pts, void* vg, int npts, int nrows, int dev,
                  void* stream) {
  const long long n = static_cast<long long>(npts) * nrows;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxGridX) return kInvalid;
  const int err = on_device(dev, [&]() {
    nufft_gather<R><<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const R*>(v), static_cast<const int*>(csr_pts), static_cast<R*>(vg), npts, n);
    return cudaGetLastError();
  });
  return err != 0 ? -err : 1;
}

template <typename R>
int launch_interp(const void* g, const void* fac, const void* csr_first, const void* csr_pts,
                  void* out, int npts, int d, Dims dims, int width, int nrows, int dev,
                  void* stream) {
  if (!valid_geometry(d, dims, width)) return kInvalid;
  if (npts == 0 || nrows == 0) return 0;
  const long long ncells = static_cast<long long>(dims.n[0]) * dims.n[1] * dims.n[2];
  // the staged factors: at most 256 x 49 doubles (3-D, W 16), 100,352 bytes
  const int smem = kThreads * (d * width + 1) * static_cast<int>(sizeof(R));
  int launched = 0;
  const int err = on_device(dev, [&]() {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const R* fp = static_cast<const R*>(fac);
    const int* firstp = static_cast<const int*>(csr_first);
    const int* ptsp = static_cast<const int*>(csr_pts);
    const auto run = [&](auto kernel) -> cudaError_t {
      if (smem > kDefaultSmem) {
        const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
      }
      // a block row a row, in launches of at most kMaxGridY rows
      for (int r0 = 0; r0 < nrows; r0 += kMaxGridY) {
        const dim3 grid((npts + kThreads - 1) / kThreads,
                        nrows - r0 < kMaxGridY ? nrows - r0 : kMaxGridY);
        kernel<<<grid, kThreads, smem, st>>>(
            static_cast<const R*>(g) + 2 * r0 * ncells, fp, firstp, ptsp,
            static_cast<R*>(out) + 2LL * r0 * npts, npts, dims, width);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        ++launched;
      }
      return cudaSuccess;
    };
    const bool narrow = width <= 8;
    if (d == 1) return narrow ? run(nufft_interp<R, 1, 8>) : run(nufft_interp<R, 1, kMaxWidth>);
    if (d == 2) return narrow ? run(nufft_interp<R, 2, 8>) : run(nufft_interp<R, 2, kMaxWidth>);
    return narrow ? run(nufft_interp<R, 3, 8>) : run(nufft_interp<R, 3, kMaxWidth>);
  });
  return err != 0 ? -err : launched;
}

template <typename R>
int launch_spread(const void* vg, const void* fac, const void* csr_off, const void* sum_blocks,
                  int nsum, const void* fill, int nfill, void* out, int npts, int d, Dims dims,
                  int width, int nrows, int dev, void* stream) {
  if (!valid_geometry(d, dims, width) || nsum < 0 || nfill < 0) return kInvalid;
  if (nrows == 0) return 0;
  const long long blocks = static_cast<long long>(nsum) + nfill;
  const int rt = nrows == 1 || blocks * nrows <= kOneRowBlocks ? 1 : kRowTile;
  const int tiles = (nrows + rt - 1) / rt;
  if (tiles > kMaxGridY || blocks > kMaxGridX) return kInvalid;
  if (blocks == 0) return 0;
  const dim3 grid(static_cast<unsigned>(blocks), tiles);
  const int err = on_device(dev, [&]() {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const R* vp = static_cast<const R*>(vg);
    const R* fp = static_cast<const R*>(fac);
    const int* offp = static_cast<const int*>(csr_off);
    const int* sump = static_cast<const int*>(sum_blocks);
    const int2* fillp = static_cast<const int2*>(fill);
    R* op = static_cast<R*>(out);
    const auto run = [&](auto kernel) {
      kernel<<<grid, kThreads, 0, st>>>(vp, fp, offp, sump, fillp, op, npts, dims, width, nrows,
                                        nsum, nfill);
    };
    if (d == 1) rt == 1 ? run(nufft_spread<R, 1, 1>) : run(nufft_spread<R, 1, kRowTile>);
    if (d == 2) rt == 1 ? run(nufft_spread<R, 2, 1>) : run(nufft_spread<R, 2, kRowTile>);
    if (d == 3) rt == 1 ? run(nufft_spread<R, 3, 1>) : run(nufft_spread<R, 3, kRowTile>);
    return cudaGetLastError();
  });
  return err != 0 ? -err : 1;
}

}  // namespace

extern "C" {

#define NUFFT_FACTORS_ENTRY(name, R)                                                        \
  int name(const void* xs, const void* csr_pts, void* fac, int npts, int d, int width,     \
           double beta, int dev, void* stream) {                                           \
    return launch_factors<R>(xs, csr_pts, fac, npts, d, width, beta, dev, stream);         \
  }

NUFFT_FACTORS_ENTRY(nufft_factors_f32, float)
NUFFT_FACTORS_ENTRY(nufft_factors_f64, double)

#define NUFFT_GATHER_ENTRY(name, R)                                                         \
  int name(const void* v, const void* csr_pts, void* vg, int npts, int nrows, int dev,      \
           void* stream) {                                                                 \
    return launch_gather<R>(v, csr_pts, vg, npts, nrows, dev, stream);                     \
  }

NUFFT_GATHER_ENTRY(nufft_gather_f32, float)
NUFFT_GATHER_ENTRY(nufft_gather_f64, double)

#define NUFFT_INTERP_ENTRY(name, R)                                                          \
  int name(const void* g, const void* fac, const void* csr_first, const void* csr_pts,      \
           void* out, int npts, int d, int n0, int n1, int n2, int width, int nrows, int dev, \
           void* stream) {                                                                   \
    return launch_interp<R>(g, fac, csr_first, csr_pts, out, npts, d, Dims{{n0, n1, n2}},    \
                            width, nrows, dev, stream);                                      \
  }

NUFFT_INTERP_ENTRY(nufft_interp_f32, float)
NUFFT_INTERP_ENTRY(nufft_interp_f64, double)

#define NUFFT_SPREAD_ENTRY(name, R)                                                          \
  int name(const void* vg, const void* fac, const void* csr_off, const void* sum_blocks,    \
           int nsum, const void* fill, int nfill, void* out, int npts, int d, int n0, int n1, \
           int n2, int width, int nrows, int dev, void* stream) {                            \
    return launch_spread<R>(vg, fac, csr_off, sum_blocks, nsum, fill, nfill, out, npts, d,   \
                            Dims{{n0, n1, n2}}, width, nrows, dev, stream);                  \
  }

NUFFT_SPREAD_ENTRY(nufft_spread_f32, float)
NUFFT_SPREAD_ENTRY(nufft_spread_f64, double)

// The rows a block serves, the widest window, the cells a spread block
// takes and the most cells of a fill chunk; the host checks them against
// its own.
int nufft_window_row_tile() { return kRowTile; }
int nufft_window_max_width() { return kMaxWidth; }
int nufft_window_spread_cells() { return kSpreadCells; }
int nufft_window_fill_cells() { return kFillCells; }

}  // extern "C"

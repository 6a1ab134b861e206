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
// the first axis's factor first.  The weights are recomputed from the
// positions wherever they are used, so the tables are O(points + cells):
// the positions (npts, d), and for the spread a CSR over the cells, the
// points sorted by the flat index of their base cell (i0 mod n), stable,
// with each cell's offsets.  The host builds them (ops/nufft_window.py).
//
// Replaces the window gather of nifty_tpu/ops/nufft.py:204-247
// (interp_point vmapped over the points, and its sorted-gather variant
// :181-202) and the scatter-add that autodiff makes of it for nufft1
// (:251-265): XLA ops in the JAX package, not Pallas kernels.
//
// What bounds it.  The interp reads, for each point, its position and the
// W^d values of its window (neighbouring points share most of them, and the
// points come sorted by cell, so L1 and L2 serve them), and writes its
// value: at a w-plane of the radio response (about 125 k points on a 2048^2
// grid, float64) the grid once (67 MB), the positions and the output,
// 0.021 ms at 3.35 TB/s.  The spread writes every cell of the grid once and
// reads the positions and values of the points and the CSR offsets (17 MB):
// the same order.  Neither has atomics.
//
// nufft_interp: one thread a point, a tile of 1 or kRowTile rows a block
// (blockIdx.y), so the weights are computed once for the tile's rows.  The
// innermost axis's W weights sit in registers; a leading axis's weight is
// computed when its loop index moves.  The taps are summed in row-major tap
// order (the innermost axis fastest), each row on its own accumulators.
// Both kernels compute the weights in the grid's real type, as the JAX
// package does, and sum in double for either type: a float32 spread takes
// hundreds of terms a cell along a baseline's track.
//
// nufft_spread: keyed on the output.  A block takes a segment of
// kSpreadCells (32) consecutive cells along the innermost axis of one line
// of the grid, a group of kLanes (8) threads a cell.  It stages in shared
// memory the CSR offsets of the kSpreadCells + W - 1 base cells that its
// cells' windows reach along the innermost axis (wrapped), for up to
// kStageRows taps of the leading axes at once (all W of them in 2-D), and
// skips the walk where none holds a point.  A block that no point's window
// reaches at all (most of a radio grid lies outside the uv coverage) reads
// one byte of the host's table of such blocks and writes its zeros.  A
// cell's work is its (leading tap, innermost tap) items, each a base cell
// whose points it walks in CSR order; item i of a stage goes to lane
// i % kLanes, so the dense centre of a uv coverage (hundreds of points a
// base cell) spreads over eight threads a cell.  The lanes' sums meet in a
// butterfly.  Each output element's terms come in one fixed order from +0,
// whatever the card, the grid or the rows a block serves: bitwise
// reproducible.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 4;
constexpr int kMaxWidth = 16;
constexpr int kMaxGridY = 65535;
// the leading taps whose CSR offsets a spread block stages at once
constexpr int kStageRows = 16;
// a spread block's cells along the innermost axis, and the lanes a cell
constexpr int kLanes = 8;
constexpr int kSpreadCells = kThreads / kLanes;

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

template <typename R, int D, int RT>
__global__ void __launch_bounds__(kThreads)
    nufft_interp(const R* __restrict__ g, const R* __restrict__ xs, R* __restrict__ out,
                 int npts, Dims dims, int width, R beta, R half, int nrows) {
  using V2 = typename Vec2<R>::type;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= npts) return;
  const int r0 = blockIdx.y * RT;
  const int nr = nrows - r0 < RT ? nrows - r0 : RT;
  const long long ncells = static_cast<long long>(dims.n[0]) * dims.n[1] * dims.n[2];
  const V2* gv = reinterpret_cast<const V2*>(g) + r0 * ncells;
  const int lo_shift = width / 2 - 1;

  R pos[D];
  int lo[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    pos[a] = xs[static_cast<long long>(j) * D + a];
    lo[a] = static_cast<int>(k_floor(pos[a])) - lo_shift;  // i0 + off_0
  }
  const int nl = dims.n[D - 1];
  R wl[kMaxWidth];
#pragma unroll
  for (int t = 0; t < kMaxWidth; ++t)
    wl[t] = t < width ? es_weight(pos[D - 1], lo[D - 1] + t, beta, half) : R(0);
  const int cl0 = wrap(lo[D - 1], nl);

  double re[RT], im[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) re[r] = im[r] = 0.0;

  // the innermost axis's taps from the line that starts at `line`, times w
  auto line_taps = [&](long long line, R w) {
    int c = cl0;
#pragma unroll
    for (int t = 0; t < kMaxWidth; ++t) {
      if (t < width) {
        R wt = wl[t];
        if constexpr (D > 1) wt = w * wl[t];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < nr) {
            const V2 val = gv[r * ncells + line + c];
            re[r] += static_cast<double>(wt) * static_cast<double>(val.x);
            im[r] += static_cast<double>(wt) * static_cast<double>(val.y);
          }
        }
        c = c + 1 == nl ? 0 : c + 1;
      }
    }
  };

  if constexpr (D == 1) {
    line_taps(0, R(1));
  } else if constexpr (D == 2) {
    int c0 = wrap(lo[0], dims.n[0]);
#pragma unroll 1
    for (int t0 = 0; t0 < width; ++t0) {
      line_taps(static_cast<long long>(c0) * nl, es_weight(pos[0], lo[0] + t0, beta, half));
      c0 = c0 + 1 == dims.n[0] ? 0 : c0 + 1;
    }
  } else {
    int c0 = wrap(lo[0], dims.n[0]);
#pragma unroll 1
    for (int t0 = 0; t0 < width; ++t0) {
      const R w0 = es_weight(pos[0], lo[0] + t0, beta, half);
      int c1 = wrap(lo[1], dims.n[1]);
#pragma unroll 1
      for (int t1 = 0; t1 < width; ++t1) {
        const R w01 = w0 * es_weight(pos[1], lo[1] + t1, beta, half);
        line_taps((static_cast<long long>(c0) * dims.n[1] + c1) * nl, w01);
        c1 = c1 + 1 == dims.n[1] ? 0 : c1 + 1;
      }
      c0 = c0 + 1 == dims.n[0] ? 0 : c0 + 1;
    }
  }

  V2* ov = reinterpret_cast<V2*>(out) + static_cast<long long>(r0) * npts + j;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r < nr) {
      V2 o;
      o.x = static_cast<R>(re[r]);
      o.y = static_cast<R>(im[r]);
      ov[static_cast<long long>(r) * npts] = o;
    }
  }
}

template <typename R, int D, int RT>
__global__ void __launch_bounds__(kThreads)
    nufft_spread(const R* __restrict__ v, const R* __restrict__ xs,
                 const int* __restrict__ csr_off, const int* __restrict__ csr_pts,
                 const unsigned char* __restrict__ active, R* __restrict__ out, int npts,
                 Dims dims, int width, R beta, R half, int nrows) {
  using V2 = typename Vec2<R>::type;
  constexpr int kSpan = kSpreadCells + kMaxWidth - 1;
  __shared__ int s_lo[kStageRows][kSpan];
  __shared__ int s_hi[kStageRows][kSpan];
  const int nl = dims.n[D - 1];
  const int segs = (nl + kSpreadCells - 1) / kSpreadCells;
  const int line = blockIdx.x / segs;  // the flat index of the leading coordinates
  const int s0 = (blockIdx.x % segs) * kSpreadCells;
  const int cell = threadIdx.x / kLanes;  // this thread's cell in the block
  const int lane = threadIdx.x % kLanes;  // its lane in the cell's group
  const int c = s0 + cell;
  const bool valid = c < nl;
  const int r0 = blockIdx.y * RT;
  const int nr = nrows - r0 < RT ? nrows - r0 : RT;
  const V2* vv = reinterpret_cast<const V2*>(v) + static_cast<long long>(r0) * npts;
  const long long ncells = static_cast<long long>(dims.n[0]) * dims.n[1] * dims.n[2];
  V2* ov = reinterpret_cast<V2*>(out) + r0 * ncells + static_cast<long long>(line) * nl + c;
  if (!active[blockIdx.x]) {  // no window reaches these cells: +0, as the sums give
    if (valid && lane == 0) {
      V2 zero;
      zero.x = zero.y = R(0);
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r < nr) ov[r * ncells] = zero;
    }
    return;
  }
  const int lo_shift = width / 2 - 1;  // off_t = t - lo_shift
  const int span = kSpreadCells + width - 1;
  const int base_start = s0 - width + width / 2;  // the base cell of c = s0, t = W - 1

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
      const int off = t - lo_shift;
      const int hi = s_hi[row][p];
      for (int k = s_lo[row][p]; k < hi; ++k) {
        const int j = csr_pts[k];
        const R* xj = xs + static_cast<long long>(j) * D;
        R w;
        if constexpr (D == 1) {
          const R x = xj[0];
          w = es_weight(x, static_cast<int>(k_floor(x)) + off, beta, half);
        } else if constexpr (D == 2) {
          const R x0 = xj[0], x1 = xj[1];
          w = es_weight(x0, static_cast<int>(k_floor(x0)) + t0 - lo_shift, beta, half) *
              es_weight(x1, static_cast<int>(k_floor(x1)) + off, beta, half);
        } else {
          const R x0 = xj[0], x1 = xj[1], x2 = xj[2];
          w = es_weight(x0, static_cast<int>(k_floor(x0)) + t0 - lo_shift, beta, half) *
              es_weight(x1, static_cast<int>(k_floor(x1)) + t1 - lo_shift, beta, half) *
              es_weight(x2, static_cast<int>(k_floor(x2)) + off, beta, half);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < nr) {
            const V2 val = vv[static_cast<long long>(r) * npts + j];
            re[r] += static_cast<double>(w) * static_cast<double>(val.x);
            im[r] += static_cast<double>(w) * static_cast<double>(val.y);
          }
        }
      }
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

bool valid_geometry(int d, const Dims& dims, int width) {
  if (d < 1 || d > 3 || width < 1 || width > kMaxWidth) return false;
  for (int a = 0; a < 3; ++a)
    if (dims.n[a] < 1 || (a >= d && dims.n[a] != 1)) return false;
  return static_cast<long long>(dims.n[0]) * dims.n[1] * dims.n[2] < 0x7fffffffLL;
}

template <typename R>
int launch_interp(const void* g, const void* xs, void* out, int npts, int d, Dims dims,
                  int width, double beta, int nrows, int dev, void* stream) {
  if (!valid_geometry(d, dims, width)) return kInvalid;
  if (npts == 0 || nrows == 0) return 0;
  const int rt = nrows == 1 ? 1 : kRowTile;
  const int tiles = (nrows + rt - 1) / rt;
  if (tiles > kMaxGridY) return kInvalid;
  const dim3 grid((npts + kThreads - 1) / kThreads, tiles);
  const R b = static_cast<R>(beta), half = static_cast<R>(width / 2.0);
  const int err = on_device(dev, [&]() {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const R* gp = static_cast<const R*>(g);
    const R* xp = static_cast<const R*>(xs);
    R* op = static_cast<R*>(out);
    const auto run = [&](auto kernel) {
      kernel<<<grid, kThreads, 0, st>>>(gp, xp, op, npts, dims, width, b, half, nrows);
    };
    if (d == 1) rt == 1 ? run(nufft_interp<R, 1, 1>) : run(nufft_interp<R, 1, kRowTile>);
    if (d == 2) rt == 1 ? run(nufft_interp<R, 2, 1>) : run(nufft_interp<R, 2, kRowTile>);
    if (d == 3) rt == 1 ? run(nufft_interp<R, 3, 1>) : run(nufft_interp<R, 3, kRowTile>);
    return cudaGetLastError();
  });
  return err != 0 ? -err : 1;
}

template <typename R>
int launch_spread(const void* v, const void* xs, const void* csr_off, const void* csr_pts,
                  const void* active, void* out, int npts, int d, Dims dims, int width,
                  double beta, int nrows, int dev, void* stream) {
  if (!valid_geometry(d, dims, width)) return kInvalid;
  if (nrows == 0) return 0;
  const int rt = nrows == 1 ? 1 : kRowTile;
  const int tiles = (nrows + rt - 1) / rt;
  const int nl = dims.n[d - 1];
  const long long lines = static_cast<long long>(dims.n[0]) * dims.n[1] * dims.n[2] / nl;
  const long long blocks = lines * ((nl + kSpreadCells - 1) / kSpreadCells);
  if (tiles > kMaxGridY || blocks > 0x7fffffffLL) return kInvalid;
  const dim3 grid(static_cast<unsigned>(blocks), tiles);
  const R b = static_cast<R>(beta), half = static_cast<R>(width / 2.0);
  const int err = on_device(dev, [&]() {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const R* vp = static_cast<const R*>(v);
    const R* xp = static_cast<const R*>(xs);
    const int* offp = static_cast<const int*>(csr_off);
    const int* ptsp = static_cast<const int*>(csr_pts);
    const unsigned char* actp = static_cast<const unsigned char*>(active);
    R* op = static_cast<R*>(out);
    const auto run = [&](auto kernel) {
      kernel<<<grid, kThreads, 0, st>>>(vp, xp, offp, ptsp, actp, op, npts, dims, width, b,
                                        half, nrows);
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

#define NUFFT_INTERP_ENTRY(name, R)                                                          \
  int name(const void* g, const void* xs, void* out, int npts, int d, int n0, int n1, int n2, \
           int width, double beta, int nrows, int dev, void* stream) {                       \
    return launch_interp<R>(g, xs, out, npts, d, Dims{{n0, n1, n2}}, width, beta, nrows,     \
                            dev, stream);                                                    \
  }

NUFFT_INTERP_ENTRY(nufft_interp_f32, float)
NUFFT_INTERP_ENTRY(nufft_interp_f64, double)

#define NUFFT_SPREAD_ENTRY(name, R)                                                           \
  int name(const void* v, const void* xs, const void* csr_off, const void* csr_pts,          \
           const void* active, void* out, int npts, int d, int n0, int n1, int n2, int width,  \
           double beta, int nrows, int dev, void* stream) {                                  \
    return launch_spread<R>(v, xs, csr_off, csr_pts, active, out, npts, d,                   \
                            Dims{{n0, n1, n2}}, width, beta, nrows, dev, stream);            \
  }

NUFFT_SPREAD_ENTRY(nufft_spread_f32, float)
NUFFT_SPREAD_ENTRY(nufft_spread_f64, double)

// The rows a block serves, the widest window and the cells a spread block
// takes; the host checks them against its own.
int nufft_window_row_tile() { return kRowTile; }
int nufft_window_max_width() { return kMaxWidth; }
int nufft_window_spread_cells() { return kSpreadCells; }

}  // extern "C"

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
// The transpose runs in two passes.  The site pass computes, for every
// site, its window slots' cotangents t[b, s W + w] = sum_f olf[m(s), f, w]
// cot[b, i(s, f)] (into scratch the wrapper allocates) and its excitations'
// cotangents, one thread a (site, slot or excitation), so that a warp
// reads a site's matrix rows contiguously; the gather pass sums, for every
// coarse entry, the slots that read it: a CSR inverse of each axis's table
// (inv_off[a], inv[a]: the positions s_a nw[a] + w_a that read coarse
// index c_a, in increasing order), built on the host, walked over the
// product of the entry's axes' lists in that fixed order, with no atomics.
// The order of additions depends on the chart alone, as in the
// distributor's segment sum.  A HEALPix window that names its centre
// twice (the missing corner neighbour) appears twice in the inverse and is
// added twice.  (A single pass, one thread a coarse entry looping over its
// slots and their children, read the matrices one 8-byte entry a 32-byte
// sector across a warp: on an NVIDIA H100 80GB HBM3 it took 3.05 ms at the
// last sphere x radius level, whose matrices are 940 MB, against 2.62 for
// the plain version; the two passes take 0.46.)
//
// Design: one thread per output entry.  Bound: device memory (a step
// reads the coarse field, the excitations and the matrices and writes the
// fine field: at most 2 W F + 2 F^2 operations per fine entry against 16
// to 24 bytes).  Compile-time axis counts 1 to 4 keep the per-axis indices
// in registers (charts of more axes, up to kMaxAxes, take a runtime-count
// instance), and indices within a row are 32-bit where the row allows, as
// 64-bit division costs tens of instructions.  Tuning (the coarse field's
// windows through shared memory, vectorised stores, several children a
// thread) is left for later.
//
// C entries (plain C interface for ctypes, stream-ordered, nothing
// allocated or synchronised):
//   icr_refine_{f32,f64}(coarse, xi, olf, ker, fine, geom, tables, nrows, dev, stream)
//   icr_refine_transpose_{f32,f64}(cot, olf, ker, scratch, cot_coarse, cot_xi, geom,
//                                  tables, nrows, dev, stream)
// geom (host, int64): ndim, then ns, nw, nf, nc and mstride, each ndim
// entries; tables (host array of device pointers): wtab[0..d), inv_off[0..d),
// inv[0..d) (int32); scratch: nrows x S x W values.  They return the number
// of kernels launched (1 and 2; 0 for an empty output) or the cudaError
// that stopped them, negated.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxAxes = 16;
constexpr int kThreads = 256;

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
  int W, F;                      // window slots and children a site
  long long S, n_coarse, n_fine;     // sites, coarse and fine entries (a row)
};

// ND > 0: the axis count at compile time; ND == 0: g.ndim at run time.
template <int ND>
__device__ __forceinline__ int axes(const Geometry& g) { return ND ? ND : g.ndim; }

// I: the type of indices within a row (uint32_t where every row size of
// the level fits in it).
template <typename T, int ND, typename I>
__global__ void __launch_bounds__(kThreads) refine_kernel(
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

// The site pass: for site s and j < W + F, one thread,
//   j < W:  t[b, s W + j]          = sum_f olf[m(s), f, j] cot[b, i(s, f)]
//   else:   cot_xi[b, s F + j - W] = sum_f ker[m(s), f, j - W] cot[b, i(s, f)]
template <typename T, int ND, typename I>
__global__ void __launch_bounds__(kThreads) transpose_sites_kernel(
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
// the slot cotangents t that read it, over the product of its axes'
// inverse lists in order.
template <typename T, int ND, typename I>
__global__ void __launch_bounds__(kThreads) transpose_gather_kernel(
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

// The geometry from the host's int64 array and pointer array; false for
// an axis count the kernels do not take.
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
    g->wtab[a] = static_cast<const int32_t*>(tables[a]);
    g->inv_off[a] = static_cast<const int32_t*>(tables[nd + a]);
    g->inv[a] = static_cast<const int32_t*>(tables[2 * nd + a]);
    g->W *= g->nw[a];
    g->F *= g->nf[a];
    g->S *= g->ns[a];
    g->n_coarse *= g->nc[a];
  }
  long long stride = 1;
  for (int a = nd - 1; a >= 0; --a) {
    g->fstride[a] = stride;
    stride *= static_cast<long long>(g->ns[a]) * g->nf[a];
  }
  g->n_fine = stride;
  return true;
}

// Whether every index within a row of the level (fine, coarse, site pass,
// scratch and matrix entries) fits in 32 bits.
bool narrow_rows(const Geometry& g) {
  const long long limit = 1ll << 31;  // with a block of headroom below 2^32
  long long mats = 0;
  for (int a = 0; a < g.ndim; ++a) mats += g.mstride[a] * (g.ns[a] - 1);
  return g.n_fine < limit && g.n_coarse < limit && g.S * (g.W + g.F) < limit &&
         (mats + 1) < limit;
}

dim3 grid_for(long long n, int nrows) {
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads), static_cast<unsigned>(nrows));
}

template <typename T, int ND, typename I>
void launch_refine(const T* coarse, const T* xi, const T* olf, const T* ker, T* fine,
                   const Geometry& g, int nrows, cudaStream_t stream) {
  refine_kernel<T, ND, I><<<grid_for(g.n_fine, nrows), kThreads, 0, stream>>>(
      coarse, xi, olf, ker, fine, g);
}

template <typename T, int ND, typename I>
void launch_transpose(const T* cot, const T* olf, const T* ker, T* scratch, T* cot_coarse,
                      T* cot_xi, const Geometry& g, int nrows, cudaStream_t stream) {
  transpose_sites_kernel<T, ND, I><<<grid_for(g.S * (g.W + g.F), nrows), kThreads, 0, stream>>>(
      cot, olf, ker, scratch, cot_xi, g);
  transpose_gather_kernel<T, ND, I><<<grid_for(g.n_coarse, nrows), kThreads, 0, stream>>>(
      scratch, cot_coarse, g);
}

// `launch` instantiated for the level's axis count and index width.
template <template <int, typename> class Launch, typename... Args>
void dispatch(const Geometry& g, Args... args) {
  const bool narrow = narrow_rows(g);
#define ICR_CASE(ND)                                      \
  if (narrow) {                                           \
    Launch<ND, uint32_t>::run(g, args...);                \
  } else {                                                \
    Launch<ND, unsigned long long>::run(g, args...);      \
  }
  switch (g.ndim) {
    case 1: ICR_CASE(1) break;
    case 2: ICR_CASE(2) break;
    case 3: ICR_CASE(3) break;
    case 4: ICR_CASE(4) break;
    default: ICR_CASE(0)
  }
#undef ICR_CASE
}

template <typename T>
struct RefineLaunch {
  template <int ND, typename I>
  struct L {
    static void run(const Geometry& g, const T* coarse, const T* xi, const T* olf, const T* ker,
                    T* fine, int nrows, cudaStream_t s) {
      launch_refine<T, ND, I>(coarse, xi, olf, ker, fine, g, nrows, s);
    }
  };
};

template <typename T>
struct TransposeLaunch {
  template <int ND, typename I>
  struct L {
    static void run(const Geometry& g, const T* cot, const T* olf, const T* ker, T* scratch,
                    T* cot_coarse, T* cot_xi, int nrows, cudaStream_t s) {
      launch_transpose<T, ND, I>(cot, olf, ker, scratch, cot_coarse, cot_xi, g, nrows, s);
    }
  };
};

// Run `launch` with `dev`, the device that holds the tensors, current;
// returns the launch's error.
template <typename F>
cudaError_t on_device(int dev, F launch) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  if (cur != dev && (err = cudaSetDevice(dev)) != cudaSuccess) return err;
  launch();
  err = cudaGetLastError();
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
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(dev, [&] {
    dispatch<RefineLaunch<T>::template L>(g, coarse, xi, olf, ker, fine, nrows, s);
  });
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

template <typename T>
int transpose(const T* cot, const T* olf, const T* ker, T* scratch, T* cot_coarse, T* cot_xi,
              const long long* geom, const void* const* tables, int nrows, int dev,
              void* stream) {
  Geometry g;
  if (!make_geometry(geom, tables, &g)) return -static_cast<int>(cudaErrorInvalidValue);
  if (nrows <= 0 || g.n_fine == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(dev, [&] {
    dispatch<TransposeLaunch<T>::template L>(g, cot, olf, ker, scratch, cot_coarse, cot_xi,
                                             nrows, s);
  });
  return err == cudaSuccess ? 2 : -static_cast<int>(err);
}

}  // namespace

extern "C" {

int icr_refine_max_axes() { return kMaxAxes; }

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

}  // extern "C"

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
// What bounds it: bytes.  At the 256^3 tomography (1024 rays x 256 points x
// 8 corners, float64) the forward reads the 8.4 MB index table, the 16.8 MB
// weights and at most 16.8 MB of field values (42 MB, 0.013 ms at 3.35
// TB/s); the adjoint writes the 134 MB grid once (0.05 ms).
//
// los_forward: a group of G = 32 W lanes a ray (W warps, 1, 2, 4 or 8, from
// E alone: E / 256 rounded up to a power of two), a block of 256 threads
// holding 8 / W rays, and a tile of up to kRowTile rows a block (blockIdx.y),
// so each entry's index and weight are loaded once for the tile's rows.
// Lane t of a group adds entries t, t + G, ... in order, then a butterfly in
// each warp and, for W > 1, the warps' sums in warp order: a fixed order that
// depends on E alone, so the result repeats bit for bit at any number of
// rows.  At 256^3 (E = 2048) a block takes one ray and the grid has 1024
// blocks, enough resident warps to hide the scattered field reads.
//
// los_adjoint: no atomics.  The host sorts the valid entries by cell
// (stable, so in (ray, entry) order within a cell): a CSR over the touched
// cells (seg_off, seg_ray, seg_w).  One thread a grid cell writes that cell
// exactly once: a touched cell the sum over its segment in order, any other
// cell zero.  Which cells are touched is a bit mask of one 32-bit word for 32
// cells, and a touched cell's segment is found by rank[word] (the touched
// cells in the words before) plus the population count of the bits below
// it: N / 4 bytes in all (4.2 MB at 256^3) where offsets for every cell would
// take 67 MB.  A warp covers one mask word and writes 32 consecutive cells.
//
// The C entry points return the number of kernels launched (1; 0 for an
// empty call), or the cudaError_t that stopped them (cudaGetLastError()
// after the launch) negated.  Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 4;  // rows a block serves; gridDim.y covers the rest

// Warps a ray's group holds: E / 256 rounded up to a power of two, at most 8.
int warps_per_ray(int nent) {
  int w = 1;
  while (w < kWarps && w * kThreads < nent) w <<= 1;
  return w;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    los_forward(const T* __restrict__ f, const int* __restrict__ idx, const T* __restrict__ w,
                const T* __restrict__ s, T* __restrict__ y, int nrays, int nent,
                long long ncells, int nrows, int wpr) {
  __shared__ T partial[kWarps][kRowTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = 32 * wpr;
  const int ray = blockIdx.x * (kWarps / wpr) + warp / wpr;
  const int t = (warp % wpr) * 32 + lane;
  const int b0 = blockIdx.y * kRowTile;
  const int nb = min(kRowTile, nrows - b0);
  T acc[kRowTile];
#pragma unroll
  for (int k = 0; k < kRowTile; ++k) acc[k] = T(0);
  if (ray < nrays) {
    const int* ir = idx + static_cast<long long>(ray) * nent;
    const T* wr = w + static_cast<long long>(ray) * nent;
    const T* fb = f + static_cast<long long>(b0) * ncells;
    for (int e = t; e < nent; e += group) {
      const int i = __ldg(ir + e);
      if (i < 0) continue;
      const T we = __ldg(wr + e);
#pragma unroll
      for (int k = 0; k < kRowTile; ++k)
        if (k < nb) acc[k] += we * __ldg(fb + k * ncells + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kRowTile; ++k) acc[k] = warp_sum(acc[k]);
  if (wpr == 1) {
    if (ray < nrays && lane == 0) {
      const T sr = __ldg(s + ray);
      for (int k = 0; k < nb; ++k) y[static_cast<long long>(b0 + k) * nrays + ray] = acc[k] * sr;
    }
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kRowTile; ++k) partial[warp][k] = acc[k];
  }
  __syncthreads();
  if (ray < nrays && lane == 0 && warp % wpr == 0) {
    const T sr = __ldg(s + ray);
    for (int k = 0; k < nb; ++k) {
      T v = partial[warp][k];
      for (int j = 1; j < wpr; ++j) v += partial[warp + j][k];
      y[static_cast<long long>(b0 + k) * nrays + ray] = v * sr;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    los_adjoint(const T* __restrict__ ybar, const uint32_t* __restrict__ mask,
                const int* __restrict__ rank, const int* __restrict__ seg_off,
                const int* __restrict__ seg_ray, const T* __restrict__ seg_w,
                const T* __restrict__ s, T* __restrict__ g, long long ncells, int nrays,
                int nrows) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= ncells) return;
  const int b0 = blockIdx.y * kRowTile;
  const int nb = min(kRowTile, nrows - b0);
  T acc[kRowTile];
#pragma unroll
  for (int k = 0; k < kRowTile; ++k) acc[k] = T(0);
  const uint32_t word = __ldg(mask + (n >> 5));
  const uint32_t bit = 1u << (n & 31);
  if (word & bit) {
    const int u = __ldg(rank + (n >> 5)) + __popc(word & (bit - 1u));
    const int hi = __ldg(seg_off + u + 1);
    const T* yb = ybar + static_cast<long long>(b0) * nrays;
    for (int j = __ldg(seg_off + u); j < hi; ++j) {
      const int r = __ldg(seg_ray + j);
      const T we = __ldg(seg_w + j);
      const T sr = __ldg(s + r);
#pragma unroll
      for (int k = 0; k < kRowTile; ++k)
        if (k < nb) acc[k] += we * (sr * __ldg(yb + k * nrays + r));
    }
  }
  for (int k = 0; k < nb; ++k) g[static_cast<long long>(b0 + k) * ncells + n] = acc[k];
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

int row_tiles(int nrows) { return (nrows + kRowTile - 1) / kRowTile; }

template <typename T>
int launch_forward(const void* f, const void* idx, const void* w, const void* s, void* y,
                   int nrays, int nent, long long ncells, int nrows, int dev, void* stream) {
  if (nrays == 0 || nrows == 0) return 0;
  const int wpr = warps_per_ray(nent);
  const int rays_per_block = kWarps / wpr;
  const dim3 grid((nrays + rays_per_block - 1) / rays_per_block, row_tiles(nrows));
  const int err = on_device(dev, [&]() {
    los_forward<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(f), static_cast<const int*>(idx), static_cast<const T*>(w),
        static_cast<const T*>(s), static_cast<T*>(y), nrays, nent, ncells, nrows, wpr);
    return cudaGetLastError();
  });
  return err != 0 ? -err : 1;
}

template <typename T>
int launch_adjoint(const void* ybar, const void* mask, const void* rank, const void* seg_off,
                   const void* seg_ray, const void* seg_w, const void* s, void* g,
                   long long ncells, int nrays, int nrows, int dev, void* stream) {
  if (ncells == 0 || nrows == 0) return 0;
  const dim3 grid(static_cast<unsigned>((ncells + kThreads - 1) / kThreads), row_tiles(nrows));
  const int err = on_device(dev, [&]() {
    los_adjoint<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(ybar), static_cast<const uint32_t*>(mask),
        static_cast<const int*>(rank), static_cast<const int*>(seg_off),
        static_cast<const int*>(seg_ray), static_cast<const T*>(seg_w),
        static_cast<const T*>(s), static_cast<T*>(g), ncells, nrays, nrows);
    return cudaGetLastError();
  });
  return err != 0 ? -err : 1;
}

}  // namespace

extern "C" {

#define LOS_FORWARD_ENTRY(name, T)                                                          \
  int name(const void* f, const void* idx, const void* w, const void* s, void* y,         \
           int nrays, int nent, long long ncells, int nrows, int dev, void* stream) {     \
    return launch_forward<T>(f, idx, w, s, y, nrays, nent, ncells, nrows, dev, stream);   \
  }

LOS_FORWARD_ENTRY(los_forward_f32, float)
LOS_FORWARD_ENTRY(los_forward_f64, double)

#define LOS_ADJOINT_ENTRY(name, T)                                                          \
  int name(const void* ybar, const void* mask, const void* rank, const void* seg_off,     \
           const void* seg_ray, const void* seg_w, const void* s, void* g,                \
           long long ncells, int nrays, int nrows, int dev, void* stream) {               \
    return launch_adjoint<T>(ybar, mask, rank, seg_off, seg_ray, seg_w, s, g, ncells,     \
                             nrays, nrows, dev, stream);                                  \
  }

LOS_ADJOINT_ENTRY(los_adjoint_f32, float)
LOS_ADJOINT_ENTRY(los_adjoint_f64, double)

// The rows a block serves; the host checks it against its own constant.
int los_interp_row_tile() { return kRowTile; }

}  // extern "C"

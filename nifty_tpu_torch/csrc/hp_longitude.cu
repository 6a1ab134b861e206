// The longitude stage of the spherical harmonic synthesis on HEALPix rings
// (K10) and its adjoint, for Hopper (sm_90a).
//
//   out[b, p]  = sum_m (F[b, 0, m, r(p)] cos m phi_p - F[b, 1, m, r(p)] sin m phi_p)
//   G[b, 0, m, r] =  sum_{p in ring r} ct[b, p] cos m phi_p
//   G[b, 1, m, r] = -sum_{p in ring r} ct[b, p] sin m phi_p
//
// for rows b, m < nm and the pixels p of ring r, which are contiguous in
// the RING scheme: p = start[r] + j, j < start[r + 1] - start[r], with
// phi_p = phi0[r] + j dphi[r] (each rounded on its own, as the host's
// plain version computes it).  F and G are (B, 2, nm, nrings); the maps
// (B, npix).
//
// Replaces the primitives _hp_fwd_p / _hp_adj_p of the JAX package
// (nifty_tpu/ops/healpix_sht.py:47-193), which XLA runs as an m-chunked
// scan of matrix products against stored phase tables cos / sin of shape
// (npix, nm): 6.4 GB in float64 at nside 256, lmax 511, read in full at
// every application.  Here the phases are made on the fly, so a row reads
// the 8.4 MB coefficient planes and writes the 6.3 MB map (or the
// reverse): 0.0044 ms at 3.35 TB/s.  The direct sum needs two multiply-adds
// a (pixel, m): 1.6 GFLOP a row at nside 256, 0.024 ms at the card's
// 67 TFLOP/s float64 peak (tensor cores; 0.047 ms at the 34 TFLOP/s vector
// rate).  So summed directly the stage is bound by operations; a ring FFT
// would be bound by the bytes.  This design sums directly in vector
// arithmetic and adds four products and two additions a (pixel, m) to make
// the phases, as few as it can:
//
// - synthesis: one block a ring and row; the ring's coefficient column
//   (2 nm values) is staged in shared memory, and a thread a pixel walks
//   m upwards, advancing e^{i m phi} by one complex rotation a step and
//   reseeding it with sincos(m phi) every kReseed steps, which holds the
//   phase error near kReseed ulp;
// - adjoint: one block a ring and row; the ring's cotangents are staged in
//   shared memory a chunk at a time, and a thread an m walks the pixels in
//   order, advancing e^{i m phi_j} along j by the rotation e^{i m dphi}
//   and reseeding every kReseed pixels.  Every output is one thread's sum
//   in a fixed order: no atomics, and the bits repeat.
//
// Arithmetic is in double for both value types; float inputs are read and
// outputs written as float.  Both entries return the number of kernels
// launched (1), or the cudaError negated.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kReseed = 32;
constexpr int kChunk = 1024;  // cotangents an adjoint block stages at a time
constexpr int kStaticSmem = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads) synth_kernel(
    const T* __restrict__ F, T* __restrict__ out, const int64_t* __restrict__ start,
    const double* __restrict__ phi0, const double* __restrict__ dphi, int nrings, int nm,
    long long npix) {
  extern __shared__ double col[];  // re[0, nm), im[nm, 2 nm)
  const int r = blockIdx.x;
  const long long b = blockIdx.y;
  const T* __restrict__ fb = F + b * 2ll * nm * nrings + r;
  for (int m = threadIdx.x; m < nm; m += blockDim.x) {
    col[m] = static_cast<double>(fb[static_cast<long long>(m) * nrings]);
    col[nm + m] = static_cast<double>(fb[static_cast<long long>(nm + m) * nrings]);
  }
  __syncthreads();
  const long long p0 = start[r], p1 = start[r + 1];
  const double f0 = phi0[r], df = dphi[r];
  T* __restrict__ ob = out + b * npix;
  for (long long p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const double phi = __dadd_rn(f0, __dmul_rn(static_cast<double>(p - p0), df));
    double s1, c1;
    sincos(phi, &s1, &c1);
    double acc = 0.0;
    for (int m0 = 0; m0 < nm; m0 += kReseed) {
      double c = 1.0, s = 0.0;
      if (m0 > 0) sincos(__dmul_rn(static_cast<double>(m0), phi), &s, &c);
      const int m1 = min(m0 + kReseed, nm);
      for (int m = m0; m < m1; ++m) {
        acc = fma(col[m], c, acc);
        acc = fma(-col[nm + m], s, acc);
        const double cn = c * c1 - s * s1;
        s = s * c1 + c * s1;
        c = cn;
      }
    }
    ob[p] = static_cast<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adjoint_kernel(
    const T* __restrict__ ct, T* __restrict__ G, const int64_t* __restrict__ start,
    const double* __restrict__ phi0, const double* __restrict__ dphi, int nrings, int nm,
    long long npix) {
  __shared__ double vals[kChunk];
  const int r = blockIdx.x;
  const long long b = blockIdx.y;
  const long long p0 = start[r];
  const int n = static_cast<int>(start[r + 1] - p0);
  const double f0 = phi0[r], df = dphi[r];
  const T* __restrict__ cb = ct + b * npix + p0;
  T* __restrict__ gb = G + b * 2ll * nm * nrings + r;
  for (int mbase = 0; mbase < nm; mbase += blockDim.x) {
    const int m = mbase + threadIdx.x;
    const double mf = static_cast<double>(m);
    double sd, cd;
    sincos(__dmul_rn(mf, df), &sd, &cd);
    double re = 0.0, im = 0.0;
    for (int q0 = 0; q0 < n; q0 += kChunk) {
      const int q1 = min(q0 + kChunk, n);
      __syncthreads();
      for (int j = q0 + threadIdx.x; j < q1; j += blockDim.x) {
        vals[j - q0] = static_cast<double>(cb[j]);
      }
      __syncthreads();
      if (m >= nm) continue;
      for (int j0 = q0; j0 < q1; j0 += kReseed) {
        const double phi = __dadd_rn(f0, __dmul_rn(static_cast<double>(j0), df));
        double s, c;
        sincos(__dmul_rn(mf, phi), &s, &c);
        const int j1 = min(j0 + kReseed, q1);
        for (int j = j0; j < j1; ++j) {
          const double v = vals[j - q0];
          re = fma(v, c, re);
          im = fma(-v, s, im);
          const double cn = c * cd - s * sd;
          s = s * cd + c * sd;
          c = cn;
        }
      }
    }
    if (m < nm) {
      gb[static_cast<long long>(m) * nrings] = static_cast<T>(re);
      gb[static_cast<long long>(nm + m) * nrings] = static_cast<T>(im);
    }
  }
}

// Run `launch` with `dev`, the device that holds the tensors, current;
// returns the launch's error.
template <typename F>
cudaError_t on_device(int dev, F launch) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  if (cur != dev && (err = cudaSetDevice(dev)) != cudaSuccess) return err;
  err = launch();
  if (err == cudaSuccess) err = cudaGetLastError();
  if (cur != dev) {
    const cudaError_t back = cudaSetDevice(cur);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

template <typename T>
int synth(const T* F, T* out, const int64_t* start, const double* phi0, const double* dphi,
          int nrings, int nm, long long npix, int nrows, int dev, void* stream) {
  if (nrows <= 0 || nrings <= 0 || nm <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * static_cast<size_t>(nm) * sizeof(double);
  const cudaError_t err = on_device(dev, [&]() -> cudaError_t {
    if (smem > kStaticSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          synth_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    synth_kernel<T><<<dim3(nrings, nrows), kThreads, smem, s>>>(F, out, start, phi0, dphi,
                                                                nrings, nm, npix);
    return cudaSuccess;
  });
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

template <typename T>
int adjoint(const T* ct, T* G, const int64_t* start, const double* phi0, const double* dphi,
            int nrings, int nm, long long npix, int nrows, int dev, void* stream) {
  if (nrows <= 0 || nrings <= 0 || nm <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(dev, [&]() -> cudaError_t {
    adjoint_kernel<T><<<dim3(nrings, nrows), kThreads, 0, s>>>(ct, G, start, phi0, dphi, nrings,
                                                                nm, npix);
    return cudaSuccess;
  });
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

}  // namespace

extern "C" {

int hp_longitude_reseed() { return kReseed; }

int hp_longitude_f32(const float* F, float* out, const int64_t* start, const double* phi0,
                     const double* dphi, int nrings, int nm, long long npix, int nrows, int dev,
                     void* stream) {
  return synth(F, out, start, phi0, dphi, nrings, nm, npix, nrows, dev, stream);
}

int hp_longitude_f64(const double* F, double* out, const int64_t* start, const double* phi0,
                     const double* dphi, int nrings, int nm, long long npix, int nrows, int dev,
                     void* stream) {
  return synth(F, out, start, phi0, dphi, nrings, nm, npix, nrows, dev, stream);
}

int hp_longitude_adjoint_f32(const float* ct, float* G, const int64_t* start,
                             const double* phi0, const double* dphi, int nrings, int nm,
                             long long npix, int nrows, int dev, void* stream) {
  return adjoint(ct, G, start, phi0, dphi, nrings, nm, npix, nrows, dev, stream);
}

int hp_longitude_adjoint_f64(const double* ct, double* G, const int64_t* start,
                             const double* phi0, const double* dphi, int nrings, int nm,
                             long long npix, int nrows, int dev, void* stream) {
  return adjoint(ct, G, start, phi0, dphi, nrings, nm, npix, nrows, dev, stream);
}

}  // extern "C"

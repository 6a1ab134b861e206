// The longitude stage of the spherical harmonic synthesis on HEALPix rings
// (K10) and its adjoint, for Hopper (sm_90a), as ring FFTs.
//
//   out[b, p]  = sum_m (F[b, 0, m, r(p)] cos m phi_p - F[b, 1, m, r(p)] sin m phi_p)
//   G[b, 0, m, r] =  sum_{p in ring r} ct[b, p] cos m phi_p
//   G[b, 1, m, r] = -sum_{p in ring r} ct[b, p] sin m phi_p
//
// for rows b, m < nm and the pixels p of ring r, which are contiguous in
// the RING scheme: p = start[r] + j, j < n = start[r + 1] - start[r], and
// evenly spaced, phi_p = phi0[r] + 2 pi j / n (the host checks both).  F and
// G are (B, 2, nm, nrings); the maps (B, npix).  So the stage is one
// length-n DFT a ring:
//
//   synthesis: H_k = sum_{m < nm, m = k mod n} (F_0m + i F_1m) e^{i m phi0},
//              out_j = Re sum_k H_k e^{2 pi i kj/n} = Re DFT(conj H)_j
//   adjoint:   X_k = sum_j ct_j e^{-2 pi i kj/n} = DFT(ct)_k,
//              G_0m + i G_1m = e^{-i m phi0} X_{m mod n}
//
// Replaces the primitives _hp_fwd_p / _hp_adj_p of the JAX package
// (nifty_tpu/ops/healpix_sht.py:47-193), which XLA runs as an m-chunked
// scan of matrix products against stored phase tables cos / sin of shape
// (npix, nm): 6.4 GB in float64 at nside 256, lmax 511, read in full at
// every application.
//
// What bounds it: a ring's DFT costs about 2.5 n log2 n operations (19
// MFLOP a row at nside 256, 0.3 us at the card's 67 TFLOP/s float64 peak),
// so the bytes do: a row reads the 8.4 MB coefficient planes and writes the
// 6.3 MB map (or the reverse), 0.0044 ms at 3.35 TB/s.  The design keeps
// everything between that read and that write in shared memory:
//
// - one thread block a ring and row; the ring's transform (L complex
//   doubles) lives in shared memory from its first read to its last write
//   where L <= 8192 (128 KB; MAX_SHARED_LEN on the host), and otherwise in
//   the ring's slice of a global workspace (HPRings.ws_at, ws_row): the
//   same passes run there, its barriers make the block's global writes
//   visible to the block as they do its shared ones, and L2 holds what the
//   wave of such blocks touches.  So a ring of any length runs: Bluestein's
//   L reaches 16384 for the polar rings of more than 4096 pixels from
//   nside 2048 on.  Each kernel runs its body on one memory or the other
//   from two call sites, so that each copy knows which it addresses;
// - synthesis: the block turns the ring's coefficients by e^{i m phi0}
//   (sincos of the rounded product m phi0, as the host's plain version
//   makes its phases) and folds them modulo n into n bins in a fixed order
//   (m = k, k + n, ... for bin k; up to kFoldSlab m turned at once into
//   shared memory, the bins held in natural order and then placed where
//   the transform takes them), transforms, and writes the real parts to the
//   ring's pixels, coalesced;
// - adjoint: a coalesced read of the ring's n cotangents, the transform,
//   then every m < nm reads bin m mod n and turns it by e^{-i m phi0};
// - a length n that is a power of two is transformed in place by radix-2^2
//   passes (two radix-2 stages a pass, one round trip through shared memory
//   and one barrier a pass), decimation in time from bit-reversed input;
// - any other length by Bluestein's chirp-z: a_j = x_j conj(w_j) padded to
//   L = 2^ceil(log2(2n - 1)), a decimation-in-frequency transform (natural
//   in, bit-reversed out), the pointwise product with the chirp filter's
//   transform (stored bit-reversed), a decimation-in-time transform back,
//   X_k = conj(w_k y_k), with w_t = e^{i pi t^2 / n}; the first transform's
//   last pass, the product and the second's first pass run as one step on
//   each thread's own entries;
// - a block's time is a chain of barriers (up to 12 for the 254 Bluestein
//   rings of L = 2048 at nside 256), so the blocks take the rings costliest
//   first (block_ring, from the host), and none trails the last wave; the
//   values and the chirps, read once a block, are loaded past L1 (__ldcg),
//   which keeps L1 for the roots of unity that every block reads;
// - the chirps, the filters' transforms and the roots of unity are host
//   tables built once in float64 (HPRings in ops/hp_longitude.py, where the
//   CPU tests check them and the same algorithm against numpy's FFT); the
//   section of the roots of length M, e^{-2 pi i j/M} for j < M/2, starts
//   at row M/2 - 1.
//
// Every output is written by one thread after a fixed order of operations:
// no atomics, and the bits repeat.  Arithmetic is in double for both value
// types; float inputs are read and outputs written as float.  Shared
// memory is the host's count (HPRings.smem_bytes): the largest L held in
// shared memory, plus the fold's slab for the synthesis of a ring of fewer
// than nm pixels; at most 16 (8192 + kFoldSlab) bytes.  Both entries
// return the number of kernels launched (1), or the cudaError negated.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStaticSmem = 48 * 1024;
// the m a synthesis block turns at once for its fold (HPRings' FOLD_SLAB)
constexpr int kFoldSlab = 2048;

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 cconj(double2 a) { return make_double2(a.x, -a.y); }
// a times -i
__device__ __forceinline__ double2 mul_minus_i(double2 a) { return make_double2(a.y, -a.x); }

__device__ __forceinline__ int bit_reversed(int k, int log_len) {
  return log_len == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - log_len));
}

// The passes of an in-place forward transform (e^{-2 pi i ...}) of length
// 2^log_len, radix-2 stages fused in pairs: decimation in frequency (natural
// order in, bit-reversed out) runs the stages of span 2h and h on the four
// entries base + {0, h, 2h, 3h} of each group of 4h, h = L/4, L/16, ...;
// decimation in time (bit-reversed in, natural out) the stages of span h and
// 2h, h upwards.  The innermost stages, whose twiddles are 1, run on
// contiguous entries in `inner`, which joins Bluestein's two transforms
// there: a thread owns the same entries before and after the filter, so no
// barrier or round trip through shared memory falls between them.
__device__ void dif_passes(double2* buf, int log_len, const double2* __restrict__ roots) {
  for (int lh = log_len - 2; lh >= 1; lh -= 2) {  // down to span 4 (log_len even) or 2
    const int h = 1 << lh;
    const double2* __restrict__ w4 = roots + (2 * h - 1);  // length 4h
    const double2* __restrict__ w2 = roots + (h - 1);      // length 2h
    for (int t = threadIdx.x; t < (1 << (log_len - 2)); t += blockDim.x) {
      const int j = t & (h - 1);
      const int base = ((t >> lh) << (lh + 2)) + j;
      const double2 a = __ldg(w4 + j), b = __ldg(w2 + j);
      const double2 x0 = buf[base], x1 = buf[base + h];
      const double2 x2 = buf[base + 2 * h], x3 = buf[base + 3 * h];
      // span 2h: (x0, x2) by a, (x1, x3) by -i a
      const double2 y0 = cadd(x0, x2), y2 = cmul(csub(x0, x2), a);
      const double2 y1 = cadd(x1, x3), y3 = cmul(mul_minus_i(csub(x1, x3)), a);
      // span h: (y0, y1) and (y2, y3) by b
      buf[base] = cadd(y0, y1);
      buf[base + h] = cmul(csub(y0, y1), b);
      buf[base + 2 * h] = cadd(y2, y3);
      buf[base + 3 * h] = cmul(csub(y2, y3), b);
    }
    __syncthreads();
  }
}

// The innermost stages (spans 1 and 2 on groups of 4 where log_len is even,
// span 1 on pairs where it is odd): with a `filter` (Bluestein), the
// decimation in frequency's last stages, x -> conj(x filter), then the
// decimation in time's first stages; without one, the latter alone.
__device__ void inner(double2* buf, int log_len, const double2* __restrict__ filter) {
  if (log_len & 1) {
    for (int t = threadIdx.x; t < (1 << (log_len - 1)); t += blockDim.x) {
      double2 x0 = buf[2 * t], x1 = buf[2 * t + 1];
      if (filter) {
        const double2 y0 = cadd(x0, x1), y1 = csub(x0, x1);
        x0 = cconj(cmul(y0, __ldcg(filter + 2 * t)));
        x1 = cconj(cmul(y1, __ldcg(filter + 2 * t + 1)));
      }
      buf[2 * t] = cadd(x0, x1);
      buf[2 * t + 1] = csub(x0, x1);
    }
  } else {
    for (int t = threadIdx.x; t < (1 << log_len) / 4; t += blockDim.x) {
      double2 x0 = buf[4 * t], x1 = buf[4 * t + 1], x2 = buf[4 * t + 2], x3 = buf[4 * t + 3];
      if (filter) {
        const double2 y0 = cadd(x0, x2), y2 = csub(x0, x2);
        const double2 y1 = cadd(x1, x3), y3 = mul_minus_i(csub(x1, x3));
        x0 = cconj(cmul(cadd(y0, y1), __ldcg(filter + 4 * t)));
        x1 = cconj(cmul(csub(y0, y1), __ldcg(filter + 4 * t + 1)));
        x2 = cconj(cmul(cadd(y2, y3), __ldcg(filter + 4 * t + 2)));
        x3 = cconj(cmul(csub(y2, y3), __ldcg(filter + 4 * t + 3)));
      }
      const double2 y0 = cadd(x0, x1), y1 = csub(x0, x1);
      const double2 y2 = cadd(x2, x3), y3 = mul_minus_i(csub(x2, x3));
      buf[4 * t] = cadd(y0, y2);
      buf[4 * t + 2] = csub(y0, y2);
      buf[4 * t + 1] = cadd(y1, y3);
      buf[4 * t + 3] = csub(y1, y3);
    }
  }
  __syncthreads();
}

__device__ void dit_passes(double2* buf, int log_len, const double2* __restrict__ roots) {
  for (int lh = 2 - (log_len & 1); lh + 2 <= log_len; lh += 2) {  // from span 4 (even) or 2
    const int h = 1 << lh;
    const double2* __restrict__ w4 = roots + (2 * h - 1);
    const double2* __restrict__ w2 = roots + (h - 1);
    for (int t = threadIdx.x; t < (1 << (log_len - 2)); t += blockDim.x) {
      const int j = t & (h - 1);
      const int base = ((t >> lh) << (lh + 2)) + j;
      const double2 a = __ldg(w4 + j), b = __ldg(w2 + j);
      const double2 x0 = buf[base], x1 = buf[base + h];
      const double2 x2 = buf[base + 2 * h], x3 = buf[base + 3 * h];
      // span h: (x0, x1) and (x2, x3) by b
      const double2 t1 = cmul(x1, b), t3 = cmul(x3, b);
      const double2 y0 = cadd(x0, t1), y1 = csub(x0, t1);
      const double2 y2 = cadd(x2, t3), y3 = csub(x2, t3);
      // span 2h: (y0, y2) by a, (y1, y3) by -i a
      const double2 u = cmul(y2, a), v = mul_minus_i(cmul(y3, a));
      buf[base] = cadd(y0, u);
      buf[base + 2 * h] = csub(y0, u);
      buf[base + h] = cadd(y1, v);
      buf[base + 3 * h] = csub(y1, v);
    }
    __syncthreads();
  }
}

// One ring's transform tables and placement of its input.
struct Ring {
  int n, log_len;
  // Bluestein: w_t (n entries), then the filter's transform (L); else null
  const double2* __restrict__ chirp;
  const double2* __restrict__ roots;

  // Put x_k (k < n) where the transform takes it.
  __device__ void place(double2* buf, int k, double2 x) const {
    if (chirp) {
      buf[k] = cmul(x, cconj(__ldcg(chirp + k)));
    } else {
      buf[bit_reversed(k, log_len)] = x;
    }
  }

  // Put the bins H_k that the fold left in natural order in buf[k] (k < n)
  // where the transform takes x_k = conj(H_k), in place: a power of two
  // swaps the pairs (k, bit_reversed(k)), each by the thread of its lower
  // entry.
  __device__ void place_folded(double2* buf) const {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      if (chirp) {
        buf[k] = cmul(cconj(buf[k]), cconj(__ldcg(chirp + k)));
      } else {
        const int j = bit_reversed(k, log_len);
        if (k <= j) {
          const double2 a = buf[k], c = buf[j];
          buf[k] = cconj(c);
          buf[j] = cconj(a);
        }
      }
    }
  }

  // Zero the padding of a Bluestein transform (entries n to L).
  __device__ void pad(double2* buf) const {
    if (!chirp) return;
    for (int j = n + threadIdx.x; j < (1 << log_len); j += blockDim.x) {
      buf[j] = make_double2(0.0, 0.0);
    }
  }

  // The DFT of the placed input (a barrier before); after it, entry k < n
  // of `buf` holds X_k (power of two) or y_k with X_k = conj(w_k y_k)
  // (Bluestein; `bin` reads X_k either way).  Ends with a barrier.
  __device__ void transform(double2* buf) const {
    if (chirp) dif_passes(buf, log_len, roots);
    inner(buf, log_len, chirp ? chirp + n : nullptr);
    dit_passes(buf, log_len, roots);
  }

  // X_k after `transform`.
  __device__ double2 bin(const double2* buf, int k) const {
    return chirp ? cconj(cmul(__ldcg(chirp + k), buf[k])) : buf[k];
  }
};

// Ring r's transform: its n pixels, its length L and tables.
__device__ Ring ring_of(int r, const int64_t* __restrict__ start, const int* __restrict__ fft_len,
                        const int64_t* __restrict__ chirp_at, const double2* chirp,
                        const double2* roots) {
  const int64_t at = chirp_at[r];
  return Ring{static_cast<int>(start[r + 1] - start[r]), 31 - __clz(fft_len[r]),
              at < 0 ? nullptr : chirp + at, roots};
}

// The synthesis of one ring and row into `ob` (its n pixels), the
// transform in `buf` and the fold's slab in `coef`.
template <typename T>
__device__ __forceinline__ void synth_ring(double2* buf, double2* coef, const Ring& ring,
                                           const T* __restrict__ fb, double f0, int nrings,
                                           int nm, T* __restrict__ ob) {
  const int n = ring.n;
  auto turned = [&](int m) {
    double s, c;
    sincos(__dmul_rn(static_cast<double>(m), f0), &s, &c);
    const double re = static_cast<double>(__ldcg(fb + static_cast<long long>(m) * nrings));
    const double im = static_cast<double>(__ldcg(fb + static_cast<long long>(nm + m) * nrings));
    return make_double2(re * c - im * s, re * s + im * c);
  };
  // the transform's input x_k = conj(H_k)
  if (nm > n) {
    // several m a bin: turn a slab of m at once, add it to the bins in the
    // order of m (bin k in buf[k]), then place the bins
    const int slab = min(nm, kFoldSlab);
    for (int m0 = 0; m0 < nm; m0 += slab) {
      const int m1 = min(nm, m0 + slab);
      if (m0 > 0) __syncthreads();  // the last slab's reads are done
      for (int m = m0 + threadIdx.x; m < m1; m += blockDim.x) coef[m - m0] = turned(m);
      __syncthreads();
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        int m = k < m0 ? k + (m0 - k + n - 1) / n * n : k;  // bin k's first m in the slab
        if (m >= m1) continue;
        double2 acc = m == k ? coef[m - m0] : cadd(buf[k], coef[m - m0]);
        for (m += n; m < m1; m += n) acc = cadd(acc, coef[m - m0]);
        buf[k] = acc;
      }
    }
    __syncthreads();
    ring.place_folded(buf);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      ring.place(buf, k, k < nm ? cconj(turned(k)) : make_double2(0.0, 0.0));
    }
  }
  ring.pad(buf);
  __syncthreads();
  ring.transform(buf);
  for (int j = threadIdx.x; j < n; j += blockDim.x) ob[j] = static_cast<T>(ring.bin(buf, j).x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) synth_kernel(
    const T* __restrict__ F, T* __restrict__ out, const int* __restrict__ block_ring,
    const int64_t* __restrict__ start, const double* __restrict__ phi0,
    const int* __restrict__ fft_len, const int64_t* __restrict__ chirp_at,
    const double2* __restrict__ chirp, const double2* __restrict__ roots,
    const int64_t* __restrict__ ws_at, double2* __restrict__ work, int nrings, int nm,
    long long npix, long long ws_row) {
  // the transform in [0, L) (a ring in shared memory) and the fold's slab
  // after it, or the slab alone (a ring in the workspace)
  extern __shared__ double2 smem[];
  const int r = block_ring[blockIdx.x];
  const long long b = blockIdx.y;
  const Ring ring = ring_of(r, start, fft_len, chirp_at, chirp, roots);
  const T* __restrict__ fb = F + b * 2ll * nm * nrings + r;
  T* __restrict__ ob = out + b * npix + start[r];
  const int64_t at = ws_at[r];
  if (at < 0) {
    synth_ring(smem, smem + (1 << ring.log_len), ring, fb, phi0[r], nrings, nm, ob);
  } else {
    synth_ring(work + b * ws_row + at, smem, ring, fb, phi0[r], nrings, nm, ob);
  }
}

// The adjoint of one ring and row from `cb` (its n cotangents) into `gb`
// (its planes' column), the transform in `buf`.
template <typename T>
__device__ __forceinline__ void adjoint_ring(double2* buf, const Ring& ring,
                                             const T* __restrict__ cb, double f0, int nrings,
                                             int nm, T* __restrict__ gb) {
  const int n = ring.n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    ring.place(buf, j, make_double2(static_cast<double>(__ldcg(cb + j)), 0.0));
  }
  ring.pad(buf);
  __syncthreads();
  ring.transform(buf);
  for (int m = threadIdx.x; m < nm; m += blockDim.x) {
    const double2 x = ring.bin(buf, m % n);
    double s, c;
    sincos(__dmul_rn(static_cast<double>(m), f0), &s, &c);
    gb[static_cast<long long>(m) * nrings] = static_cast<T>(x.x * c + x.y * s);
    gb[static_cast<long long>(nm + m) * nrings] = static_cast<T>(x.y * c - x.x * s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adjoint_kernel(
    const T* __restrict__ ct, T* __restrict__ G, const int* __restrict__ block_ring,
    const int64_t* __restrict__ start, const double* __restrict__ phi0,
    const int* __restrict__ fft_len, const int64_t* __restrict__ chirp_at,
    const double2* __restrict__ chirp, const double2* __restrict__ roots,
    const int64_t* __restrict__ ws_at, double2* __restrict__ work, int nrings, int nm,
    long long npix, long long ws_row) {
  extern __shared__ double2 smem[];  // [0, L) the transform of a ring in shared memory
  const int r = block_ring[blockIdx.x];
  const long long b = blockIdx.y;
  const Ring ring = ring_of(r, start, fft_len, chirp_at, chirp, roots);
  const T* __restrict__ cb = ct + b * npix + start[r];
  T* __restrict__ gb = G + b * 2ll * nm * nrings + r;
  const int64_t at = ws_at[r];
  if (at < 0) {
    adjoint_ring(smem, ring, cb, phi0[r], nrings, nm, gb);
  } else {
    adjoint_ring(work + b * ws_row + at, ring, cb, phi0[r], nrings, nm, gb);
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

template <typename Kernel, typename T>
int launch(Kernel kernel, const T* in, T* out, const int* block_ring, const int64_t* start,
           const double* phi0, const int* fft_len, const int64_t* chirp_at, const double* chirp,
           const double* roots, const int64_t* ws_at, double* work, int nrings, int nm,
           long long npix, long long ws_row, int nrows, int smem, int dev, void* stream) {
  if (nrows <= 0 || nrings <= 0 || nm <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(dev, [&]() -> cudaError_t {
    if (smem > kStaticSmem) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<dim3(nrings, nrows), kThreads, smem, s>>>(
        in, out, block_ring, start, phi0, fft_len, chirp_at,
        reinterpret_cast<const double2*>(chirp), reinterpret_cast<const double2*>(roots), ws_at,
        reinterpret_cast<double2*>(work), nrings, nm, npix, ws_row);
    return cudaSuccess;
  });
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

}  // namespace

// The entries' arguments: the input and the output; the host's tables
// (block_ring, ring_start, phi0, fft_len, chirp_at, chirp, roots, ws_at);
// the workspace, ws_row complex doubles a row (null where ws_row is 0);
// the sizes; the dynamic shared memory in bytes; the device and stream.
extern "C" {

#define HP_LONGITUDE_ENTRY(NAME, KERNEL, T)                                                    \
  int NAME(const T* in, T* out, const int* block_ring, const int64_t* start, const double* phi0, \
           const int* fft_len, const int64_t* chirp_at, const double* chirp,                  \
           const double* roots, const int64_t* ws_at, double* work, int nrings, int nm,       \
           long long npix, long long ws_row, int nrows, int smem, int dev, void* stream) {     \
    return launch(KERNEL<T>, in, out, block_ring, start, phi0, fft_len, chirp_at, chirp, roots, \
                  ws_at, work, nrings, nm, npix, ws_row, nrows, smem, dev, stream);           \
  }

HP_LONGITUDE_ENTRY(hp_longitude_f32, synth_kernel, float)
HP_LONGITUDE_ENTRY(hp_longitude_f64, synth_kernel, double)
HP_LONGITUDE_ENTRY(hp_longitude_adjoint_f32, adjoint_kernel, float)
HP_LONGITUDE_ENTRY(hp_longitude_adjoint_f64, adjoint_kernel, double)

#undef HP_LONGITUDE_ENTRY

}  // extern "C"

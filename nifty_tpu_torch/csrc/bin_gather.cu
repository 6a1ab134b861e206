// Power-distributor kernels of the correlated field, for Hopper (sm_90a).
//
//   bin_gather:       out[b, j] = table[b, idx[j]]
//   bin_segment_sum:  out[b, k] = sum_{j : idx[j] = k} cot[b, j]
//
// One shared index map serves every batch row (rows ride on blockIdx.y).
// These two kernels replace all four Pallas kernels of
// nifty_tpu/ops/pallas_gather.py: the select-loop gather/scatter pair
// (_pallas_gather, _pallas_scatter) and the MXU one-hot pair
// (_pallas_gather_mxu, _pallas_scatter_mxu).  A Hopper block holds a
// 1621-entry float64 table (13 KB) or a 113-entry one in shared memory, so
// the TPU's split by table size has no counterpart here.
//
// Both kernels are bound by device-memory traffic: the gather reads 4 B of
// index and writes sizeof(T) B per element; the segment sum reads 4 B of
// permutation and sizeof(T) B of cotangent per element (the cotangent read
// is a gather through the permutation, coalesced within a bin because the
// permutation is a stable sort).  Neither does enough arithmetic to matter.
//
// The segment sum uses no atomics: each (bin, row) pair is one block that
// reduces its CSR segment in a fixed order (strided per-thread partials,
// then a fixed shared-memory tree), so results are bitwise reproducible.
// With one block per bin the largest bin sets the time (366,891 entries of
// 4,198,401 at 4096^2 with 128 log bins); splitting long segments into
// fixed chunks with a second pass is the known next step.
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrapper raises when it is not 0.  Nothing here allocates or
// synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_smem_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                   T* __restrict__ out, long long n, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  const long long b = blockIdx.y;
  const T* row = table + b * static_cast<long long>(nb);
  for (int k = threadIdx.x; k < nb; k += blockDim.x) tab[k] = row[k];
  __syncthreads();
  T* orow = out + b * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    orow[j] = tab[__ldg(idx + j)];
  }
}

// Tables too large for shared memory read through the read-only cache.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_ldg_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                  T* __restrict__ out, long long n, int nb) {
  const long long b = blockIdx.y;
  const T* row = table + b * static_cast<long long>(nb);
  T* orow = out + b * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    orow[j] = __ldg(row + __ldg(idx + j));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ cot, const int32_t* __restrict__ perm,
                   const long long* __restrict__ offsets, T* __restrict__ out,
                   long long n, int nb) {
  __shared__ T part[kThreads];
  const int k = blockIdx.x;
  const long long b = blockIdx.y;
  const long long lo = offsets[k];
  const long long hi = offsets[k + 1];
  const T* crow = cot + b * n;
  T acc = T(0);
  for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
    acc += crow[__ldg(perm + p)];
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[b * nb + k] = part[0];
}

template <typename T>
int launch_gather(const void* table, const void* idx, void* out, long long n,
                  int nb, int nrows, void* stream) {
  if (n == 0 || nrows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Each block stages its row's table once, so give it enough elements
  // to amortise that (at least twice the table length).
  const long long per_block = (2LL * nb > 2048LL) ? 2LL * nb : 2048LL;
  long long gx = (n + per_block - 1) / per_block;
  if (gx > 65535) gx = 65535;  // the grid-stride loop covers the rest
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(nrows));
  const size_t smem = static_cast<size_t>(nb) * sizeof(T);

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  if (smem <= static_cast<size_t>(optin)) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(gather_smem_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    gather_smem_kernel<T><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(table), static_cast<const int32_t*>(idx),
        static_cast<T*>(out), n, nb);
  } else {
    gather_ldg_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(table), static_cast<const int32_t*>(idx),
        static_cast<T*>(out), n, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_segment_sum(const void* cot, const void* perm, const void* offsets,
                       void* out, long long n, int nb, int nrows, void* stream) {
  if (nb == 0 || nrows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(nrows));
  segment_sum_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(cot), static_cast<const int32_t*>(perm),
      static_cast<const long long*>(offsets), static_cast<T*>(out), n, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bin_gather_f32(const void* table, const void* idx, void* out, long long n,
                   int nb, int nrows, void* stream) {
  return launch_gather<float>(table, idx, out, n, nb, nrows, stream);
}

int bin_gather_f64(const void* table, const void* idx, void* out, long long n,
                   int nb, int nrows, void* stream) {
  return launch_gather<double>(table, idx, out, n, nb, nrows, stream);
}

int bin_segment_sum_f32(const void* cot, const void* perm, const void* offsets,
                        void* out, long long n, int nb, int nrows, void* stream) {
  return launch_segment_sum<float>(cot, perm, offsets, out, n, nb, nrows, stream);
}

int bin_segment_sum_f64(const void* cot, const void* perm, const void* offsets,
                        void* out, long long n, int nb, int nrows, void* stream) {
  return launch_segment_sum<double>(cot, perm, offsets, out, n, nb, nrows, stream);
}

}  // extern "C"

// Broadcast scale of a 2-D view (dask_array_tpu_torch).
//
// Replaces bench/probe_pallas_min.py::k_copy, the smallest Pallas kernel of
// the JAX package: o = x * 2.0 on a 256 x 256 float32 array, in (128, 256)
// row blocks held in VMEM.  Here, for a (rows, cols) view x with element
// strides (ld, 1) and a factor array s,
//   out[r, c] = x[r, c] * s[r * rs + c * cs]
// with (rs, cs) = (0, 0) for a scalar, (0, 1) for a row broadcast over the
// rows and (1, 0) for a column; out is contiguous.  A scalar may also come
// by value (s == NULL, its bits in s_bits), so a host number needs no copy
// to the device.  svd_flip's u * signs (1e6 x 128 by a 1 x 128 row),
// vh * signs.T (a column) and 2.0 * (...) (a scalar) are its callers, and
// so is every other real float multiply by a scalar, a row or a column.
//
// Bound: device memory.  A call reads x and writes out once, 2 * rows * cols
// * itemsize bytes, and does one multiply per element.  The kernel walks the
// flattened output, whatever the shape: each thread takes a vector of
// 16 bytes (V elements), so a 1-D array, a narrow last axis and a wide one
// all give full 16-byte accesses on neighbouring addresses.  One division
// per vector finds its (row, column); its factors follow by stepping the
// column and wrapping into the next row.  The factor array is at most one
// row or one column, read through the cache.  Each thread issues kUnroll
// independent vector loads before its stores, to keep bytes in flight.
// Vectors need x and out 16-byte aligned, and x either contiguous (ld ==
// cols) or with cols and ld multiples of V, so that no vector spans two
// rows of a strided view; otherwise V is 1.
//
// Types: float16, bfloat16, float32, float64.  Halves are multiplied in
// float32 and rounded once to nearest even: the product of two halves is
// exact in float32, so the result is the correctly rounded product, as
// torch and numpy give it.  No fast-math and no flush to zero.  Offsets are
// 64-bit (the division is 32-bit when the output's indices fit); the grid is capped
// by the SM count read from the device and its blocks loop over the rest.
// Launches on the caller's stream; scale_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;             // independent vectors in flight per thread
constexpr long long kBlocksPerSm = 8;  // 8 x 256 threads fill an SM

__device__ __forceinline__ __half mul(__half a, __half b) {
  return __float2half_rn(__fmul_rn(__half2float(a), __half2float(b)));
}
__device__ __forceinline__ __nv_bfloat16 mul(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, T (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(v, &u, 16);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[k];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const T (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    memcpy(&u, v, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

// (row, column) of flat output element e; a 32-bit division when it fits
__device__ __forceinline__ void split(long long e, long long cols, bool narrow, long long& r, long long& c) {
  if (narrow) {
    const unsigned rr = static_cast<unsigned>(e) / static_cast<unsigned>(cols);
    r = rr;
    c = e - static_cast<long long>(rr) * cols;
  } else {
    r = e / cols;
    c = e - r * cols;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
scale_flat(const T* __restrict__ x, const T* __restrict__ s, T s0, T* __restrict__ out, long long n,
           long long cols, long long ld, long long rs, long long cs, bool narrow) {
  const long long items = n / V;  // whole vectors; the n % V tail follows
  const long long step = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  for (long long j0 = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x; j0 < items;
       j0 += step) {
    T v[kUnroll][V], f[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + static_cast<long long>(u) * kThreads;
      if (j < items) {
        long long r, c;
        split(j * V, cols, narrow, r, c);
        load<T, V>(x + r * ld + c, v[u]);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          f[u][k] = s ? s[r * rs + c * cs] : s0;
          if (++c == cols) {
            c = 0;
            ++r;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + static_cast<long long>(u) * kThreads;
      if (j < items) {
        T o[V];
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = mul(v[u][k], f[u][k]);
        store<T, V>(out + j * V, o);
      }
    }
  }
  // the tail (only when x is contiguous: a strided view takes V | cols)
  const long long e = items * V + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e < n) {
    long long r, c;
    split(e, cols, narrow, r, c);
    out[e] = mul(x[r * ld + c], s ? s[r * rs + c * cs] : s0);
  }
}

template <typename T, int V>
int run(const T* x, const T* s, T s0, T* out, long long n, long long cols, long long ld, long long rs,
        long long cs, bool narrow, long long cap, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  long long grid = (n / V + per_block - 1) / per_block;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;  // the tail alone
  scale_flat<T, V><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(x, s, s0, out, n, cols, ld, rs, cs,
                                                                        narrow);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xv, const void* sv, unsigned long long s_bits, void* outv, long long rows,
           long long cols, long long ld, long long rs, long long cs, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long cap = kBlocksPerSm * sms;
  const T* x = static_cast<const T*>(xv);
  const T* s = static_cast<const T*>(sv);
  T* out = static_cast<T*>(outv);
  T s0;
  memcpy(&s0, &s_bits, sizeof(T));
  const long long n = rows * cols;
  const bool narrow = n <= 0xffffffffLL;  // every flat output index fits 32 bits
  constexpr int V = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (aligned && (ld == cols || (cols % V == 0 && ld % V == 0)))
    return run<T, V>(x, s, s0, out, n, cols, ld, rs, cs, narrow, cap, stream);
  return run<T, 1>(x, s, s0, out, n, cols, ld, rs, cs, narrow, cap, stream);
}

}  // namespace

extern "C" {

// x: a (rows, cols) view on the device with element strides (ld, 1); s: the
// factors on the device (NULL for a scalar passed by value in the low bytes
// of s_bits); out: a contiguous (rows, cols) buffer on the device.  dtype: 0
// float16, 1 bfloat16, 2 float32, 3 float64.  Returns a cudaError_t.
int scale_launch(const void* x, const void* s, unsigned long long s_bits, void* out, long long rows,
                 long long cols, long long ld, long long rs, long long cs, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || ld < 0 || rs < 0 || cs < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<__half>(x, s, s_bits, out, rows, cols, ld, rs, cs, st);
    case 1: return launch<__nv_bfloat16>(x, s, s_bits, out, rows, cols, ld, rs, cs, st);
    case 2: return launch<float>(x, s, s_bits, out, rows, cols, ld, rs, cs, st);
    case 3: return launch<double>(x, s, s_bits, out, rows, cols, ld, rs, cs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* scale_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

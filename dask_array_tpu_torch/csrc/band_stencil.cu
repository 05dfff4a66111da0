// Band-stencil kernel for 2-D map_overlap (dask_array_tpu_torch).
//
// Replaces dask_array_tpu/kernels/stencil.py::band_stencil_call, the Pallas
// band kernel that runs trim(func(pad(x))) on padded row bands.  Here func
// is a linear stencil of shifted windows, out[i, j] = sum_k w_k *
// b[i + dy_k, j + dx_k] over the boundary-padded input b, read off the user
// function by kernels/stencil.py::capture_taps.
//
// Bound: device memory.  A call must read x and write out once, 2*M*N*itemsize
// bytes, and does a handful of multiply-adds per element.  Each block stages
// its (32 + 2*d0) x (32 + 2*d1) halo tile in shared memory once, with
// neighbouring threads on neighbouring columns, and every tap then reads the
// tile: the shifted reads never go back to device memory, which sees the
// tile's halo re-read (a (2*d/32) fraction) on top of the 2*M*N*itemsize.
//
// Boundaries follow numpy's pad on the whole array, rows first and then
// columns on the row-padded array (as Overlap._build and the Pallas kernel
// do): reflect is numpy "symmetric" (-1 -> 0, -2 -> 1), nearest clamps,
// periodic wraps modulo the axis length, constant fills.  Where axis 1 is
// constant, its fill wins at a corner, even when axis 0 is constant too.
//
// float16 and float32 accumulate in float, float64 in double.  No shape
// condition: ragged edges are masked.  Launches on the caller's stream;
// band_stencil_launch returns cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;    // output columns per block = blockDim.x
constexpr int kTileY = 32;    // output rows per block
constexpr int kThreadsY = 8;  // blockDim.y; each thread owns kTileY / 8 rows
constexpr int kMaxDepth = 8;
constexpr int kMaxTaps = (2 * kMaxDepth + 1) * (2 * kMaxDepth + 1);

enum Boundary { kReflect = 0, kNearest = 1, kPeriodic = 2, kConstant = 3 };

template <typename T>
struct Acc;

template <>
struct Acc<__half> {
  using type = float;
  __device__ static float load(__half v) { return __half2float(v); }
  __device__ static __half store(float v) { return __float2half_rn(v); }
};

template <>
struct Acc<float> {
  using type = float;
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
};

template <>
struct Acc<double> {
  using type = double;
  __device__ static double load(double v) { return v; }
  __device__ static double store(double v) { return v; }
};

// The in-range index an out-of-range position i copies under numpy's pad
// semantics (also past the axis length), or -1 for a constant fill.
__device__ __forceinline__ long long source_index(long long i, long long n, int mode) {
  if (i >= 0 && i < n) return i;
  switch (mode) {
    case kReflect: {
      const long long p = 2 * n;
      const long long m = ((i % p) + p) % p;
      return m < n ? m : p - 1 - m;
    }
    case kNearest:
      return i < 0 ? 0 : n - 1;
    case kPeriodic:
      return ((i % n) + n) % n;
    default:
      return -1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileX * kThreadsY)
band_stencil_kernel(const T* __restrict__ x, T* __restrict__ out, long long M, long long N,
                    int d0, int d1, int bd0, int bd1, double fill0, double fill1,
                    const int* __restrict__ offs, const double* __restrict__ weights,
                    int ntaps) {
  using A = typename Acc<T>::type;
  __shared__ A tile[kTileY + 2 * kMaxDepth][kTileX + 2 * kMaxDepth + 1];
  __shared__ int s_dy[kMaxTaps];
  __shared__ int s_dx[kMaxTaps];
  __shared__ A s_w[kMaxTaps];

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < ntaps; k += blockDim.x * blockDim.y) {
    s_dy[k] = offs[2 * k];
    s_dx[k] = offs[2 * k + 1];
    s_w[k] = static_cast<A>(weights[k]);
  }

  const long long r0 = static_cast<long long>(blockIdx.y) * kTileY;
  const long long c0 = static_cast<long long>(blockIdx.x) * kTileX;
  const int rows = kTileY + 2 * d0;
  const int cols = kTileX + 2 * d1;
  const A f0 = static_cast<A>(fill0);
  const A f1 = static_cast<A>(fill1);
  for (int ly = threadIdx.y; ly < rows; ly += blockDim.y) {
    const long long sr = source_index(r0 + ly - d0, M, bd0);
    for (int lx = threadIdx.x; lx < cols; lx += blockDim.x) {
      const long long sc = source_index(c0 + lx - d1, N, bd1);
      A v;
      if (sc < 0) {
        v = f1;  // columns pad the row-padded array: axis 1's fill wins
      } else if (sr < 0) {
        v = f0;
      } else {
        v = Acc<T>::load(x[sr * N + sc]);
      }
      tile[ly][lx] = v;
    }
  }
  __syncthreads();

  const long long c = c0 + threadIdx.x;
  for (int ty = threadIdx.y; ty < kTileY; ty += blockDim.y) {
    const long long r = r0 + ty;
    if (r >= M || c >= N) continue;
    A acc = 0;
    for (int k = 0; k < ntaps; ++k) {
      acc += s_w[k] * tile[ty + d0 + s_dy[k]][threadIdx.x + d1 + s_dx[k]];
    }
    out[r * N + c] = Acc<T>::store(acc);
  }
}

template <typename T>
void launch(const void* x, void* out, long long M, long long N, int d0, int d1, int bd0, int bd1,
            double fill0, double fill1, const int* offs, const double* weights, int ntaps,
            cudaStream_t stream) {
  const dim3 block(kTileX, kThreadsY);
  const dim3 grid(static_cast<unsigned>((N + kTileX - 1) / kTileX),
                  static_cast<unsigned>((M + kTileY - 1) / kTileY));
  band_stencil_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), M, N, d0, d1, bd0, bd1, fill0, fill1,
      offs, weights, ntaps);
}

}  // namespace

extern "C" {

// dtype: 0 float16, 1 float32, 2 float64.  x and out are contiguous (M, N).
// offs holds 2*ntaps ints (dy, dx pairs), weights ntaps doubles, both on
// the device.  Returns a cudaError_t.
int band_stencil_launch(int dtype, const void* x, void* out, long long M, long long N, int d0,
                        int d1, int bd0, int bd1, double fill0, double fill1, const int* offs,
                        const double* weights, int ntaps, void* stream) {
  if (M <= 0 || N <= 0 || d0 < 0 || d0 > kMaxDepth || d1 < 0 || d1 > kMaxDepth || ntaps < 1 ||
      ntaps > kMaxTaps || (M + kTileY - 1) / kTileY > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<__half>(x, out, M, N, d0, d1, bd0, bd1, fill0, fill1, offs, weights, ntaps, s);
      break;
    case 1:
      launch<float>(x, out, M, N, d0, d1, bd0, bd1, fill0, fill1, offs, weights, ntaps, s);
      break;
    case 2:
      launch<double>(x, out, M, N, d0, d1, bd0, bd1, fill0, fill1, offs, weights, ntaps, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* band_stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Tiled transpose of the last two axes (dask_array_tpu_torch).
//
// Replaces bench/probe_pallas_min.py::_transp_call, the Pallas kernel of the
// rechunk_relayout workload: block (j, i) of an N x N input goes to block
// (i, j) of the output and is transposed in VMEM, with 512 x 512 blocks and
// N % 512 == 0.  Here, for a (B, M, N) input x with element strides
// (stride_b, stride_m, 1), out is a contiguous (B, N, M) array with
//   out[b, j, i] = x[b, i, j].
//
// Bound: device memory.  A call must read and write every byte once,
// 2 * B * M * N * itemsize bytes, and computes nothing.  Each block moves one
// 32 x 32 tile through shared memory: a 32 x 8 thread block reads the tile's
// 32 rows (four rows a thread, neighbouring threads on neighbouring columns,
// so each row is one coalesced read), then writes the tile's 32 columns as
// output rows (again neighbouring threads on neighbouring addresses).  The
// tile has one column of padding, so the column-wise read of shared memory
// falls on 32 different banks for 4-byte elements.  The Pallas grid ran in
// order on one core with megabyte blocks; here many small tiles run on all
// SMs at once.
//
// A transpose moves bytes, so the kernel is templated on the element's size
// (1, 2, 4, 8 and 16 bytes) and every dtype of the port goes through it.
// Edges are masked, so any M and N work.  Offsets are 64-bit.  Tiles are
// numbered on gridDim.x and the blocks loop over them, so no grid dimension
// limits the shape.  The source's row stride is a parameter: a row- or
// column-slice view is read in place.  Launches on the caller's stream;
// transpose_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                 // tile edge = blockDim.x
constexpr int kRowsY = 8;                 // blockDim.y
constexpr int kPerThread = kTile / kRowsY;
constexpr long long kBlocksPerSm = 64;  // the grid holds this many blocks per SM; they loop beyond

template <int kBytes>
struct Element;
template <>
struct Element<1> { using type = uint8_t; };
template <>
struct Element<2> { using type = uint16_t; };
template <>
struct Element<4> { using type = uint32_t; };
template <>
struct Element<8> { using type = unsigned long long; };
template <>
struct Element<16> { using type = ulonglong2; };

template <typename T>
__global__ void __launch_bounds__(kTile * kRowsY)
transpose_tiles(const T* __restrict__ x, T* __restrict__ out, long long M, long long N,
                long long stride_b, long long stride_m, long long tiles_m, long long tiles_n,
                long long tiles) {
  __shared__ T tile[kTile][kTile + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long per_batch = tiles_m * tiles_n;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long b = t / per_batch;
    const long long rem = t - b * per_batch;
    const long long i0 = (rem / tiles_n) * kTile;  // input rows of the tile
    const long long j0 = (rem % tiles_n) * kTile;  // input columns of the tile
    const T* src = x + b * stride_b;
    T* dst = out + b * M * N;

    const long long j = j0 + tx;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int r = ty + k * kRowsY;
      const long long i = i0 + r;
      if (i < M && j < N) tile[r][tx] = src[i * stride_m + j];
    }
    __syncthreads();
    const long long i = i0 + tx;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int c = ty + k * kRowsY;
      const long long jj = j0 + c;
      if (jj < N && i < M) dst[jj * M + i] = tile[tx][c];
    }
    __syncthreads();  // the next tile reuses the shared buffer
  }
}

// The grid cap: kBlocksPerSm blocks for each SM of the current device.
int max_blocks(long long* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = kBlocksPerSm * sms;
  return static_cast<int>(e);
}

template <int kBytes>
int launch(const void* x, void* out, long long B, long long M, long long N, long long stride_b,
           long long stride_m, cudaStream_t s) {
  using T = typename Element<kBytes>::type;
  long long cap = 0;
  if (const int err = max_blocks(&cap)) return err;
  const long long tiles_m = (M + kTile - 1) / kTile;
  const long long tiles_n = (N + kTile - 1) / kTile;
  const long long tiles = B * tiles_m * tiles_n;
  const long long blocks = tiles < cap ? tiles : cap;
  transpose_tiles<T><<<static_cast<unsigned>(blocks), dim3(kTile, kRowsY), 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), M, N, stride_b, stride_m, tiles_m, tiles_n,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (B, M, N) on the device with element strides (stride_b, stride_m, 1);
// out: a contiguous (B, N, M) buffer on the device; elem_bytes is 1, 2, 4, 8
// or 16, and both pointers are aligned to it.  Returns a cudaError_t.
int transpose_launch(const void* x, void* out, long long B, long long M, long long N,
                     long long stride_b, long long stride_m, int elem_bytes, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch<1>(x, out, B, M, N, stride_b, stride_m, s);
    case 2: return launch<2>(x, out, B, M, N, stride_b, stride_m, s);
    case 4: return launch<4>(x, out, B, M, N, stride_b, stride_m, s);
    case 8: return launch<8>(x, out, B, M, N, stride_b, stride_m, s);
    case 16: return launch<16>(x, out, B, M, N, stride_b, stride_m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* transpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

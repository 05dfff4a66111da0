// The band-stencil kernels' staging skeleton (dask_array_tpu_torch).
//
// Shared by csrc/band_stencil.cu (the linear stencils: the register window
// and the tap list) and csrc/band_program.cuh (the kernels generated from a
// func's captured program, kernels/stencil.py::emit_program): the tile
// geometry, the accumulation types, the boundary rules, the staging of a
// tile with 16-byte cp.async (load_tile), the guarded stores and the launch.
// band_stencil.cu's header comment says why the tile has this shape.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxDepth = 8;
constexpr int kTileRows = 24;                   // output rows per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kPad = 8;                         // shared columns beside the tile (>= depth; 16 bytes for 2-byte types)

// Output columns a lane owns (16 bytes of them; 4 for double) and a tile's
// columns and shared row stride, by element type.  Every staged row starts
// 16 bytes aligned: kPad and kStride elements are multiples of 16 bytes.
template <typename T>
constexpr int kLaneCols = sizeof(T) == 2 ? 8 : 4;
template <typename T>
constexpr int kCols = 32 * kLaneCols<T>;
template <typename T>
constexpr int kStride = kCols<T> + 2 * kPad;
static_assert((kTileRows + 2 * kMaxDepth) * kStride<double> * sizeof(double) <= 48 * 1024 &&
                  (kTileRows + 2 * kMaxDepth) * kStride<__half> * sizeof(__half) <= 48 * 1024,
              "a tile beyond the 48 KiB a block gets without opting in");
static_assert(kPad * sizeof(__half) % 16 == 0 && kStride<__half> * sizeof(__half) % 16 == 0,
              "2-byte rows staged off 16-byte alignment");

enum Boundary { kReflect = 0, kNearest = 1, kPeriodic = 2, kConstant = 3 };

// What every kernel reads; each kernel's parameter block adds its own.
struct Shape {
  long long M, N;
  int tiles_x;  // tiles along a row: tile t is (t / tiles_x, t % tiles_x)
  int d0, d1, bd0, bd1;
  int vec;  // 1: rows and pointers allow 16-byte accesses
  double fill0, fill1;
};

template <typename T>
struct Acc;

template <>
struct Acc<__half> {
  using type = float;
  __device__ static float load(__half v) { return __half2float(v); }
  __device__ static __half store(float v) { return __float2half_rn(v); }
};

template <>
struct Acc<__nv_bfloat16> {
  using type = float;
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
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

// K consecutive elements, read and written as one access (two for 4 doubles)
template <typename T, int K>
struct alignas(K * sizeof(T) < 16 ? K * sizeof(T) : 16) Vec {
  T v[K];
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Stage the input tile: tile row ly, column lx (lx in [-d1, kCols + d1))
// holds b[r0 - d0 + ly, c0 + lx] at tile[ly * kStride + kPad + lx].
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, T* tile, const Shape& p, long long r0,
                                          long long c0, int d0, int d1, bool interior) {
  constexpr int kTileCols = kCols<T>;
  constexpr int kS = kStride<T>;
  const int rows = kTileRows + 2 * d0;
  const int tid = threadIdx.x;
  if (interior) {
    const T* src0 = x + (r0 - d0) * p.N + c0;
    if (p.vec) {
      constexpr int kVec = 16 / static_cast<int>(sizeof(T));
      constexpr int kChunks = kTileCols / kVec;  // 16-byte chunks a row
      constexpr int kStep = kThreads / kChunks;  // rows a pass
      const int ch = tid % kChunks;
      int ly = tid / kChunks;
      const T* src = src0 + ly * p.N + ch * kVec;
      T* dst = tile + ly * kS + kPad + ch * kVec;
      const long long src_step = kStep * p.N;
      for (; ly < rows; ly += kStep, src += src_step, dst += kStep * kS) cp_async16(dst, src);
    } else {
      constexpr int kStep = kThreads / kTileCols;
      const int lx = tid % kTileCols;
      int ly = tid / kTileCols;
      const T* src = src0 + ly * p.N + lx;
      T* dst = tile + ly * kS + kPad + lx;
      const long long src_step = kStep * p.N;
#pragma unroll 4
      for (; ly < rows; ly += kStep, src += src_step, dst += kStep * kS) *dst = *src;
    }
    if (d1) {  // the halo columns on both sides: 2*d1 scalars a row
      const int per_row = 2 * d1;
      for (int i = tid; i < rows * per_row; i += kThreads) {
        const int ly = i / per_row;
        const int k = i - ly * per_row;
        const int lx = k < d1 ? k - d1 : kTileCols + k - d1;
        tile[ly * kS + kPad + lx] = src0[ly * p.N + lx];
      }
    }
    cp_async_wait_all();
  } else {
    using A = typename Acc<T>::type;
    const T f0 = Acc<T>::store(static_cast<A>(p.fill0));
    const T f1 = Acc<T>::store(static_cast<A>(p.fill1));
    for (int ly = tid >> 5; ly < rows; ly += kWarps) {
      const long long sr = source_index(r0 - d0 + ly, p.M, p.bd0);
      const T* srow = x + (sr < 0 ? 0 : sr) * p.N;
      for (int lx = (tid & 31) - d1; lx < kTileCols + d1; lx += 32) {
        const long long sc = source_index(c0 + lx, p.N, p.bd1);
        // columns pad the row-padded array: axis 1's fill wins at a corner
        tile[ly * kS + kPad + lx] = sc < 0 ? f1 : (sr < 0 ? f0 : srow[sc]);
      }
    }
  }
  __syncthreads();
}

// K outputs of row r at columns c..c+K-1: one vector store where the tile
// is in range and aligned, masked scalars otherwise.
template <typename T, int K>
__device__ __forceinline__ void store_vec(T* __restrict__ out, const Shape& p, long long r, long long c,
                                          const typename Acc<T>::type (&acc)[K], bool full) {
  if (full && p.vec) {
    Vec<T, K> q;
#pragma unroll
    for (int j = 0; j < K; ++j) q.v[j] = Acc<T>::store(acc[j]);
    *reinterpret_cast<Vec<T, K>*>(out + r * p.N + c) = q;
  } else if (r < p.M) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (c + j < p.N) out[r * p.N + c + j] = Acc<T>::store(acc[j]);
  }
}

// The tile a block stages: its origin, whether it is interior (its halo
// inside the array) and whether its outputs are all in range.
struct Tile {
  long long r0, c0;
  bool interior, full;
};

template <typename T>
__device__ __forceinline__ Tile tile_of(const Shape& p, int d0, int d1) {
  constexpr int kTileCols = kCols<T>;
  Tile t;
  const unsigned ty = blockIdx.x / static_cast<unsigned>(p.tiles_x);
  t.r0 = static_cast<long long>(ty) * kTileRows;
  t.c0 = static_cast<long long>(blockIdx.x - ty * static_cast<unsigned>(p.tiles_x)) * kTileCols;
  t.interior = t.r0 >= d0 && t.r0 + kTileRows + d0 <= p.M && t.c0 >= d1 && t.c0 + kTileCols + d1 <= p.N;
  t.full = t.r0 + kTileRows <= p.M && t.c0 + kTileCols <= p.N;
  return t;
}

// Launch ``kernel`` over T's tile grid (tiles_x along a row, set here for
// T) with the staged tile's shared memory; returns cudaGetLastError().
template <typename T, typename Kernel, typename P>
int launch(Kernel kernel, const void* x, void* out, P p, cudaStream_t stream) {
  p.s.tiles_x = static_cast<int>((p.s.N + kCols<T> - 1) / kCols<T>);
  const size_t smem = static_cast<size_t>(kTileRows + 2 * p.s.d0) * kStride<T> * sizeof(T);
  const unsigned tiles = static_cast<unsigned>(p.s.tiles_x * ((p.s.M + kTileRows - 1) / kTileRows));
  kernel<<<tiles, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// The launch checks every entry point makes: a shape the tile grid can
// count, depths within kMaxDepth, and 16-byte rows and pointers where vec
// says so.  Returns a cudaError_t (cudaSuccess when the launch may go).
inline int check_launch(const void* x, const void* out, long long M, long long N, int d0, int d1, size_t itemsize,
                        int vec) {
  if (M <= 0 || N <= 0 || d0 < 0 || d0 > kMaxDepth || d1 < 0 || d1 > kMaxDepth ||
      ((M + kTileRows - 1) / kTileRows) * ((N + kCols<double> - 1) / kCols<double>) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 ||
              (N * static_cast<long long>(itemsize)) % 16)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

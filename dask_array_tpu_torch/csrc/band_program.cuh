// Band-stencil kernels generated from a func's captured program
// (dask_array_tpu_torch).
//
// Replaces the rest of dask_array_tpu/kernels/stencil.py::band_stencil_call:
// the Pallas kernel inlines any shape-preserving jnp func on the padded
// band (`res = func(padded)`), so a non-linear func (tanh of a Laplace, a
// gradient magnitude, a max filter, a `where`) runs in one kernel there.
// kernels/stencil.py::capture_program reads such a func into a straight-line
// program of pointwise ops over taps b[i + dy, j + dx]; emit_program writes
// it as one functor, Program::eval, of one output's taps (WindowTaps or
// TileTaps below) and of the program's scalars.  The generated source
// includes this header, defines Program for its one element type and
// depth, and exports band_program_launch.  Code is generated rather than
// interpreted: an interpreter inside the kernel would index its value
// registers dynamically, which puts them in local memory.  The scalars
// (a func's constants and keyword values, and 1/c for each x / c) come by
// value in the parameter block, as the tap kernels' weights do, so one
// build serves every value of them; only pow's exponents, which choose
// its expression, are code.
//
// Bound: device memory, as the linear kernels: a call must read x and
// write out once, 2*M*N*itemsize bytes; a program of transcendental
// functions adds arithmetic, still far below the card's rate a byte.  A
// block stages a 24-row tile of 32 lanes x 16 bytes of columns with its
// halo (band_stencil_tile.cuh: 16-byte cp.async for interior tiles, the
// boundary rules for edge tiles).  Two ways to evaluate it, chosen at
// compile time by the type and the depth (kWindowed):
//  - the 2-byte types take the register window (program_window) where its
//    values fit kWindowValues (depths up to (2, 2)): as linear K1's window
//    kernel, a thread owns K = 8 consecutive columns of 3 consecutive rows
//    and slides a window of the 2*D0 + 1 input rows of its K + 2*D1
//    columns down them.  Each staged element is read once a thread row, in
//    16-byte vectors (its own and one on each side), so a warp's load uses
//    the whole width of shared memory where a 2-byte single read used half
//    of it, and is converted to float once; every tap of every output is
//    then a register (WindowTaps).  Read tap by tap, a 3x3 program made 9
//    loads and 9 converts an output;
//  - float32 and float64, and deeper 2-byte programs, read each tap from
//    the tile (TileTaps), a thread's 3 x K outputs at rows warp + 8i and
//    columns lane + 32j: shared reads without bank conflicts, coalesced
//    stores, a long program's values kept in registers.  A 4-byte read
//    already uses the whole width of shared memory; the window took 1-11 %
//    longer there on the H100 (PERF.md), its registers spilling.
// Each output is computed in Acc<T> (float for the 2-byte types and
// float32, double for float64) with the _rn intrinsics, which nvcc never
// contracts into an FMA, and rounded once on the store.
//
// maximum and minimum propagate NaN as torch's CUDA kernels do: a NaN
// operand is returned, the first one where both are.  That took about four
// instructions an edge.  A chain of them (the max filter's eight) is one
// fast pass of max.NaN / min.NaN (one instruction each: the canonical NaN
// if any operand is NaN, else the chain's value), and only where its
// result is NaN or a zero (one test, nan_or_zero) is the chain evaluated
// again in the plain order (max_first_nan): the NaN returned is the same
// operand's bits, and a zero's sign is the one that order gives, whatever
// the instruction does with +0 against -0.  Any other result is the one
// value the chain can have, in any order (kernels/stencil.py::_emit).
#pragma once

#include <utility>

#include "band_stencil_tile.cuh"

namespace {

constexpr int kWindowValues = 64;  // window registers a thread at most (a (2, 2) program: 5 x 12)

// The shape and the program's scalar slots, in its compute type.
template <typename T, int Slots>
struct ProgramParams {
  Shape s;
  typename Acc<T>::type c[Slots > 0 ? Slots : 1];
};

// NaN-propagating maximum and minimum in one instruction: a NaN operand
// gives the canonical NaN (float64 has no such instruction: the plain form).
__device__ __forceinline__ float max_any_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_any_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_first_nan(float a, float b) { return (a != a) ? a : ((b != b) ? b : fmaxf(a, b)); }
__device__ __forceinline__ float min_first_nan(float a, float b) { return (a != a) ? a : ((b != b) ? b : fminf(a, b)); }
__device__ __forceinline__ double max_first_nan(double a, double b) { return (a != a) ? a : ((b != b) ? b : fmax(a, b)); }
__device__ __forceinline__ double min_first_nan(double a, double b) { return (a != a) ? a : ((b != b) ? b : fmin(a, b)); }
__device__ __forceinline__ double max_any_nan(double a, double b) { return max_first_nan(a, b); }
__device__ __forceinline__ double min_any_nan(double a, double b) { return min_first_nan(a, b); }
__device__ __forceinline__ bool nan_or_zero(float v) { return !(fabsf(v) > 0.0f); }
__device__ __forceinline__ bool nan_or_zero(double v) { return !(fabs(v) > 0.0); }

// A program's taps: w.template at<dy, dx>() of output column J of a
// thread's window (every index known at compile time, so the window stays
// in registers) or of the staged tile at the output's own element.
template <typename A, int H, int C, int D0, int D1, int J>
struct WindowTaps {
  const A (&w)[H][C];
  template <int DY, int DX>
  __device__ __forceinline__ A at() const {
    return w[D0 + DY][J + D1 + DX];
  }
};

template <typename T>
struct TileTaps {
  const T* p;
  template <int DY, int DX>
  __device__ __forceinline__ typename Acc<T>::type at() const {
    return Acc<T>::load(p[DY * kStride<T> + DX]);
  }
};

template <typename F, int... I>
__device__ __forceinline__ void for_each_index(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

template <typename T, int D0, int D1>
constexpr bool kWindowed = sizeof(T) == 2 && (2 * D0 + 1) * (kLaneCols<T> + 2 * D1) <= kWindowValues;

template <typename T, int D0, int D1, typename Prog>
__device__ __forceinline__ void program_window(const T* tile, T* __restrict__ out,
                                               const ProgramParams<T, Prog::kSlots>& p, const Tile& t) {
  using A = typename Acc<T>::type;
  constexpr int K = kLaneCols<T>;
  using V = Vec<T, K>;
  constexpr int H = 2 * D0 + 1;
  constexpr int C = K + 2 * D1;
  constexpr int NV = (D1 + K - 1) / K;  // vectors read on each side of the thread's own
  const int rb = (threadIdx.x >> 5) * kRowsPerWarp;  // the warp's first output row, tile-local
  const int col = K * (threadIdx.x & 31);             // the thread's first output column
  A win[H][C];  // win[a][c]: tile row (output row + a), tile column (col - D1 + c)
#pragma unroll
  for (int r = 0; r < kRowsPerWarp + 2 * D0; ++r) {
#pragma unroll
    for (int a = 0; a + 1 < H; ++a)
#pragma unroll
      for (int c = 0; c < C; ++c) win[a][c] = win[a + 1][c];
    const T* row = tile + (rb + r) * kStride<T> + kPad + col;
#pragma unroll
    for (int v = -NV; v <= NV; ++v) {
      const V q = *reinterpret_cast<const V*>(row + v * K);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = v * K + k + D1;
        if (c >= 0 && c < C) win[H - 1][c] = Acc<T>::load(q.v[k]);
      }
    }
    if (r >= 2 * D0) {
      A res[K];
      for_each_index(
          [&](auto j) {
            constexpr int J = decltype(j)::value;
            res[J] = Prog::eval(WindowTaps<A, H, C, D0, D1, J>{win}, p.c);
          },
          std::make_integer_sequence<int, K>{});
      store_vec<T, K>(out, p.s, t.r0 + rb + r - 2 * D0, t.c0 + col, res, t.full);
    }
  }
}

template <typename T, int D0, int D1, typename Prog>
__device__ __forceinline__ void program_taps(const T* tile, T* __restrict__ out,
                                             const ProgramParams<T, Prog::kSlots>& p, const Tile& t) {
  constexpr int K = kLaneCols<T>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int ly = warp + kWarps * i;
    const long long r = t.r0 + ly;
    if (r >= p.s.M) break;
    const T* at = tile + (ly + D0) * kStride<T> + kPad + lane;
    T* dst = out + r * p.s.N + t.c0 + lane;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (t.full || t.c0 + lane + 32 * j < p.s.N) dst[32 * j] = Acc<T>::store(Prog::eval(TileTaps<T>{at + 32 * j}, p.c));
  }
}

template <typename T, int D0, int D1, typename Prog>
__global__ void __launch_bounds__(kThreads)
band_stencil_program(const T* __restrict__ x, T* __restrict__ out,
                     const __grid_constant__ ProgramParams<T, Prog::kSlots> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const Tile t = tile_of<T>(p.s, D0, D1);
  load_tile<T>(x, tile, p.s, t.r0, t.c0, D0, D1, t.interior);
  if constexpr (kWindowed<T, D0, D1>) {
    program_window<T, D0, D1, Prog>(tile, out, p, t);
  } else {
    program_taps<T, D0, D1, Prog>(tile, out, p, t);
  }
}

// The generated entry point's body: the depth the library was built for
// must be the call's, the scalars as many as the program's slots (each in
// its compute type), the boundary codes known, the shape and alignment
// those check_launch takes.  Returns a cudaError_t.
template <typename T, int D0, int D1, typename Prog>
int launch_program(const void* x, void* out, long long M, long long N, int d0, int d1, int bd0, int bd1,
                   double fill0, double fill1, int vec, const void* scalars, int nscalars, void* stream) {
  if (d0 != D0 || d1 != D1 || nscalars != Prog::kSlots || bd0 < kReflect || bd0 > kConstant || bd1 < kReflect ||
      bd1 > kConstant) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int refused = check_launch(x, out, M, N, d0, d1, sizeof(T), vec);
  if (refused) return refused;
  ProgramParams<T, Prog::kSlots> p;
  memset(&p, 0, sizeof(p));
  memcpy(p.c, scalars, sizeof(p.c[0]) * Prog::kSlots);
  p.s.M = M;
  p.s.N = N;
  p.s.d0 = D0;
  p.s.d1 = D1;
  p.s.bd0 = bd0;
  p.s.bd1 = bd1;
  p.s.vec = vec ? 1 : 0;
  p.s.fill0 = fill0;
  p.s.fill1 = fill1;
  return launch<T>(&band_stencil_program<T, D0, D1, Prog>, x, out, p, static_cast<cudaStream_t>(stream));
}

}  // namespace

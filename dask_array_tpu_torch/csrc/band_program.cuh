// Band-stencil kernels generated from a func's captured program
// (dask_array_tpu_torch).
//
// Replaces the rest of dask_array_tpu/kernels/stencil.py::band_stencil_call:
// the Pallas kernel inlines any shape-preserving jnp func on the padded
// band (`res = func(padded)`), so a non-linear func (tanh of a Laplace, a
// gradient magnitude, a max filter, a `where`) runs in one kernel there.
// kernels/stencil.py::capture_program reads such a func into a straight-line
// program of pointwise ops over taps b[i + dy, j + dx]; emit_program writes
// it as one functor, Program::eval, of a pointer to the output's place in
// the staged tile and of the program's scalars.  The generated source
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
// functions adds arithmetic, still far below the card's rate a byte.  The
// design is the tap-list kernel's (csrc/band_stencil.cu): a block stages a
// 24-row tile of 32 lanes x 16 bytes of columns with its halo
// (band_stencil_tile.cuh: 16-byte cp.async for interior tiles, the
// boundary rules for edge tiles), and a thread evaluates the program for
// its 3 x K outputs at rows warp + 8i and columns lane + 32j: shared reads
// without bank conflicts, coalesced stores.  A thread walks its rows one at
// a time (the K outputs of a row in flight together), so a long program's
// values stay in registers.  Each output is computed in Acc<T> (float for
// the 2-byte types and float32, double for float64) with the _rn
// intrinsics, which nvcc never contracts into an FMA, and rounded once on
// the store.
#pragma once

#include "band_stencil_tile.cuh"

namespace {

// The shape and the program's scalar slots, in its compute type.
template <typename T, int Slots>
struct ProgramParams {
  Shape s;
  typename Acc<T>::type c[Slots > 0 ? Slots : 1];
};

template <typename T, int D0, int D1, typename Prog>
__global__ void __launch_bounds__(kThreads)
band_stencil_program(const T* __restrict__ x, T* __restrict__ out,
                     const __grid_constant__ ProgramParams<T, Prog::kSlots> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const Tile t = tile_of<T>(p.s, D0, D1);
  load_tile<T>(x, tile, p.s, t.r0, t.c0, D0, D1, t.interior);
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
      if (t.full || t.c0 + lane + 32 * j < p.s.N) dst[32 * j] = Acc<T>::store(Prog::eval(at + 32 * j, p.c));
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

// Band-stencil kernel for 2-D map_overlap (dask_array_tpu_torch).
//
// Replaces dask_array_tpu/kernels/stencil.py::band_stencil_call, the Pallas
// band kernel that runs trim(func(pad(x))) on padded row bands.  Here func
// is a linear stencil of shifted windows, out[i, j] = sum_k w_k *
// b[i + dy_k, j + dx_k] over the boundary-padded input b, read off the user
// function by kernels/stencil.py::capture_taps.  A non-linear func runs in
// a kernel generated from its captured program (csrc/band_program.cuh);
// both stage their tiles with band_stencil_tile.cuh.
//
// Bound: device memory.  A call must read x and write out once, 2*M*N*itemsize
// bytes, and does a handful of multiply-adds per element.  The design:
//  - a block computes a 24-row output tile of 32 lanes x 16 bytes of
//    columns (kCols: 128 for float32, 256 for float16 and bfloat16; float64
//    keeps 128, two 16-byte vectors a lane) and stages its
//    (24 + 2*d0) x (kCols + 2*d1) input tile in shared memory once, so the
//    halo re-read is 2*d0/24 + 2*d1/kCols of the input (10 % at depth 1,
//    f32, from the old 32x32 tiles' 13 %).  Short tiles keep 20 KB of
//    shared memory a block (f32, depth 1), so more blocks per SM overlap
//    one's loads with another's arithmetic; of 16 to 64 rows, 24 was the
//    fastest on the H100 at 4096^2 and at 16384^2 (for 2-byte types at
//    4096^2; 32 rows gained 3 % at 16384^2 there).  A 2-byte tile as wide
//    as f32's had moved half the bytes for all of its fixed cost (staging,
//    the wait, the barrier, the halo columns, the index math).  Tiles are
//    numbered row-major on a 1-D grid, counted here (band_stencil_launch),
//    not by the caller;
//  - an interior block, whose halo lies inside the array, maps no index: it
//    copies tile rows with 16-byte cp.async where the row length and the
//    pointers allow (scalar loads otherwise) and fetches its 2*d1 halo
//    columns directly; only an edge block maps positions through the
//    boundary rules.  The branch is uniform per block;
//  - the taps arrive by value, in a __grid_constant__ parameter block: no
//    per-block copy, and a thread keeps its weights in registers;
//  - depth (1,1) (the 5-point and 3x3 stencils) takes a register-window
//    kernel: a thread owns K = kCols / 32 consecutive columns (4; 8 for
//    2-byte types) of 3 consecutive rows, keeps the last 2*d0 + 1 input
//    rows of its K + 2*d1 columns in registers, reads shared memory in
//    aligned K-element vectors (its own and one on each side; no bank
//    conflicts) and stores its K outputs as one 16-byte vector (two for
//    double).  For 2-byte types it is compiled for six blocks an SM (40
//    registers, band_stencil_window16): the wide tiles need that many in
//    flight (4096^2 bf16 0.0459 ms on the device, against 0.0493 at 58
//    registers and four blocks, and 0.0484 with 128-column tiles; seven or
//    eight blocks spill and take 0.066).  A persistent grid that staged a
//    block's next tile while computing this one took 80 registers and
//    0.071 ms.  Every other depth loops over the tap list, a thread
//    owning K columns 32 apart on 3 rows (conflict-free reads, coalesced
//    stores); column pairs read as one 4-byte word (two and a byte permute
//    for an odd column offset) took 0.067 ms at 4096^2, depth (2, 3), to
//    these single reads' 0.060.  A tap of the dense window that the stencil
//    lacks is skipped, not multiplied by 0, so an inf in the input stays an
//    inf.  (Measured by scripts/time_stencil.py, PERF.md.)
//
// Boundaries follow numpy's pad on the whole array, rows first and then
// columns on the row-padded array (as Overlap._build and the Pallas kernel
// do): reflect is numpy "symmetric" (-1 -> 0, -2 -> 1), nearest clamps,
// periodic wraps modulo the axis length, constant fills.  Where axis 1 is
// constant, its fill wins at a corner, even when axis 0 is constant too.
//
// float16, bfloat16 and float32 accumulate in float, float64 in double; a
// 16-bit value is widened on load and rounded once, to nearest even, on
// store.  No shape
// condition: ragged edges are masked.  Launches on the caller's stream;
// band_stencil_launch returns cudaGetLastError().

#include "band_stencil_tile.cuh"

namespace {

constexpr int kMaxTaps = (2 * kMaxDepth + 1) * (2 * kMaxDepth + 1);
constexpr int kMaxWindow = 9;                   // dense window weights, depth (1, 1)

// kernels/stencil.py::_tap_table packs these: the kernel a launch takes
enum Variant { kTaps = 0, kWindow11 = 1 };

// Each kernel's parameter block adds its taps to the Shape, so a window
// launch carries about 130 bytes of parameters, a tap-list one 3 KB.
struct WindowParams {
  Shape s;
  unsigned int mask;          // bit a*(2*d1+1)+b: the dense window has a tap at (a-d0, b-d1)
  double window[kMaxWindow];  // dense weights, row-major over (dy, dx)
};

struct TapParams {
  Shape s;
  int ntaps;
  double w[kMaxTaps];
  signed char dy[kMaxTaps];
  signed char dx[kMaxTaps];
};

// The register-window kernel's compute: depth (D0, D1) known at compile
// time, dense weights, a thread's kRowsPerWarp rows walked top to bottom.
template <typename T, int D0, int D1>
__device__ __forceinline__ void compute_window(const T* tile, T* __restrict__ out, const WindowParams& p, long long r0,
                                               long long c0, bool full) {
  static_assert(D1 <= 4, "the window reads one aligned vector on each side");
  using A = typename Acc<T>::type;
  constexpr int K = kLaneCols<T>;
  using V = Vec<T, K>;
  constexpr int H = 2 * D0 + 1;
  constexpr int W = 2 * D1 + 1;
  constexpr int C = K + 2 * D1;
  A wt[H][W];
  bool on[H][W];
#pragma unroll
  for (int a = 0; a < H; ++a)
#pragma unroll
    for (int b = 0; b < W; ++b) {
      wt[a][b] = static_cast<A>(p.window[a * W + b]);
      on[a][b] = (p.mask >> (a * W + b)) & 1u;
    }
  const int lane = threadIdx.x & 31;
  const int rb = (threadIdx.x >> 5) * kRowsPerWarp;  // the warp's first output row, tile-local
  const int col = K * lane;                           // the thread's first output column
  A win[H][C];  // win[a][c]: tile row (output row + a), tile column (col - D1 + c)
#pragma unroll
  for (int t = 0; t < kRowsPerWarp + 2 * D0; ++t) {
#pragma unroll
    for (int a = 0; a + 1 < H; ++a)
#pragma unroll
      for (int c = 0; c < C; ++c) win[a][c] = win[a + 1][c];
    const T* row = tile + (rb + t) * kStride<T> + kPad + col;
    A vals[3 * K];  // the vectors left of, at and right of the thread's columns
    const V mid = *reinterpret_cast<const V*>(row);
#pragma unroll
    for (int k = 0; k < K; ++k) vals[K + k] = Acc<T>::load(mid.v[k]);
    if constexpr (D1 > 0) {
      const V left = *reinterpret_cast<const V*>(row - K);
      const V right = *reinterpret_cast<const V*>(row + K);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        vals[k] = Acc<T>::load(left.v[k]);
        vals[2 * K + k] = Acc<T>::load(right.v[k]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) win[H - 1][c] = vals[K - D1 + c];
    if (t >= 2 * D0) {
      A acc[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        acc[j] = 0;
#pragma unroll
        for (int a = 0; a < H; ++a)
#pragma unroll
          for (int b = 0; b < W; ++b)
            if (on[a][b]) acc[j] += wt[a][b] * win[a][j + b];
      }
      store_vec<T, K>(out, p.s, r0 + rb + t - 2 * D0, c0 + col, acc, full);
    }
  }
}

// The tap-list kernel's compute: any depth up to 8, the taps read from the
// parameter block (uniform across the block), a thread's 3 x K outputs at
// rows warp + 8i and columns lane + 32j (K = kLaneCols).
template <typename T>
__device__ __forceinline__ void compute_taps(const T* tile, T* __restrict__ out, const TapParams& p, long long r0,
                                             long long c0, int d0) {
  using A = typename Acc<T>::type;
  constexpr int kS = kStride<T>;
  constexpr int K = kLaneCols<T>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  A acc[kRowsPerWarp][K];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) acc[i][j] = 0;
  for (int k = 0; k < p.ntaps; ++k) {
    const A w = static_cast<A>(p.w[k]);
    const T* base = tile + (warp + d0 + p.dy[k]) * kS + kPad + lane + p.dx[k];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) acc[i][j] += w * Acc<T>::load(base[i * kWarps * kS + 32 * j]);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long long r = r0 + warp + kWarps * i;
    if (r >= p.s.M) break;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const long long c = c0 + lane + 32 * j;
      if (c < p.s.N) out[r * p.s.N + c] = Acc<T>::store(acc[i][j]);
    }
  }
}

template <typename T, int D0, int D1>
__device__ __forceinline__ void window_tile(const T* __restrict__ x, T* __restrict__ out, const WindowParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const Tile t = tile_of<T>(p.s, D0, D1);
  load_tile<T>(x, tile, p.s, t.r0, t.c0, D0, D1, t.interior);
  compute_window<T, D0, D1>(tile, out, p, t.r0, t.c0, t.full);
}

template <typename T, int D0, int D1>
__global__ void __launch_bounds__(kThreads)
band_stencil_window(const T* __restrict__ x, T* __restrict__ out, const __grid_constant__ WindowParams p) {
  window_tile<T, D0, D1>(x, out, p);
}

// The window kernel of 2-byte types, compiled for six blocks an SM (40
// registers a thread): their wide tiles need more of them in flight.  (A
// minimum of blocks on the 4- and 8-byte kernels, even of one, changes
// their registers: float32 took 52 for 44, and 4 % longer.)
template <typename T, int D0, int D1>
__global__ void __launch_bounds__(kThreads, 6)
band_stencil_window16(const T* __restrict__ x, T* __restrict__ out, const __grid_constant__ WindowParams p) {
  window_tile<T, D0, D1>(x, out, p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_stencil_taps(const T* __restrict__ x, T* __restrict__ out, const __grid_constant__ TapParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const Tile t = tile_of<T>(p.s, p.s.d0, p.s.d1);
  load_tile<T>(x, tile, p.s, t.r0, t.c0, p.s.d0, p.s.d1, t.interior);
  compute_taps<T>(tile, out, p, t.r0, t.c0, p.s.d0);
}

// The depth each kernel variant takes.
bool variant_fits(int variant, int d0, int d1) {
  return variant == kTaps || (variant == kWindow11 && d0 == 1 && d1 == 1);
}

}  // namespace

extern "C" {

// dtype: 0 float16, 1 float32, 2 float64, 3 bfloat16.  x and out are contiguous (M, N)
// on the device.  table: host bytes packed by kernels/stencil.py::_tap_table,
// little-endian:
//   int32 d0, d1, bd0, bd1, ntaps, variant, window_mask, 0;   (32 bytes)
//   float64 fill0, fill1;                                     (offset 32)
//   float64 window[9];                                        (offset 48)
//   float64 w[ntaps];                                         (offset 120)
//   int32 dy[ntaps]; int32 dx[ntaps];
// vec: 1 when N * itemsize and both pointers are multiples of 16 bytes
// (checked here).  Returns a cudaError_t.
int band_stencil_launch(int dtype, const void* x, void* out, long long M, long long N, const void* table, int vec,
                        void* stream) {
  const unsigned char* t = static_cast<const unsigned char*>(table);
  int head[8];
  memcpy(head, t, sizeof(head));
  const int d0 = head[0], d1 = head[1], ntaps = head[4], variant = head[5];
  const size_t itemsize = (dtype == 0 || dtype == 3) ? 2 : (dtype == 1 ? 4 : 8);
  if (dtype < 0 || dtype > 3 || ntaps < 1 || ntaps > kMaxTaps || !variant_fits(variant, d0, d1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int refused = check_launch(x, out, M, N, d0, d1, itemsize, vec);
  if (refused) return refused;
  Shape sh;
  memset(&sh, 0, sizeof(sh));
  sh.M = M;
  sh.N = N;
  sh.d0 = d0;
  sh.d1 = d1;
  sh.bd0 = head[2];
  sh.bd1 = head[3];
  sh.vec = vec ? 1 : 0;
  memcpy(&sh.fill0, t + 32, 8);
  memcpy(&sh.fill1, t + 40, 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant != kTaps) {
    WindowParams p;
    memset(&p, 0, sizeof(p));
    p.s = sh;
    p.mask = static_cast<unsigned int>(head[6]);
    memcpy(p.window, t + 48, sizeof(p.window));
    switch (dtype) {
      case 0: return launch<__half>(&band_stencil_window16<__half, 1, 1>, x, out, p, s);
      case 1: return launch<float>(&band_stencil_window<float, 1, 1>, x, out, p, s);
      case 3: return launch<__nv_bfloat16>(&band_stencil_window16<__nv_bfloat16, 1, 1>, x, out, p, s);
      default: return launch<double>(&band_stencil_window<double, 1, 1>, x, out, p, s);
    }
  }
  TapParams p;
  memset(&p, 0, sizeof(p));
  p.s = sh;
  p.ntaps = ntaps;
  memcpy(p.w, t + 120, 8 * static_cast<size_t>(ntaps));
  const unsigned char* offs = t + 120 + 8 * static_cast<size_t>(ntaps);
  for (int k = 0; k < ntaps; ++k) {
    int dy, dx;
    memcpy(&dy, offs + 4 * k, 4);
    memcpy(&dx, offs + 4 * (ntaps + k), 4);
    if (dy < -d0 || dy > d0 || dx < -d1 || dx > d1) return static_cast<int>(cudaErrorInvalidValue);
    p.dy[k] = static_cast<signed char>(dy);
    p.dx[k] = static_cast<signed char>(dx);
  }
  switch (dtype) {
    case 0: return launch<__half>(&band_stencil_taps<__half>, x, out, p, s);
    case 1: return launch<float>(&band_stencil_taps<float>, x, out, p, s);
    case 3: return launch<__nv_bfloat16>(&band_stencil_taps<__nv_bfloat16>, x, out, p, s);
    default: return launch<double>(&band_stencil_taps<double>, x, out, p, s);
  }
}

const char* band_stencil_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

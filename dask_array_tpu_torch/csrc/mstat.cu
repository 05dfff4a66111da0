// Multi-statistic reduction kernel (dask_array_tpu_torch).
//
// Replaces bench/probe_reduction.py::pallas_mstat, the Pallas kernel that
// computes in one read of a 2-D float32 array x (M, N) what the
// reduction_tree workload asks for:
//   colsum  = x.sum(0)                         (N,)
//   rowmean = x.sum(1) / N                     (M,)
//   std     = sqrt(ss / n - (s / n)^2)         0-d, s = sum(x), ss = sum(x*x),
//                                              n = M * N, all in float32
// and the raw sums s and ss themselves.  Given a device scalar shift c, s
// and ss are taken of x - c (std is unchanged in exact arithmetic): the
// port's one-pass shifted variance reads them instead of two more passes.
// The TPU kernel walked row tiles in order and carried colsum, s and ss in
// VMEM from one grid step to the next.  CUDA blocks run in parallel in no
// order, so nothing carries over: the work is two launches.
//
//   Launch 1 (mstat_tiles): each block owns a tile of kRows rows and strides
//   over all columns, neighbouring threads on neighbouring columns, so each
//   row of the tile is read coalesced.  For its tile it writes the kRows row
//   means, one row of partial column sums into a (T, N) buffer, T = ceil(M /
//   kRows), and one (s, ss) pair.
//   Launch 2 (mstat_finish): sums the partial column sums over the T tiles,
//   and one extra block sums the T (s, ss) pairs and forms std.
//
// The outputs share one buffer: [colsum (N) | rowmean (M) | std | s | ss].
//
// Bound: device memory.  The function must read M*N*4 bytes once and writes
// (N + M + 3)*4; launch 1 adds T*N*4 bytes of partials written and read
// again, kRows times fewer than x.  A handful of adds per element.
//
// Sums are float32, as on the TPU, taken in a fixed order (no atomics), so
// two runs give the same bits.  Within a tile a column's kRows values are
// summed in registers, across tiles with compensated (Kahan) sums, and row,
// s and ss partials across threads with shuffle/shared-memory trees.  No
// shape condition: ragged rows and columns are masked.  Launches on the
// caller's stream; mstat_launch returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;      // rows per tile (launch 1)
constexpr int kThreads = 256;  // threads per block (launch 1)
constexpr int kWarps = kThreads / 32;
constexpr int kColsX = 32;     // columns per block (launch 2) = blockDim.x
constexpr int kSplitY = 8;     // tiles split across blockDim.y (launch 2)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

struct Kahan {
  float sum = 0.0f;
  float c = 0.0f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = sum + y;
    c = (t - sum) - y;
    sum = t;
  }
};

__global__ void __launch_bounds__(kThreads)
mstat_tiles(const float* __restrict__ x, const float* __restrict__ shift,
            float* __restrict__ rowmean, float* __restrict__ partial, float* __restrict__ pairs,
            long long M, long long N) {
  __shared__ float s_rows[kWarps][kRows];
  __shared__ float s_pair[kWarps][2];

  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(M - r0 < kRows ? M - r0 : kRows);
  const float* tile = x + r0 * N;
  float* part = partial + static_cast<long long>(blockIdx.x) * N;

  float row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) row[r] = 0.0f;
  const float shift_c = shift != nullptr ? *shift : 0.0f;
  float s = 0.0f;
  float ss = 0.0f;

  for (long long c = threadIdx.x; c < N; c += kThreads) {
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = r < rows ? tile[r * N + c] : 0.0f;
    float col = 0.0f;
    float cold = 0.0f;  // sum of v - c over the tile's valid rows
    float colsq = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float d = r < rows ? v[r] - shift_c : 0.0f;
      col += v[r];
      cold += d;
      colsq += d * d;
      row[r] += v[r];
    }
    part[c] = col;
    s += cold;
    ss += colsq;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float w = warp_sum(row[r]);
    if (lane == 0) s_rows[warp][r] = w;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    s_pair[warp][0] = s;
    s_pair[warp][1] = ss;
  }
  __syncthreads();

  if (threadIdx.x < kRows && threadIdx.x < rows) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_rows[w][threadIdx.x];
    rowmean[r0 + threadIdx.x] = t / static_cast<float>(N);
  }
  if (threadIdx.x == 0) {
    float ts = 0.0f;
    float tss = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ts += s_pair[w][0];
      tss += s_pair[w][1];
    }
    pairs[2 * blockIdx.x] = ts;
    pairs[2 * blockIdx.x + 1] = tss;
  }
}

// Blocks 0 .. gridDim.x-2 reduce kColsX columns each; the last block
// reduces the (s, ss) pairs and writes std, s and ss.
__global__ void __launch_bounds__(kColsX * kSplitY)
mstat_finish(const float* __restrict__ partial, const float* __restrict__ pairs,
             float* __restrict__ colsum, float* __restrict__ tail, long long T, long long N,
             float n) {
  __shared__ float s_acc[kSplitY][kColsX + 1];
  __shared__ float s_acc2[kSplitY][kColsX + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  if (blockIdx.x + 1 < gridDim.x) {
    const long long c = static_cast<long long>(blockIdx.x) * kColsX + tx;
    Kahan k;
    if (c < N) {
      for (long long t = ty; t < T; t += kSplitY) k.add(partial[t * N + c]);
    }
    s_acc[ty][tx] = k.sum;
    __syncthreads();
    if (ty == 0 && c < N) {
      Kahan total;
#pragma unroll
      for (int y = 0; y < kSplitY; ++y) total.add(s_acc[y][tx]);
      colsum[c] = total.sum;
    }
    return;
  }

  // the (s, ss) pairs of the T tiles: kColsX * kSplitY threads, fixed order
  const int tid = ty * kColsX + tx;
  Kahan ks;
  Kahan kss;
  for (long long t = tid; t < T; t += kColsX * kSplitY) {
    ks.add(pairs[2 * t]);
    kss.add(pairs[2 * t + 1]);
  }
  s_acc[ty][tx] = ks.sum;
  s_acc2[ty][tx] = kss.sum;
  __syncthreads();
  if (tid == 0) {
    Kahan ts;
    Kahan tss;
    for (int y = 0; y < kSplitY; ++y) {
      for (int xx = 0; xx < kColsX; ++xx) {
        ts.add(s_acc[y][xx]);
        tss.add(s_acc2[y][xx]);
      }
    }
    const float mean = ts.sum / n;
    tail[0] = sqrtf(tss.sum / n - mean * mean);
    tail[1] = ts.sum;
    tail[2] = tss.sum;
  }
}

}  // namespace

extern "C" {

// x is a contiguous float32 (M, N) array and shift a device scalar or null;
// out (N + M + 3) receives [colsum | rowmean | std | s | ss]; partial (T, N)
// and pairs (T, 2) are scratch, with T = mstat_tiles_for(M).  All on the
// device.  Returns a cudaError_t.
long long mstat_tiles_for(long long M) { return (M + kRows - 1) / kRows; }

int mstat_launch(const float* x, const float* shift, float* out, float* partial, float* pairs,
                 long long M, long long N, void* stream) {
  const long long T = mstat_tiles_for(M);
  const long long col_blocks = (N + kColsX - 1) / kColsX;
  if (M <= 0 || N <= 0 || T > 2147483647LL || col_blocks + 1 > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mstat_tiles<<<static_cast<unsigned>(T), kThreads, 0, s>>>(x, shift, out + N, partial, pairs, M,
                                                            N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float n = static_cast<float>(M) * static_cast<float>(N);
  mstat_finish<<<static_cast<unsigned>(col_blocks + 1), dim3(kColsX, kSplitY), 0, s>>>(
      partial, pairs, out, out + N + M, T, N, n);
  return static_cast<int>(cudaGetLastError());
}

const char* mstat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

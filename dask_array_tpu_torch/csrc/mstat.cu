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
// order, so nothing carries over between them: the work is two launches.
//
// Bound: device memory.  The function must read M*N*4 bytes once and write
// (N + M + 3)*4; a dozen adds per element are far below the card's rate.
// So the design is about keeping every SM's loads in flight on any shape:
//
//   Plan (kernels/mstat.py::launch_plan, a pure function of (M, N) and the
//   SM count).  L lanes share a row (a power of two, at most 32, the least
//   with 4L >= N), each thread owning 4 adjacent columns, loaded as one
//   16-byte vector where the row length and the pointer allow it (scalar
//   loads otherwise, in the same kernel).  TW warps lie side by side across
//   a strip of SW = 4 * L * TW columns (up to 8 warps: a row read in 4 KB
//   pieces), and the block's other warps go down the rows; a narrow array
//   gives a warp 32/L rows at once (N = 7: 2 lanes a row, 16 rows a warp).
//   The (strip, row) units, S*M of them, are laid out strip by strip, and a
//   persistent grid of G = SMs * 2 blocks (one wave: __launch_bounds__(256,
//   2)) takes G equal runs of them, block b units [b*U/G, (b+1)*U/G).  A run
//   is cut where a strip ends into segments, a few at most, and every shape
//   gives every block the same work to a row.
//
//   Launch 1 (mstat_main): a block walks its segments 16 rows a thread at a
//   time (16 loads in flight).  Column sums stay in registers across a
//   segment's rows and are reduced over the row warps through shared
//   memory once a segment, into colpart[b + s] (SW floats); row sums are
//   reduced over the L lanes with shuffles (four rows in 6 shuffles), into
//   rowmean directly when a row is one warp's, else into rowpart[s * TW +
//   warp][row]; each block writes one (s, ss) pair.
//   Launch 2 (mstat_finish): colsum from the segments of each strip,
//   rowmean from the partials of each row (threads an output sized so each
//   adds about 16, then a pairwise tree in shared memory), and one block sums
//   the G pairs and forms std.
//
// Sums are float32, as on the TPU, taken in a fixed order (no atomics), so
// two runs give the same bits.  Per-thread column sums and (s, ss) add 16
// rows plainly, then carry a compensated (Kahan) sum, as do the reductions
// over warps and blocks; the finish's trees are pairwise.  Launches on the
// caller's stream; mstat_launch returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // threads per block (launch 1)
constexpr int kMinBlocks = 2;       // blocks resident on an SM (launch 1)
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 16;          // rows a thread loads before adding (a multiple of 4)

struct Kahan {
  float sum = 0.0f;
  float c = 0.0f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = sum + y;
    c = (t - sum) - y;
    sum = t;
  }
  __device__ __forceinline__ float value() const { return sum - c; }
};

// runs: run i of R takes units [i*U/R, (i+1)*U/R)
__device__ __forceinline__ long long run_start(long long i, long long U, long long R) {
  return i * U / R;
}

// the run that holds unit u: the largest i with i*U/R <= u
__device__ __forceinline__ long long run_of(long long u, long long U, long long R) {
  return ((u + 1) * R - 1) / U;
}

// 4 columns from p, column c of N: one 16-byte load, or up to 4 masked ones
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, long long c, long long N) {
  if (kVec) {
    return c < N ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 v;
  v.x = c < N ? __ldg(p) : 0.0f;
  v.y = c + 1 < N ? __ldg(p + 1) : 0.0f;
  v.z = c + 2 < N ? __ldg(p + 2) : 0.0f;
  v.w = c + 3 < N ? __ldg(p + 3) : 0.0f;
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mstat_main(const float* __restrict__ x, const float* __restrict__ shift, float* __restrict__ rowout,
           float* __restrict__ colpart, float* __restrict__ pairs, long long M, long long N,
           int lanes_log2, int tw_log2, long long S, long long G) {
  __shared__ float s_col[kThreads * 4];  // (row warps) x SW = 32 * L * 8 floats at most
  __shared__ float s_pair[kWarps][2];

  const int L = 1 << lanes_log2;
  const int W = 4 * L;                   // a warp's columns
  const int SW = W << tw_log2;           // a strip's columns: TW warps side by side
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tw = warp & ((1 << tw_log2) - 1);  // the warp's place across the strip
  const int tr = warp >> tw_log2;              // its place down the rows
  const int q = lane & (L - 1);                // column slot in the warp
  const int team = (tr << (5 - lanes_log2)) + (lane >> lanes_log2);  // row team
  const int teams = kThreads >> (lanes_log2 + tw_log2);
  const long long U = S * M;
  const long long b = blockIdx.x;
  const long long u1 = run_start(b + 1, U, G);
  const float c_shift = shift != nullptr ? *shift : 0.0f;
  const bool direct = S == 1 && tw_log2 == 0;  // one strip of one warp: rowmean itself

  Kahan ks, kss;
  for (long long u = run_start(b, U, G); u < u1;) {
    const long long s = u / M;
    const long long r0 = u - s * M;
    const long long seg_end = (s + 1) * M < u1 ? (s + 1) * M : u1;
    const long long r1 = r0 + (seg_end - u);
    const int cs = tw * W + 4 * q;  // column in the strip
    const long long c0 = s * SW + cs;
    float* rowdst = direct ? rowout : rowout + ((s << tw_log2) + tw) * M;
    bool colok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) colok[k] = c0 + k < N;
    Kahan col[4];
    const long long step = static_cast<long long>(teams) * N;
    for (long long base = r0; base < r1; base += static_cast<long long>(kBatch) * teams) {
      const int left = static_cast<int>(r1 - base < kBatch * teams ? r1 - base : kBatch * teams);
      const float* p = x + (base + team) * N + c0;
      float4 v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        v[i] = i * teams + team < left ? load4<kVec>(p + i * step, c0, N)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float bc[4] = {0.f, 0.f, 0.f, 0.f};
      float bs = 0.0f, bss = 0.0f;
      float rs[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const bool ok = i * teams + team < left;
        const float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
        rs[i] = (e[0] + e[1]) + (e[2] + e[3]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bc[k] += e[k];
          if (ok && colok[k]) {
            const float d = e[k] - c_shift;
            bs += d;
            bss += d * d;
          }
        }
      }
      if (L == 32) {
        // each four row sums over the warp in 6 shuffles: halve the rows a
        // lane holds twice (lanes 16 apart, then 8), then add across the
        // remaining 8 lanes; lane 8j ends with row g + j
        const bool hi16 = lane & 16, hi8 = lane & 8;
#pragma unroll
        for (int g = 0; g < kBatch; g += 4) {
          const float k0 = (hi16 ? rs[g + 2] : rs[g]) +
                           __shfl_xor_sync(0xffffffffu, hi16 ? rs[g] : rs[g + 2], 16);
          const float k1 = (hi16 ? rs[g + 3] : rs[g + 1]) +
                           __shfl_xor_sync(0xffffffffu, hi16 ? rs[g + 1] : rs[g + 3], 16);
          float t = (hi8 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, hi8 ? k0 : k1, 8);
#pragma unroll
          for (int off = 4; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
          const int i = g + (lane >> 3);
          if ((lane & 7) == 0 && i * teams + team < left) {
            rowdst[base + i * teams + team] = direct ? t / static_cast<float>(N) : t;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          // the row's sum over its L lanes (xor stays inside the lane group)
          float t = rs[i];
          for (int off = L >> 1; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
          if (q == 0 && i * teams + team < left) {
            rowdst[base + i * teams + team] = direct ? t / static_cast<float>(N) : t;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) col[k].add(bc[k]);
      ks.add(bs);
      kss.add(bss);
    }
    // the segment's column sums: over the row teams inside a warp with
    // shuffles, over the row warps through shared memory, in order
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float t = col[k].value();
      for (int off = L; off < 32; off <<= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
      if (lane < L) s_col[tr * SW + cs + k] = t;
    }
    __syncthreads();
    const int rows_of_warps = kWarps >> tw_log2;
    for (int c = threadIdx.x; c < SW; c += kThreads) {
      Kahan t;
      for (int w = 0; w < rows_of_warps; ++w) t.add(s_col[w * SW + c]);
      colpart[(b + s) * SW + c] = t.value();
    }
    __syncthreads();
    u = seg_end;
  }

  float ps = ks.value(), pss = kss.value();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ps += __shfl_down_sync(0xffffffffu, ps, off);
    pss += __shfl_down_sync(0xffffffffu, pss, off);
  }
  if (lane == 0) {
    s_pair[warp][0] = ps;
    s_pair[warp][1] = pss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Kahan ts, tss;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ts.add(s_pair[w][0]);
      tss.add(s_pair[w][1]);
    }
    pairs[2 * b] = ts.value();
    pairs[2 * b + 1] = tss.value();
  }
}

// Blocks [0, col_blocks) finish 256 >> yc_log2 columns each, with 2^yc_log2
// threads a column; [col_blocks, col_blocks + row_blocks) 256 >> yr_log2
// rows each (only with more than one row strip); the last block sums the G
// (s, ss) pairs and writes std, s and ss.  A block's columns lie in one
// strip, whose runs its first thread finds.
__global__ void __launch_bounds__(kThreads)
mstat_finish(const float* __restrict__ colpart, const float* __restrict__ rowpart,
             const float* __restrict__ pairs, float* __restrict__ out, long long M, long long N,
             int SW, long long row_strips, long long G, long long col_blocks, long long row_blocks,
             int yc_log2, int yr_log2) {
  __shared__ float s_acc[kThreads];
  __shared__ float s_acc2[kThreads];
  __shared__ long long s_runs[2];
  const int t = threadIdx.x;
  const long long S = (N + SW - 1) / SW;
  const long long U = S * M;
  const long long bid = blockIdx.x;

  if (bid < col_blocks + row_blocks) {
    const bool cols = bid < col_blocks;
    const int y_log2 = cols ? yc_log2 : yr_log2;
    const int per_log2 = 8 - y_log2;  // outputs a block
    const int o = t & ((1 << per_log2) - 1);
    const int k = t >> per_log2;
    const long long first = (cols ? bid : bid - col_blocks) << per_log2;
    const long long i = first + o;
    Kahan acc;
    if (cols) {
      const long long s = first / SW;
      if (t == 0) {
        s_runs[0] = run_of(s * M, U, G);
        s_runs[1] = run_of((s + 1) * M - 1, U, G);
      }
      __syncthreads();
      const bool sparse = U < G;  // some runs are empty
      if (i < N) {
        const float* col = colpart + s * SW + (i - s * SW);
        for (long long b = s_runs[0] + k; b <= s_runs[1]; b += 1 << y_log2) {
          if (!sparse || run_start(b, U, G) < run_start(b + 1, U, G)) acc.add(__ldg(col + b * SW));
        }
      }
    } else if (i < M) {
#pragma unroll 4
      for (long long s = k; s < row_strips; s += 1 << y_log2) acc.add(__ldg(rowpart + s * M + i));
    }
    s_acc[t] = acc.value();
    // the output's 2^y_log2 partials, pairwise in a fixed order
    for (int half = (1 << y_log2) >> 1; half >= 1; half >>= 1) {
      __syncthreads();
      if (k < half) s_acc[t] += s_acc[t + (half << per_log2)];
    }
    __syncthreads();
    if (k == 0 && i < (cols ? N : M)) {
      if (cols) {
        out[i] = s_acc[t];
      } else {
        out[N + i] = s_acc[t] / static_cast<float>(N);
      }
    }
    return;
  }

  // the (s, ss) pairs of the G blocks, in a fixed order
  Kahan ks, kss;
  for (long long b = t; b < G; b += kThreads) {
    ks.add(pairs[2 * b]);
    kss.add(pairs[2 * b + 1]);
  }
  s_acc[t] = ks.value();
  s_acc2[t] = kss.value();
  __syncthreads();
  if (t == 0) {
    Kahan ts, tss;
    for (int y = 0; y < kThreads; ++y) {
      ts.add(s_acc[y]);
      tss.add(s_acc2[y]);
    }
    const float n = static_cast<float>(M) * static_cast<float>(N);
    const float mean = ts.value() / n;
    out[N + M] = sqrtf(tss.value() / n - mean * mean);
    out[N + M + 1] = ts.value();
    out[N + M + 2] = tss.value();
  }
}

}  // namespace

extern "C" {

// x is a (M, N) float32 array, rows N apart, and shift a device scalar or
// null; out (N + M + 3) receives [colsum | rowmean | std | s | ss].  The
// plan comes from kernels/mstat.py::launch_plan: 2^lanes_log2 lanes a row,
// 2^tw_log2 warps across a strip of SW = 4 << (lanes_log2 + tw_log2)
// columns, S = ceil(N / SW) strips, G blocks.  colpart ((G + S) * SW),
// rowpart (S * 2^tw_log2 * M, unused when that is M) and pairs (2 * G) are
// scratch.  vec: 16-byte loads (N % 4 == 0 and x 16-byte aligned).  All on
// the device.  Returns a cudaError_t.
int mstat_launch(const float* x, const float* shift, float* out, float* colpart, float* rowpart,
                 float* pairs, long long M, long long N, int lanes_log2, int tw_log2, long long S,
                 long long G, int vec, void* stream) {
  const long long SW = 4LL << (lanes_log2 + tw_log2);
  if (M <= 0 || N <= 0 || lanes_log2 < 0 || lanes_log2 > 5 || tw_log2 < 0 || tw_log2 > 3 ||
      (tw_log2 > 0 && lanes_log2 != 5) || S != (N + SW - 1) / SW || G <= 0 || G > 2147483647LL ||
      (vec && (N % 4 != 0 || reinterpret_cast<size_t>(x) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long strips = S << tw_log2;  // row partials: one a warp-wide strip
  // finish: threads an output (up to 256) so that each adds about 16 of its
  // partials: the runs a strip (G / S + 2 at most) or the row strips; a
  // block's columns inside one strip
  int yc = 0, yr = 0;
  while (yc < 8 && (16LL << yc) < G / S + 2) ++yc;
  while (S > 1 && (kThreads >> yc) > SW) ++yc;
  while (yr < 8 && (16LL << yr) < strips) ++yr;
  const long long col_blocks = (N + (kThreads >> yc) - 1) / (kThreads >> yc);
  const long long row_blocks = strips > 1 ? (M + (kThreads >> yr) - 1) / (kThreads >> yr) : 0;
  if (col_blocks + row_blocks + 1 > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rowout = strips == 1 ? out + N : rowpart;
  if (vec) {
    mstat_main<true><<<static_cast<unsigned>(G), kThreads, 0, st>>>(
        x, shift, rowout, colpart, pairs, M, N, lanes_log2, tw_log2, S, G);
  } else {
    mstat_main<false><<<static_cast<unsigned>(G), kThreads, 0, st>>>(
        x, shift, rowout, colpart, pairs, M, N, lanes_log2, tw_log2, S, G);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mstat_finish<<<static_cast<unsigned>(col_blocks + row_blocks + 1), kThreads, 0, st>>>(
      colpart, rowpart, pairs, out, M, N, static_cast<int>(SW), strips, G, col_blocks, row_blocks, yc,
      yr);
  return static_cast<int>(cudaGetLastError());
}

const char* mstat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

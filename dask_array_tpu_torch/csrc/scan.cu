// Step-rounded scan of 2-byte and 1-byte floats (dask_array_tpu_torch, K3).
//
// Replaces the JAX package's dense scan, jnp.cumsum / jnp.cumprod in
// CumReduction._build (dask_array_tpu/ops/reductions.py:831-845), an XLA
// scan and no Pallas kernel, for the result types whose scan numpy rounds
// to the type after every step: float16, bfloat16 and the 1-byte floats.
// A torch scan carries float32 and rounds once, so no library call gives
// these bytes.
//
// A block is viewed as (P, L, Q) around the scanned axis: P the product of
// the axes before it, Q of those after.  Each of the P * Q chains is
//   out[0] = x[0]                      (a copy: no rounding, no quieting)
//   out[i] = step(out[i - 1], x[i])    for i = 1 .. L - 1
// and the chains are independent.  A 2-byte step converts both values to
// float32, adds or multiplies once (no contraction, no flush to zero) and
// rounds to the type, nearest even.  A NaN is made by an explicit rule, not
// by the card's conversion (which gives a canonical NaN): a NaN term's bits
// quieted where the term is NaN, else the running value's bits quieted
// where it is NaN, else (inf - inf, 0 * inf) the x86-64 default NaN, which
// is negative.  float16 quiets by setting the payload's top bit (numpy's
// conversion keeps the payload); bfloat16 by the sign and 0x7fc0 (ml_dtypes
// drops the payload).  That is numpy's result on x86-64 for every step,
// both operands NaN included.  A 1-byte step is a lookup in the type's
// 256 x 256 table of rounded results, table[running * 256 + term], made on
// the host from the type's own conversions and held here in shared memory
// (64 KiB).
//
// Bound: a chain's steps depend on each other, so a few long chains are
// bound by the latency of one step (a convert, an add, a convert and a
// select; or one shared-memory load) times L; many chains by device memory,
// one read and one write of the block.  A thread scans one chain, and its
// loads do not depend on the carry, so it keeps them ahead of the chain:
// three batches of terms in registers, each batch's loads issued two
// batches before it is scanned (the three rotate by name, so no register
// copy waits on a load in flight).  Inside whole batches a step tests
// nothing: loads past the end are clamped to the last index, and a NaN's
// bits are selected, not branched to; only the last batches test indices.
//   - scan_cols (Q > 1, and rows that vectors do not fit): neighbouring
//     threads on neighbouring chains, so each load of a warp is one
//     coalesced row segment; a batch is kBatch terms.
//   - scan_rows (Q == 1, rows whose length and start take 16-byte
//     vectors): a thread reads and writes its row in 16-byte vectors, a
//     batch kVectors of them; a warp's 32 rows meet in L1 and L2, where
//     each 32-byte sector a lane touches is read whole and used by its
//     next vector.  A 1-D scan is one such row, one thread's chain.
// The output is written in the input's layout.  Offsets are 64-bit.
// Launches on the caller's stream; scan_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 32;    // terms of a column batch
constexpr int kVectors = 8;   // 16-byte vectors of a row batch
constexpr int kTableBytes = 256 * 256;

struct Half {
  using T = uint16_t;
  static __device__ __forceinline__ float value(T h) { return __half2float(__ushort_as_half(h)); }
  static __device__ __forceinline__ T round(float f) { return __half_as_ushort(__float2half_rn(f)); }
  static __device__ __forceinline__ bool nan(T h) { return (h & 0x7fffu) > 0x7c00u; }
  static __device__ __forceinline__ T quiet(T h) { return static_cast<T>(h | 0x0200u); }
  static constexpr T kDefaultNaN = 0xfe00u;
};

struct BFloat {
  using T = uint16_t;
  static __device__ __forceinline__ float value(T h) { return __uint_as_float(static_cast<uint32_t>(h) << 16); }
  static __device__ __forceinline__ T round(float f) { return __bfloat16_as_ushort(__float2bfloat16_rn(f)); }
  static __device__ __forceinline__ bool nan(T h) { return (h & 0x7fffu) > 0x7f80u; }
  static __device__ __forceinline__ T quiet(T h) { return static_cast<T>((h & 0x8000u) | 0x7fc0u); }
  static constexpr T kDefaultNaN = 0xffc0u;
};

// one step of a 2-byte type F; kMul picks the product
template <class F, bool kMul>
struct FloatStep {
  using T = typename F::T;
  static constexpr int kShared = 0;
  __device__ __forceinline__ explicit FloatStep(const uint8_t*) {}
  __device__ __forceinline__ T operator()(T s, T x) const {
    const float a = F::value(s), b = F::value(x);
    const float r = kMul ? __fmul_rn(a, b) : __fadd_rn(a, b);
    // a NaN's bits by the rule, worked out beside the add (not on the chain)
    const T made = F::nan(x) ? F::quiet(x) : F::nan(s) ? F::quiet(s) : F::kDefaultNaN;
    return r != r ? made : F::round(r);
  }
};

// one step of a 1-byte type: its table, in shared memory
struct ByteStep {
  using T = uint8_t;
  static constexpr int kShared = kTableBytes;
  const uint8_t* tab;
  __device__ __forceinline__ explicit ByteStep(const uint8_t* shared) : tab(shared) {}
  __device__ __forceinline__ T operator()(T s, T x) const { return tab[(static_cast<unsigned>(s) << 8) | x]; }
};

// copy the table into the block's shared memory (every thread of the block)
template <class Step>
__device__ __forceinline__ void load_table(const uint8_t* table, uint8_t* shared) {
  if constexpr (Step::kShared > 0) {
    const uint4* src = reinterpret_cast<const uint4*>(table);
    uint4* dst = reinterpret_cast<uint4*>(shared);
    for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x) dst[i] = src[i];
    __syncthreads();
  }
}

// terms i .. i + kBatch - 1 of a column chain, each index clamped to the
// chain's last (a load past it reads a term that is never scanned)
template <class T>
__device__ __forceinline__ void load_terms(const T* src, long long i, long long last, long long Q,
                                           T (&b)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) b[u] = src[min(i + u, last) * Q];
}

// scan a batch of terms i .. i + kBatch - 1: all of them (kFull), or those
// before L
template <bool kFull, class Step, class T>
__device__ __forceinline__ void scan_terms(const Step& step, T& s, T* dst, long long i, long long L, long long Q,
                                           const T (&b)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (kFull || i + u < L) {
      s = step(s, b[u]);
      dst[(i + u) * Q] = s;
    }
  }
}

template <class Step>
__global__ void __launch_bounds__(kThreads)
scan_cols(const typename Step::T* __restrict__ x, typename Step::T* __restrict__ out, long long chains,
          long long L, long long Q, const uint8_t* __restrict__ table) {
  using T = typename Step::T;
  extern __shared__ __align__(16) uint8_t shared[];
  load_table<Step>(table, shared);
  const Step step(shared);
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= chains) return;
  const long long p = c / Q;
  const long long base = p * L * Q + (c - p * Q);
  const T* src = x + base;
  T* dst = out + base;
  const long long last = L - 1;
  T a[kBatch], b[kBatch], d[kBatch];
  load_terms(src, 1, last, Q, a);
  load_terms(src, 1 + kBatch, last, Q, b);
  T s = src[0];
  dst[0] = s;
  long long i = 1;
  for (; i + 3 * kBatch <= L; i += 3 * kBatch) {  // whole batches: no test a step
    load_terms(src, i + 2 * kBatch, last, Q, d);
    scan_terms<true>(step, s, dst, i, L, Q, a);
    load_terms(src, i + 3 * kBatch, last, Q, a);
    scan_terms<true>(step, s, dst, i + kBatch, L, Q, b);
    load_terms(src, i + 4 * kBatch, last, Q, b);
    scan_terms<true>(step, s, dst, i + 2 * kBatch, L, Q, d);
  }
  load_terms(src, i + 2 * kBatch, last, Q, d);  // fewer than 3 * kBatch terms left
  scan_terms<false>(step, s, dst, i, L, Q, a);
  scan_terms<false>(step, s, dst, i + kBatch, L, Q, b);
  scan_terms<false>(step, s, dst, i + 2 * kBatch, L, Q, d);
}

// 16-byte vectors v .. v + kVectors - 1 of a row, each index clamped to
// the row's last
__device__ __forceinline__ void load_vectors(const uint4* src, long long v, long long last,
                                             uint4 (&b)[kVectors]) {
#pragma unroll
  for (int j = 0; j < kVectors; ++j) b[j] = __ldg(src + min(v + j, last));
}

// scan the elements of one vector after the running value s (from its
// first element on, or from the second where ``from`` is 1)
template <class Step>
__device__ __forceinline__ uint4 scan_vector(const Step& step, typename Step::T& s, uint4 in, int from = 0) {
  using T = typename Step::T;
  constexpr int V = 16 / sizeof(T);
  T e[V];
  memcpy(e, &in, 16);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k >= from) {
      s = step(s, e[k]);
      e[k] = s;
    }
  }
  uint4 o;
  memcpy(&o, e, 16);
  return o;
}

// scan vectors v .. v + kVectors - 1: all of them (kFull), or those before n
template <bool kFull, class Step>
__device__ __forceinline__ void scan_vectors(const Step& step, typename Step::T& s, uint4* dst, long long v,
                                             long long n, const uint4 (&b)[kVectors]) {
#pragma unroll
  for (int j = 0; j < kVectors; ++j) {
    if (kFull || v + j < n) dst[v + j] = scan_vector(step, s, b[j]);
  }
}

template <class Step>
__global__ void __launch_bounds__(kThreads)
scan_rows(const typename Step::T* __restrict__ x, typename Step::T* __restrict__ out, long long rows, long long L,
          const uint8_t* __restrict__ table) {
  using T = typename Step::T;
  extern __shared__ __align__(16) uint8_t shared[];
  load_table<Step>(table, shared);
  const Step step(shared);
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const long long n = L / (16 / sizeof(T));
  const long long last = n - 1;
  const uint4* src = reinterpret_cast<const uint4*>(x + r * L);
  uint4* dst = reinterpret_cast<uint4*>(out + r * L);
  uint4 a[kVectors], b[kVectors], d[kVectors];
  load_vectors(src, 1, last, a);
  load_vectors(src, 1 + kVectors, last, b);
  const uint4 head = __ldg(src);
  T s;
  memcpy(&s, &head, sizeof(T));  // the first element is a copy
  dst[0] = scan_vector(step, s, head, 1);
  long long v = 1;
  for (; v + 3 * kVectors <= n; v += 3 * kVectors) {  // whole batches: no test a vector
    load_vectors(src, v + 2 * kVectors, last, d);
    scan_vectors<true>(step, s, dst, v, n, a);
    load_vectors(src, v + 3 * kVectors, last, a);
    scan_vectors<true>(step, s, dst, v + kVectors, n, b);
    load_vectors(src, v + 4 * kVectors, last, b);
    scan_vectors<true>(step, s, dst, v + 2 * kVectors, n, d);
  }
  load_vectors(src, v + 2 * kVectors, last, d);  // fewer than 3 * kVectors vectors left
  scan_vectors<false>(step, s, dst, v, n, a);
  scan_vectors<false>(step, s, dst, v + kVectors, n, b);
  scan_vectors<false>(step, s, dst, v + 2 * kVectors, n, d);
}

// a kernel's dynamic shared memory past 48 KiB, allowed on the current device
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
                           : cudaSuccess;
}

template <class Step>
int run(const void* xv, void* outv, const void* table, long long P, long long L, long long Q, cudaStream_t stream) {
  using T = typename Step::T;
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const uint8_t* tab = static_cast<const uint8_t*>(table);
  if (Step::kShared > 0 && (tab == nullptr || reinterpret_cast<uintptr_t>(tab) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Step::kShared;
  constexpr long long V = 16 / sizeof(T);
  const bool vectors = Q == 1 && L % V == 0 &&
                       ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (vectors) {
    const cudaError_t e = allow_shared(scan_rows<Step>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long grid = (P + kThreads - 1) / kThreads;
    scan_rows<Step><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(x, out, P, L, tab);
  } else {
    const cudaError_t e = allow_shared(scan_cols<Step>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long chains = P * Q;
    const long long grid = (chains + kThreads - 1) / kThreads;
    scan_cols<Step><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(x, out, chains, L, Q, tab);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: contiguous (P, L, Q) blocks on the device, scanned along L.
// type: 0 float16, 1 bfloat16 (op: 0 add, 1 multiply), 2 a 1-byte type
// stepped through table (65536 bytes on the device, 16-byte aligned; op
// unread).  Returns a cudaError_t.
int scan_launch(const void* x, void* out, const void* table, long long P, long long L, long long Q, int type,
                int op, void* stream) {
  if (P <= 0 || L <= 0 || Q <= 0 || op < 0 || op > 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (type * 2 + (type < 2 ? op : 0)) {
    case 0: return run<FloatStep<Half, false>>(x, out, table, P, L, Q, st);
    case 1: return run<FloatStep<Half, true>>(x, out, table, P, L, Q, st);
    case 2: return run<FloatStep<BFloat, false>>(x, out, table, P, L, Q, st);
    case 3: return run<FloatStep<BFloat, true>>(x, out, table, P, L, Q, st);
    case 4: return run<ByteStep>(x, out, table, P, L, Q, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

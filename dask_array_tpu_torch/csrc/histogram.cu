// Histogram and bincount counting kernel (dask_array_tpu_torch).
//
// Replaces dask_array_tpu/kernels/histogram.py::histogram (K2), the JAX
// package's counting step of histogram and bincount: numpy's counts of a
// flat array over sorted edges, half-open bins with the last bin closed,
// NaN and values outside the edges dropped, integer counts or the sums of
// float64 (complex128) weights.  On the TPU it is a compare-and-accumulate
// scan of 128K-element tiles against every edge, with two- and three-float
// splits because that chip has no f64 ALU.  None of that is carried over:
// this card compares f64 and int64 natively and its shared memory holds
// the bins.
//
// Bound: device memory.  The function must read the data (and weights)
// once and write one count a bin; a bin lookup is a few compares.  So the
// design reads the data once, with no host sync, at 16-byte loads:
//
//   Plan (kernels/histogram.py::launch_plan, a pure function of n, the
//   bins, the SM count and the types).  The flat data is cut into units of
//   16 bytes (VEC = 16 / sizeof(T) elements); a persistent grid of G blocks
//   (four of 256 threads an SM where their shared memory allows, two
//   otherwise, or one: a wide block of 1024 threads for counts, 32 warps as
//   four blocks have; fewer for small n) takes equal runs of units, block b
//   units [b*U/G, (b+1)*U/G), each thread UNROLL units at a time, a block's
//   width apart, so a warp's loads are adjacent: whole rounds of whole units run without per-value
//   checks, and all bins of a round are found before any is counted, so
//   the lookups of a thread overlap.  The rest of a run (a round's worth at
//   most), and all of unaligned data, goes a value a thread at a time.
//
//   Lookup.  Each value is converted in registers to numpy's comparison
//   type (np.result_type(data, edges)): f16/f32 compare in f32, f64 in f64,
//   int/int in int64 (uint64 when that is the result type), anything with
//   complex lexicographically on (real, imag).  -0.0 equals +0.0; NaN (a
//   NaN part) and values outside [e0, eN] are dropped; eN itself is the last
//   bin (no eN + 1, so eN = INT64_MAX is fine).  The edges are staged in
//   shared memory (read from global memory when they do not fit).  Each
//   block measures how far the edges lie from evenly spaced ones, in bins
//   (the margin: that distance plus the rounding of the guess, as
//   kernels/histogram.py::guess_margin computes it).  Under one bin, each
//   value's bin is guessed as (x - e0) * nb / (eN - e0) (its floor taken by
//   a magic-number add for float32): a guess further than the margin from
//   a bin edge is the bin, with no edge read; else it
//   is checked against the edges, one step up or down, and a binary search
//   of what is left if it was further off.  Otherwise (uneven edges) a
//   binary search.  Either way the result is the search's.  bincount
//   (direct mode) takes the value itself as the bin.
//
//   Counts.  Shared-memory privatized, in one of three modes that
//   launch_plan picks by the bins' bytes (counts 4, float64 sums 8,
//   complex128 sums 16 a bin):
//   - copies: one copy of the bins per warp where they fit (fewer, down to
//     one a block, for more bins), 32-bit shared atomics.  Weighted sums
//     take no float atomics: the 32 lanes of a warp group by bin
//     (__match_any_sync), the group's first lane adds the group's weights
//     (staged in shared memory, loaded 16 bytes at a time) in lane order
//     into its warp's float64 bins, the warps are summed in warp order and
//     the blocks' partials in a fixed order, so the same input gives the
//     same bits on every run.
//   - half: counts past one copy a block (65536 32-bit counts are 256 KB,
//     a block's budget 227 KB) in 16-bit shared counters, two a 32-bit
//     word: 65536 bins in 128 KB, one wide block an SM (32 warps, which
//     the lookups need to hide their latency).  A counter that wraps is
//     seen in atomicAdd's old word: its bin gets 65536 in the int64
//     output, and a low counter's carry into the high one is taken back
//     there (65535 where that carry wrapped the high counter itself, -1
//     otherwise).  The bins spread over a thread-block cluster's
//     distributed shared memory, measured against it, took 2.4 to 8.5
//     times as long (PERF.md).
//   - global: past those (weighted sums past one block's copies a warp,
//     counts past 116216 bins) 64-bit integer or float64 atomics in global
//     memory; the order of the float adds, and so the last bits of such
//     sums, may change from run to run.
//   Copies and half mode end as partials: each block writes its bins (its
//   16-bit counters) to partial[b], and a second launch sums the blocks of
//   each bin in a fixed order, a warp a bin, into the output (adding to
//   the wraps in half mode).

// Launches on the caller's stream; histogram_launch returns
// cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads a block: four an SM (64 registers a thread)
constexpr int kWarps = kThreads / 32;
constexpr int kWideThreads = 1024;  // a wide block: counts where one block fits an SM, as many warps as four

template <typename R>
struct Cplx {
  R re, im;
};

// -- the stored element types, read as (re, im) in a real type R ----------------

template <typename T>
struct Elem {
  template <typename R>
  static __device__ __forceinline__ R re(T v) { return static_cast<R>(v); }
  template <typename R>
  static __device__ __forceinline__ R im(T) { return R(0); }
};
template <>
struct Elem<__half> {
  template <typename R>
  static __device__ __forceinline__ R re(__half v) { return static_cast<R>(__half2float(v)); }
  template <typename R>
  static __device__ __forceinline__ R im(__half) { return R(0); }
};
template <>
struct Elem<float2> {
  template <typename R>
  static __device__ __forceinline__ R re(float2 v) { return static_cast<R>(v.x); }
  template <typename R>
  static __device__ __forceinline__ R im(float2 v) { return static_cast<R>(v.y); }
};
template <>
struct Elem<double2> {
  template <typename R>
  static __device__ __forceinline__ R re(double2 v) { return static_cast<R>(v.x); }
  template <typename R>
  static __device__ __forceinline__ R im(double2 v) { return static_cast<R>(v.y); }
};

// -- numpy's comparisons in the comparison type C ---------------------------------

template <typename C>
struct Ops {  // a real type: float, double, long long, unsigned long long
  using G = typename std::conditional<std::is_same<C, float>::value, float, double>::type;
  template <typename T>
  static __device__ __forceinline__ C make(T v) { return Elem<T>::template re<C>(v); }
  static __device__ __forceinline__ bool lt(C a, C b) { return a < b; }
  static __device__ __forceinline__ bool le(C a, C b) { return a <= b; }
  static __device__ __forceinline__ bool eq(C a, C b) { return a == b; }
  static __device__ __forceinline__ bool nan(C a) { return a != a; }
  static __device__ __forceinline__ G key(C a) { return static_cast<G>(a); }
};

template <typename R>
struct Ops<Cplx<R>> {  // lexicographic on (re, im); a NaN part is NaN
  using C = Cplx<R>;
  using G = double;
  template <typename T>
  static __device__ __forceinline__ C make(T v) {
    return C{Elem<T>::template re<R>(v), Elem<T>::template im<R>(v)};
  }
  static __device__ __forceinline__ bool lt(C a, C b) { return a.re < b.re || (a.re == b.re && a.im < b.im); }
  static __device__ __forceinline__ bool le(C a, C b) { return a.re < b.re || (a.re == b.re && a.im <= b.im); }
  static __device__ __forceinline__ bool eq(C a, C b) { return a.re == b.re && a.im == b.im; }
  static __device__ __forceinline__ bool nan(C a) { return a.re != a.re || a.im != a.im; }
  static __device__ __forceinline__ G key(C a) { return static_cast<G>(a.re); }
};

// The bin of v among edges E[0..nb] when the guess is not taken: numpy's
// searchsorted(E, v, "right") - 1 for e0 <= v < eN.  guess: the edges lie
// within a bin of evenly spaced ones, so the guess is checked first, one
// step up or down, and the search covers what is left.  Out of line: the
// unrolled loop keeps only the fast path (bin_of) inline.
template <typename C>
__device__ __noinline__ int search_bin(C v, const C* E, int nb, bool guess, typename Ops<C>::G g0,
                                       typename Ops<C>::G scale) {
  using O = Ops<C>;
  using G = typename O::G;
  int lo = 0, hi = nb;  // E[lo] <= v < E[hi]
  if (guess) {
    const G f = (O::key(v) - g0) * scale;
    const int g = f >= static_cast<G>(nb) ? nb - 1 : (f > G(0) ? static_cast<int>(f) : 0);
    const C a = E[g], b = E[g + 1];
    if (O::le(a, v) && O::lt(v, b)) return g;
    if (O::le(a, v)) {
      lo = g + 1;  // E[g + 1] <= v < eN, so g + 1 < nb
      if (g + 2 <= nb && O::lt(v, E[g + 2])) hi = g + 2;
    } else {  // v < E[g], so g >= 1
      hi = g;
      if (O::le(E[g - 1], v)) lo = g - 1;
    }
  }
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (O::le(E[mid], v)) lo = mid; else hi = mid;
  }
  return lo;
}

// The guess's bin g and g as a G, with r = f - g exact: g = floor(f) for a
// float32 f by the magic number 1.5 * 2^23 (round(f - 1/2), one add: no
// conversion unit; near an integer g may be one off, and then r leaves
// (margin, 1 - margin)); a float64 f by a conversion, clamped to [0, nb).
template <typename G>
struct Floor;
template <>
struct Floor<float> {
  static __device__ __forceinline__ int of(float f, int, float& gf) {
    const float t = (f - 0.5f) + 12582912.0f;
    gf = t - 12582912.0f;
    return __float_as_int(t) - 0x4B400000;
  }
};
template <>
struct Floor<double> {
  static __device__ __forceinline__ int of(double f, int nb, double& gf) {
    const int g = f >= static_cast<double>(nb) ? nb - 1 : (f > 0.0 ? static_cast<int>(f) : 0);
    gf = static_cast<double>(g);
    return g;
  }
};

constexpr int kSearch = -2;  // bin_of: the value needs search_bin

// The bin of v, with no branch: -1 for NaN and values outside [e0, eN], nb - 1
// for eN, the guess where it lies further than margin (in bins) from a bin
// edge, else kSearch.
template <typename C>
__device__ __forceinline__ int bin_of(C v, int nb, C e0, C eN, bool guess, typename Ops<C>::G g0,
                                      typename Ops<C>::G scale, typename Ops<C>::G margin) {
  using O = Ops<C>;
  using G = typename O::G;
  const bool out = O::nan(v) || O::lt(v, e0) || O::lt(eN, v);
  const G f = (O::key(v) - g0) * scale;
  G gf;
  const int g = Floor<G>::of(f, nb, gf);
  const G r = f - gf;
  const bool sure = guess && r > margin && r < G(1) - margin;
  return out ? -1 : (O::eq(v, eN) ? nb - 1 : (sure ? g : kSearch));
}

// runs: block b of G takes units [b*U/G, (b+1)*U/G)
__device__ __forceinline__ long long run_start(long long b, long long U, long long G) { return b * U / G; }

__device__ __forceinline__ size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

// the counting modes (kernels/histogram.py mirrors them)
constexpr int kCopies = 0;  // copies of the bins in each block's shared memory
constexpr int kHalf = 1;    // 16-bit counters, two a word, in each block
constexpr int kGlobal = 2;  // atomics into the output in global memory

// half mode: one count into bin's 16-bit counter (bins 2k and 2k + 1 are the
// low and high halves of word k).  A counter that wraps adds 65536 to its
// bin's int64 output; the carry a low counter spills into the high one is
// taken back there, and where the high counter held 0xFFFF that carry
// wrapped it: 65536 - 1 then.
__device__ __forceinline__ void half_add(unsigned* words, unsigned long long* out, int nb, int bin) {
  const int sh = (bin & 1) << 4;
  const unsigned old = atomicAdd(words + (bin >> 1), 1u << sh);
  if (((old >> sh) & 0xFFFFu) != 0xFFFFu) return;
  atomicAdd(out + bin, 65536ull);
  if (sh == 0 && bin + 1 < nb) {
    const long long back = (old >> 16) == 0xFFFFu ? 65535 : -1;
    atomicAdd(out + bin + 1, static_cast<unsigned long long>(back));
  }
}

// Shared memory: [the counts | staged edges | weight stage].  mode kCopies:
// copies copies of nb bins; kHalf: nb 16-bit counters, two a word; kGlobal:
// none.  A bin is 4 bytes (wk 0, counts), 8 (wk 1, float64 weights) or 16
// (wk 2, complex128 weights).  direct: bincount (T is long long, the value
// is the bin; C unused).  kWide: a block of 1024 threads, one an SM, for
// counts (wk 0) in modes kCopies and kHalf; else 256 threads, four an SM.
template <typename T, typename C, bool kDirect, bool kWide>
__global__ void __launch_bounds__(kWide ? kWideThreads : kThreads, kWide ? 1 : 4)
hist_main(const T* __restrict__ x, long long n, const C* __restrict__ edges, int nb,
          const double* __restrict__ w, int wk, void* __restrict__ out, void* __restrict__ partial,
          long long U, int mode, int copies, int edges_shared, int aligned) {
  using O = Ops<C>;
  using G = typename O::G;
  constexpr int kT = kWide ? kWideThreads : kThreads;
  constexpr int VEC = 16 / sizeof(T);
  // 16-byte units a thread loads before it counts them: 16 elements at most
  constexpr int kUnroll = sizeof(T) == 1 ? 1 : (sizeof(T) == 2 ? 2 : 4);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cb = wk == 0 ? 4 : (wk == 1 ? 8 : 16);
  const int words = (nb + 1) >> 1;  // half mode's words
  const size_t count_bytes = align16(mode == kCopies ? static_cast<size_t>(copies) * nb * cb
                                                     : (mode == kHalf ? static_cast<size_t>(words) * 4 : 0));
  unsigned* cnt = reinterpret_cast<unsigned*>(smem);
  double* wcnt = reinterpret_cast<double*>(smem);
  const C* E = edges;
  size_t off = count_bytes;
  if (!kDirect && edges_shared) {
    C* es = reinterpret_cast<C*>(smem + off);
    for (int i = tid; i <= nb; i += kT) es[i] = edges[i];
    E = es;
    off += align16(static_cast<size_t>(nb + 1) * sizeof(C));
  }
  double* stage = reinterpret_cast<double*>(smem + off);  // kWarps x 32 x wk doubles (weighted copies)
  for (size_t i = tid; i < count_bytes / 4; i += kT) cnt[i] = 0u;
  __syncthreads();

  C e0{}, eN{};
  G g0 = G(0), scale = G(0), margin = G(1);
  bool use_guess = false;
  if constexpr (!kDirect) {
    // the margin: the edges' largest distance from evenly spaced ones, in
    // bins, plus what the guess's rounding may add (guess_margin mirrors it)
    __shared__ unsigned long long s_dev;  // a non-negative double's bits: ordered as integers
    if (tid == 0) s_dev = 0ull;
    e0 = E[0];
    eN = E[nb];
    const double k0 = static_cast<double>(O::key(e0)), kn = static_cast<double>(O::key(eN));
    const double span = kn - k0;
    __syncthreads();
    if (span > 0.0 && span < 1e308) {
      double dev = 0.0;
      for (int i = tid; i <= nb; i += kT) {
        const double d = fabs(static_cast<double>(O::key(E[i])) - (k0 + span * (static_cast<double>(i) / nb)));
        dev = d <= dev ? dev : (d == d ? d : CUDART_INF);
      }
      atomicMax(&s_dev, static_cast<unsigned long long>(__double_as_longlong(dev)));
    }
    __syncthreads();
    const double eps = std::is_same<G, float>::value ? 0x1p-24 : 0x1p-53;
    const double m = __longlong_as_double(static_cast<long long>(s_dev)) * nb / span +
                     8.0 * eps * nb * (1.0 + (fabs(k0) + fabs(kn)) / span);
    g0 = O::key(e0);
    scale = static_cast<G>(nb) / (O::key(eN) - g0);
    use_guess = span > 0.0 && span < 1e308 && m < 1.0 && scale == scale && scale > G(0) &&
                scale < static_cast<G>(1e30) && nb < (1 << 22);  // Floor<float> holds to 2^22
    margin = use_guess ? static_cast<G>(m) : G(1);
  }
  const int mine = mode == kCopies ? warp % copies : 0;
  const long long u0 = run_start(blockIdx.x, U, gridDim.x);
  const long long u1 = run_start(blockIdx.x + 1, U, gridDim.x);

  auto lookup = [&](T value) -> int {  // the bin, or kSearch (see bin_of), or -1
    if constexpr (kDirect) {
      const long long b = static_cast<long long>(value);
      return b >= 0 && b < nb ? static_cast<int>(b) : -1;
    } else {
      return bin_of<C>(O::make(value), nb, e0, eN, use_guess, g0, scale, margin);
    }
  };
  auto resolve = [&](int bin, T value) -> int {  // the search where the guess was not taken
    if constexpr (kDirect) {
      return bin;
    } else {
      return bin == kSearch ? search_bin<C>(O::make(value), E, nb, use_guess, g0, scale) : bin;
    }
  };
  // count a value (valid: it exists) in bin, with its weight (re, im)
  // where weighted; the 32 lanes of a warp call it together
  auto count = [&](int bin, bool valid, double re, double im) {
    if (wk == 0) {
      if (bin < 0) return;
      if constexpr (kWide) {
        if (mode == kHalf) {
          half_add(cnt, reinterpret_cast<unsigned long long*>(out), nb, bin);
          return;
        }
      }
      if (mode == kCopies) atomicAdd(cnt + static_cast<size_t>(mine) * nb + bin, 1u);
      else atomicAdd(reinterpret_cast<unsigned long long*>(out) + bin, 1ull);
    } else if constexpr (!kWide) {
      if (mode == kGlobal) {  // past a copy a warp: float64 atomics in global memory
        if (bin < 0) return;
        double* o = reinterpret_cast<double*>(out) + static_cast<size_t>(bin) * wk;
        atomicAdd(o, re);
        if (wk == 2) atomicAdd(o + 1, im);
        return;
      }
      // the warp's lanes grouped by bin, each group added in lane order
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      double* st = stage + warp * 32 * wk;
      if (valid) {
        st[lane * wk] = re;
        if (wk == 2) st[lane * 2 + 1] = im;
      }
      __syncwarp();
      if (bin >= 0 && lane == __ffs(peers) - 1) {
        double sre = re, sim = im;
        for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
          const int l = __ffs(m) - 1;
          sre += st[l * wk];
          if (wk == 2) sim += st[l * 2 + 1];
        }
        double* mybins = wcnt + (static_cast<size_t>(warp) * nb + bin) * wk;
        mybins[0] += sre;
        if (wk == 2) mybins[1] += sim;
      }
      __syncwarp();
    }
  };

  // whole rounds: kUnroll 16-byte units a thread, kT apart, with no
  // per-value checks; every bin of a round is found before any is counted,
  // so a thread's lookups overlap.  A unit's weights (VEC * wk doubles, 16
  // bytes aligned: the wrapper clears aligned otherwise) load as 16-byte
  // vectors.
  constexpr long long kRound = static_cast<long long>(kT) * kUnroll;
  long long base = u0;
  for (; aligned && base + kRound <= u1 && (base + kRound) * VEC <= n; base += kRound) {
    T v[kUnroll][VEC];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + (base + k * kT + tid) * VEC));
      memcpy(&v[k][0], &raw, 16);
    }
    int bins[kUnroll][VEC];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) bins[k][j] = lookup(v[k][j]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) bins[k][j] = resolve(bins[k][j], v[k][j]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long first = (base + k * kT + tid) * VEC;  // the unit's first value
      if (wk == 0 || kWide) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) count(bins[k][j], true, 0.0, 0.0);
      } else if (wk == 2) {  // a complex128 weight a value: one 16-byte load each
        const double2* wv = reinterpret_cast<const double2*>(w) + first;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const double2 c = __ldg(wv + j);
          count(bins[k][j], true, c.x, c.y);
        }
      } else if constexpr (VEC % 2 == 0) {  // float64 weights, two a 16-byte load
        double2 wv[VEC / 2];
#pragma unroll
        for (int q = 0; q < VEC / 2; ++q) wv[q] = __ldg(reinterpret_cast<const double2*>(w + first) + q);
#pragma unroll
        for (int j = 0; j < VEC; ++j) count(bins[k][j], true, j % 2 ? wv[j / 2].y : wv[j / 2].x, 0.0);
      } else {  // one 16-byte value, one float64 weight
        count(bins[k][0], true, w[first], 0.0);
      }
    }
  }
  // the rest of the run (all of it for unaligned data): a value a thread
  const long long end = u1 * VEC < n ? u1 * VEC : n;
  for (long long e = base * VEC; e < end; e += kT) {
    const long long idx = e + tid;
    const bool valid = idx < end;
    T value;
    if (valid) memcpy(&value, x + idx, sizeof(T));
    else memset(&value, 0, sizeof(T));
    const double re = valid && wk > 0 ? w[wk * idx] : 0.0;
    const double im = valid && wk == 2 ? w[2 * idx + 1] : 0.0;
    count(valid ? resolve(lookup(value), value) : -1, valid, re, im);
  }
  if (mode == kGlobal) return;
  __syncthreads();
  if (mode == kHalf) {  // the block's words into partial[b]: the finish takes their halves apart
    for (int k = tid; k < words; k += kT) {
      reinterpret_cast<unsigned*>(partial)[static_cast<size_t>(blockIdx.x) * words + k] = cnt[k];
    }
    return;
  }
  // the block's copies, in copy order, into partial[b]
  for (int bin = tid; bin < nb; bin += kT) {
    if (wk == 0) {
      unsigned s = 0;
      for (int c = 0; c < copies; ++c) s += cnt[static_cast<size_t>(c) * nb + bin];
      reinterpret_cast<unsigned*>(partial)[static_cast<size_t>(blockIdx.x) * nb + bin] = s;
    } else {
      for (int part = 0; part < wk; ++part) {
        double s = wcnt[static_cast<size_t>(bin) * wk + part];
        for (int c = 1; c < copies; ++c) s += wcnt[(static_cast<size_t>(c) * nb + bin) * wk + part];
        reinterpret_cast<double*>(partial)[(static_cast<size_t>(blockIdx.x) * nb + bin) * wk + part] = s;
      }
    }
  }
}

// Launch 2: one warp an output item (a bin's count, or a real or imaginary
// part of its sum); lane l adds the partials of blocks l, l + 32, ... in
// order, then the lanes are added in a fixed tree, so the order is the
// same on every run.  half: the partials are the blocks' 16-bit counters,
// two a word, added to the output (which holds their wraps).
__global__ void __launch_bounds__(kThreads)
hist_finish(const void* __restrict__ partial, void* __restrict__ out, int nb, int blocks, int wk, int half) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long items = static_cast<long long>(nb) * (wk == 0 ? 1 : wk);
  if (i >= items) return;  // a whole warp
  if (wk == 0) {
    const unsigned* p = reinterpret_cast<const unsigned*>(partial);
    long long s = 0;
    if (half) {
      const size_t words = (static_cast<size_t>(nb) + 1) >> 1;
      const int sh = static_cast<int>(i & 1) << 4;
      for (int b = lane; b < blocks; b += 32) s += (p[b * words + (i >> 1)] >> sh) & 0xFFFFu;
    } else {
      for (int b = lane; b < blocks; b += 32) s += p[static_cast<size_t>(b) * nb + i];
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    long long* o = reinterpret_cast<long long*>(out);
    if (lane == 0) o[i] = (half ? o[i] : 0) + s;
  } else {
    const double* p = reinterpret_cast<const double*>(partial);
    const size_t row = static_cast<size_t>(nb) * wk;
    double s = 0.0;
    for (int b = lane; b < blocks; b += 32) s += p[b * row + i];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) reinterpret_cast<double*>(out)[i] = s;
  }
}

template <typename T, typename C, bool kDirect>
cudaError_t launch(const void* x, long long n, const void* edges, int nb, const double* w, int wk, void* out,
                   void* partial, long long U, int threads, int blocks, int mode, int copies, int edges_shared,
                   int aligned, size_t smem, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (U != (n + VEC - 1) / VEC) return cudaErrorInvalidValue;
  auto kernel = threads == kWideThreads ? hist_main<T, C, kDirect, true> : hist_main<T, C, kDirect, false>;
  if (smem > 47 * 1024) {  // past 48 KB with the static share: the opt-in
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, st>>>(static_cast<const T*>(x), n, static_cast<const C*>(edges), nb, w, wk, out,
                                        partial, U, mode, copies, edges_shared, aligned);
  return cudaGetLastError();
}

// data codes: 0 bool, 1 uint8, 2 int8, 3 int16, 4 uint16, 5 int32, 6 uint32,
// 7 int64, 8 uint64, 9 float16, 10 float32, 11 float64, 12 complex64,
// 13 complex128; comparison codes: 0 float32, 1 float64, 2 int64, 3 uint64,
// 4 complex64, 5 complex128 (kernels/histogram.py mirrors both, and its
// KERNEL_PAIRS the pairs instantiated here: a complex comparison takes
// complex data, the wrapper casting real data to it)
template <typename C>
cudaError_t by_data(int tcode, const void* x, long long n, const void* edges, int nb, const double* w, int wk,
                    void* out, void* partial, long long U, int threads, int blocks, int mode, int copies,
                    int edges_shared, int aligned, size_t smem, cudaStream_t st) {
#define HIST_ARGS x, n, edges, nb, w, wk, out, partial, U, threads, blocks, mode, copies, edges_shared, aligned, smem, st
#define HIST_CASE(code, T) \
  case code:               \
    return launch<T, C, false>(HIST_ARGS);
  constexpr bool kF32 = std::is_same<C, float>::value;
  constexpr bool kF64 = std::is_same<C, double>::value;
  constexpr bool kI64 = std::is_same<C, long long>::value;
  constexpr bool kU64 = std::is_same<C, unsigned long long>::value;
  constexpr bool kC64 = std::is_same<C, Cplx<float>>::value;
  constexpr bool kC128 = std::is_same<C, Cplx<double>>::value;
  if constexpr (kC64) {
    if (tcode == 12) return launch<float2, C, false>(HIST_ARGS);
  } else if constexpr (kC128) {
    if (tcode == 12) return launch<float2, C, false>(HIST_ARGS);
    if (tcode == 13) return launch<double2, C, false>(HIST_ARGS);
  } else if constexpr (kF32) {  // data that float32 holds exactly
    switch (tcode) {
      HIST_CASE(0, unsigned char) HIST_CASE(1, unsigned char) HIST_CASE(2, signed char) HIST_CASE(3, short)
      HIST_CASE(4, unsigned short) HIST_CASE(9, __half) HIST_CASE(10, float)
      default: break;
    }
  } else if constexpr (kF64) {
    switch (tcode) {
      HIST_CASE(0, unsigned char) HIST_CASE(1, unsigned char) HIST_CASE(2, signed char) HIST_CASE(3, short)
      HIST_CASE(4, unsigned short) HIST_CASE(5, int) HIST_CASE(6, unsigned) HIST_CASE(7, long long)
      HIST_CASE(8, unsigned long long) HIST_CASE(9, __half) HIST_CASE(10, float) HIST_CASE(11, double)
      default: break;
    }
  } else if constexpr (kI64) {
    switch (tcode) {
      HIST_CASE(0, unsigned char) HIST_CASE(1, unsigned char) HIST_CASE(2, signed char) HIST_CASE(3, short)
      HIST_CASE(4, unsigned short) HIST_CASE(5, int) HIST_CASE(6, unsigned) HIST_CASE(7, long long)
      default: break;
    }
  } else if constexpr (kU64) {
    switch (tcode) {
      HIST_CASE(0, unsigned char) HIST_CASE(1, unsigned char) HIST_CASE(4, unsigned short) HIST_CASE(6, unsigned)
      HIST_CASE(8, unsigned long long)
      default: break;
    }
  }
#undef HIST_CASE
#undef HIST_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: n elements of data code tcode; edges: nb + 1 sorted values of
// comparison code ccode (ignored when direct: x is int64 and its values are
// the bins); w: n float64 (wk 1) or complex128 (wk 2) weights or null (wk
// 0); out: nb int64 counts, float64 or complex128 sums (zeroed by the caller
// in modes kHalf and kGlobal); partial: scratch for the blocks' partials
// (kCopies: nb bins of 4, 8 or 16 bytes a block; kHalf: (nb + 1) / 2 words
// a block; none for kGlobal).  The plan (units, threads, blocks, mode,
// copies, edges_shared, smem) comes from kernels/histogram.py::launch_plan;
// aligned: x is 16-byte aligned.  All on the device.  Returns a cudaError_t.
int histogram_launch(const void* x, long long n, int tcode, int ccode, const void* edges, long long nb, int direct,
                     const double* w, int wk, void* out, void* partial, long long units, int threads,
                     long long blocks, int mode, int copies, int edges_shared, int aligned, long long smem,
                     void* stream) {
  if (n < 0 || nb <= 0 || nb > 2147483646LL || blocks <= 0 || blocks > 2147483647LL || wk < 0 || wk > 2 ||
      (threads != kThreads && threads != kWideThreads) || (threads == kWideThreads && (wk != 0 || mode == kGlobal)) ||
      mode < kCopies || mode > kGlobal || smem < 0 || smem > 227 * 1024 || (wk > 0 && w == nullptr) ||
      (mode != kGlobal && partial == nullptr) ||
      (mode == kCopies && (copies < 1 || copies > kWarps || (wk > 0 && copies != kWarps))) ||
      (mode == kHalf && threads != kWideThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbi = static_cast<int>(nb);
  const int bi = static_cast<int>(blocks);
  const size_t sm = static_cast<size_t>(smem);
  cudaError_t err;
  if (direct) {
    if (tcode != 7) return static_cast<int>(cudaErrorInvalidValue);
    err = launch<long long, long long, true>(x, n, nullptr, nbi, w, wk, out, partial, units, threads, bi, mode,
                                             copies, 0, aligned, sm, st);
  } else {
#define HIST_BY(code, C)                                                                                          \
  case code:                                                                                                      \
    err = by_data<C>(tcode, x, n, edges, nbi, w, wk, out, partial, units, threads, bi, mode, copies, edges_shared, \
                     aligned, sm, st);                                                                             \
    break;
    switch (ccode) {
      HIST_BY(0, float) HIST_BY(1, double) HIST_BY(2, long long) HIST_BY(3, unsigned long long)
      HIST_BY(4, Cplx<float>) HIST_BY(5, Cplx<double>)
      default: err = cudaErrorInvalidValue;
    }
#undef HIST_BY
  }
  if (err != cudaSuccess || mode == kGlobal) return static_cast<int>(err);
  const long long warps = nb * (wk == 0 ? 1 : wk);  // one an output item
  hist_finish<<<static_cast<unsigned>((warps + kWarps - 1) / kWarps), kThreads, 0, st>>>(partial, out, nbi, bi, wk,
                                                                                         mode == kHalf);
  return static_cast<int>(cudaGetLastError());
}

const char* histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

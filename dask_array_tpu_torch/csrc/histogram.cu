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
//
//   Patterns (counts of float16 or bfloat16 data, float32 or float64
//   comparisons).  With 8 or 11 significant bits a large share of 2-byte
//   values sits exactly on an evenly spaced edge, where the guess above
//   cannot decide and the value goes through the search: bf16 took twice
//   f32's time for half its bytes (PERF.md).  But a 2-byte float has only
//   65536 bit patterns, so this route looks no value up.  Each block maps
//   a value's 16 bits to an order key (monotone in the value, -0 next to
//   +0, NaN outside), drops keys outside the window [the least value >=
//   e0, the greatest <= eN] that every block finds by a binary search over
//   the keys, and counts the key in shared memory: 32-bit counters where
//   the window fits the block's share (58108 keys; [-4, 4] in bfloat16 is
//   33026), else 16-bit counters two a word with half mode's wraps (65536
//   keys in 128 KB; a wrap adds 65536 to the key's bin at once).  One wide
//   block an SM.  The finish takes each key's count over the blocks and
//   adds it to the key's bin, found once a key by the search, numpy's
//   comparison in the comparison type.  The main loop's work depends on
//   neither the bins nor the edges' spacing: 2^26 bf16 values take 0.091
//   ms at 256 bins and 0.095 ms at 65536 on the H100, 44 % of the bytes'
//   bound.  The loads' latency is not what is left (loading the next round
//   while counting this one gained 1 %, PERF.md); the one shared atomic a
//   value is the likely limit.

//   Bytes (counts of 1-byte data: torch's float8 types, and ml_dtypes'
//   narrow types held as uint8 bit patterns).  A byte has 256 patterns, so
//   this route neither decodes nor compares a value.  One block of 512
//   threads an SM reads its block's run of the data in 16-byte loads and
//   counts each byte in the thread's own 256 8-bit counters, four to a
//   32-bit shared word, word k of thread t at [k][t] (128 KB a block): a
//   thread only ever touches its own bank and no two threads meet on a
//   word, however the data is skewed.  The design before, a shared atomic
//   a byte into 256 counters a warp, serialized the lanes that met on one
//   pattern, which float8 and int4 data do: 11-19 % of the bound, 0.10-0.29
//   ms at 2^26 bytes on the H100, moving between calls.  Now every input
//   takes 0.059-0.060 ms (34 % of the bound, 30 runs within 3 %), one
//   shared add a byte being what is left (count_byte; PERF.md).  Every 240
//   bytes a thread (before any counter can pass 255) the block flushes the
//   counters into its 32-bit totals, a warp four words of every thread,
//   summing bytes in 16-bit halves and the lanes with __reduce_add_sync.
//   (One atomic a distinct pattern a warp, by __match_any_sync, would
//   still serialize the lanes of a pattern and add the match to every
//   byte.)  The blocks' totals go to partials; the finish (a thread a
//   pattern) adds them in block order and puts the pattern's count into
//   its bin, found once a pattern: the caller's 256-entry table gives each
//   pattern's value in the comparison type (NaN and values outside [e0,
//   eN] dropped, eN in the last bin, numpy's searchsorted otherwise), so
//   one kernel serves every 1-byte format.

// Launches on the caller's stream; histogram_launch and
// histogram_bytes_launch return cudaGetLastError().

#include <cuda_bf16.h>
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
struct Elem<__nv_bfloat16> {
  template <typename R>
  static __device__ __forceinline__ R re(__nv_bfloat16 v) { return static_cast<R>(__bfloat162float(v)); }
  template <typename R>
  static __device__ __forceinline__ R im(__nv_bfloat16) { return R(0); }
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
constexpr int kPattern = 3;  // counts of 2-byte float data by bit pattern (hist_patterns)

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

// -- the pattern route: counts of 2-byte float data -------------------------------

// The order key of a 16-bit float pattern p: monotone in its value over the
// non-NaN patterns (-0 just below +0), NaN patterns beyond -inf and +inf.
__device__ __forceinline__ unsigned pattern_key(unsigned p) { return p ^ (((p >> 15) * 0x7FFFu) | 0x8000u); }

// pattern_key's inverse
__device__ __forceinline__ unsigned pattern_of(unsigned k) { return k ^ ((((k >> 15) ^ 1u) * 0x7FFFu) | 0x8000u); }

template <typename T>
struct Inf16;  // +inf's pattern
template <>
struct Inf16<__half> {
  static constexpr unsigned kBits = 0x7C00u;
};
template <>
struct Inf16<__nv_bfloat16> {
  static constexpr unsigned kBits = 0x7F80u;
};

// the value of key k in the comparison type C
template <typename T, typename C>
__device__ __forceinline__ C key_value(unsigned k) {
  const unsigned short p = static_cast<unsigned short>(pattern_of(k));
  T v;
  memcpy(&v, &p, sizeof(T));
  return Ops<C>::make(v);
}

// The keys of the values in [e0, eN]: [lo, lo + span), span <= 0 for none
// (a NaN edge, or no 2-byte value between the edges).  Two binary searches
// over the keys of -inf .. +inf, whose values do not decrease.
// kernels/histogram.py::key_window mirrors it.
template <typename T, typename C>
__device__ __forceinline__ void key_window(C e0, C eN, unsigned& lo, int& span) {
  using O = Ops<C>;
  const unsigned kmin = pattern_key(Inf16<T>::kBits | 0x8000u), kend = pattern_key(Inf16<T>::kBits) + 1;
  unsigned a = kmin, b = kend;  // the first key whose value is >= e0
  while (a < b) {
    const unsigned m = (a + b) >> 1;
    if (O::le(e0, key_value<T, C>(m))) b = m; else a = m + 1;
  }
  lo = a;
  a = kmin;
  b = kend;  // the first key whose value is > eN
  while (a < b) {
    const unsigned m = (a + b) >> 1;
    if (O::lt(eN, key_value<T, C>(m))) b = m; else a = m + 1;
  }
  span = static_cast<int>(a) - static_cast<int>(lo);
}

// The bin of key k in the window: numpy's (eN itself in the last bin).
template <typename T, typename C>
__device__ __noinline__ int key_bin(unsigned k, const C* E, int nb) {
  const C v = key_value<T, C>(k);
  return Ops<C>::eq(v, E[nb]) ? nb - 1 : search_bin<C>(v, E, nb, false, 0, 0);
}

// One count into key d's counter of the window [lo, lo + span): 32-bit
// counters (kWide32), or 16-bit ones, two a word, whose wraps go to the
// key's bin in the output at once (half_add's rule: the carry a low counter
// spills into the high one is taken back from the high key's bin).
template <typename T, typename C, bool kWide32>
__device__ __forceinline__ void key_add(unsigned* cnt, unsigned d, unsigned span, unsigned lo, const C* E, int nb,
                                        unsigned long long* out) {
  if constexpr (kWide32) {
    atomicAdd(cnt + d, 1u);
  } else {
    const int sh = (d & 1) << 4;
    const unsigned old = atomicAdd(cnt + (d >> 1), 1u << sh);
    if (((old >> sh) & 0xFFFFu) != 0xFFFFu) return;
    atomicAdd(out + key_bin<T, C>(lo + d, E, nb), 65536ull);
    if (sh == 0 && d + 1 < span) {
      const long long back = (old >> 16) == 0xFFFFu ? 65535 : -1;
      atomicAdd(out + key_bin<T, C>(lo + d + 1, E, nb), static_cast<unsigned long long>(back));
    }
  }
}

// A block's run of 16-byte units (8 values each): kPatternUnroll units a
// thread at a time, a block's width apart, then the rest a value a thread.
constexpr int kPatternUnroll = 4;

template <typename T, typename C, bool kWide32>
__device__ __forceinline__ void count_keys(const unsigned short* __restrict__ x, long long n, long long u0,
                                           long long u1, int aligned, unsigned* cnt, unsigned lo, unsigned span,
                                           const C* E, int nb, unsigned long long* out) {
  const int tid = threadIdx.x;
  auto count = [&](unsigned p) {
    const unsigned d = pattern_key(p) - lo;  // keys below lo wrap past span
    if (d < span) key_add<T, C, kWide32>(cnt, d, span, lo, E, nb, out);
  };
  constexpr long long kRound = static_cast<long long>(kWideThreads) * kPatternUnroll;
  long long base = u0;
  for (; aligned && base + kRound <= u1 && (base + kRound) * 8 <= n; base += kRound) {
    uint4 v[kPatternUnroll];
#pragma unroll
    for (int k = 0; k < kPatternUnroll; ++k) v[k] = __ldg(reinterpret_cast<const uint4*>(x) + base + k * kWideThreads + tid);
#pragma unroll
    for (int k = 0; k < kPatternUnroll; ++k) {
      const unsigned w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        count(w[j] & 0xFFFFu);
        count(w[j] >> 16);
      }
    }
  }
  const long long end = u1 * 8 < n ? u1 * 8 : n;
  for (long long e = base * 8 + tid; e < end; e += kWideThreads) count(x[e]);
}

// The main launch of the pattern route: one wide block an SM, block b
// counting units [b*U/G, (b+1)*U/G) into the window's counters in its
// shared memory (cap 32-bit counters fit), then writing them to
// partial[b * cap ...].
template <typename T, typename C>
__global__ void __launch_bounds__(kWideThreads, 1)
hist_patterns(const unsigned short* __restrict__ x, long long n, const C* __restrict__ edges, int nb,
              unsigned long long* __restrict__ out, unsigned* __restrict__ partial, long long U, int cap,
              int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* cnt = reinterpret_cast<unsigned*>(smem);
  unsigned lo;
  int span;
  key_window<T, C>(edges[0], edges[nb], lo, span);
  if (span <= 0) return;  // every block and the finish see the same window
  const bool wide = span <= cap;
  const int words = wide ? span : (span + 1) >> 1;
  for (int i = threadIdx.x; i < words; i += kWideThreads) cnt[i] = 0u;
  __syncthreads();
  const long long u0 = run_start(blockIdx.x, U, gridDim.x), u1 = run_start(blockIdx.x + 1, U, gridDim.x);
  if (wide) {
    count_keys<T, C, true>(x, n, u0, u1, aligned, cnt, lo, span, edges, nb, out);
  } else {
    count_keys<T, C, false>(x, n, u0, u1, aligned, cnt, lo, span, edges, nb, out);
  }
  __syncthreads();
  unsigned* mine = partial + static_cast<size_t>(blockIdx.x) * cap;
  for (int i = threadIdx.x; i < words; i += kWideThreads) mine[i] = cnt[i];
}

// The finish: a thread a key, its counts over the blocks added in order,
// then into its bin of the (zeroed) output.
template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
pattern_finish(const unsigned* __restrict__ partial, const C* __restrict__ edges, int nb, int blocks, int cap,
               unsigned long long* __restrict__ out) {
  unsigned lo;
  int span;
  key_window<T, C>(edges[0], edges[nb], lo, span);
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= span) return;
  const bool wide = span <= cap;
  const unsigned* p = partial + (wide ? d : d >> 1);
  const int sh = wide ? 0 : (d & 1) << 4;
  const unsigned mask = wide ? 0xFFFFFFFFu : 0xFFFFu;
  unsigned long long s = 0;
#pragma unroll 4
  for (int b = 0; b < blocks; ++b) s += (p[static_cast<size_t>(b) * cap] >> sh) & mask;
  if (s) atomicAdd(out + key_bin<T, C>(lo + d, edges, nb), s);
}

template <typename T, typename C>
cudaError_t launch_patterns(const void* x, long long n, const void* edges, int nb, void* out, void* partial,
                            long long U, int blocks, int aligned, size_t smem, cudaStream_t st) {
  if (U != (n + 7) / 8) return cudaErrorInvalidValue;
  const int cap = static_cast<int>(smem / 4);
  const cudaError_t err = cudaFuncSetAttribute(hist_patterns<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const C* e = static_cast<const C*>(edges);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  unsigned* p = static_cast<unsigned*>(partial);
  hist_patterns<T, C><<<blocks, kWideThreads, smem, st>>>(static_cast<const unsigned short*>(x), n, e, nb, o, p, U,
                                                          cap, aligned);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return launched;
  pattern_finish<T, C><<<65536 / kThreads, kThreads, 0, st>>>(p, e, nb, blocks, cap, o);
  return cudaGetLastError();
}

template <typename C>
cudaError_t patterns_by_data(int tcode, const void* x, long long n, const void* edges, int nb, void* out,
                             void* partial, long long U, int blocks, int aligned, size_t smem, cudaStream_t st) {
  if (tcode == 9) return launch_patterns<__half, C>(x, n, edges, nb, out, partial, U, blocks, aligned, smem, st);
  if (tcode == 14) return launch_patterns<__nv_bfloat16, C>(x, n, edges, nb, out, partial, U, blocks, aligned, smem, st);
  return cudaErrorInvalidValue;
}

// -- the byte route: counts of 1-byte data by pattern -------------------------------

constexpr int kByteThreads = 512;                       // one block an SM, 16 warps
constexpr int kByteWords = 64;                          // a thread's 256 8-bit counters, four a word
constexpr int kByteUnroll = 3;                          // 16-byte units a thread loads before counting
constexpr int kByteFlushRounds = 5;                     // rounds a thread counts between flushes
constexpr int kByteFlushBytes = 16 * kByteUnroll * kByteFlushRounds;  // bytes a thread counts between flushes
static_assert(kByteFlushBytes <= 255, "an 8-bit counter could pass 255 between flushes");
static_assert(kByteWords % (kByteThreads / 32) == 0, "a flush gives each warp whole words");
constexpr size_t kByteShared = static_cast<size_t>(kByteWords) * kByteThreads * 4;  // 128 KB of counters

// One byte into the calling thread's counters: pattern b is byte b >> 6 of
// word b & 63, and word k of thread t lies at cnt[k * kByteThreads + t], so
// a thread only ever touches its own bank and no two threads meet on a word.
// The add is a shared atomic whose result is not read: it needs no
// atomicity, but it leaves the thread free, where a plain read-modify-write
// waits for its load before the next byte's (the addresses may alias):
// 0.073 ms at 2^26 bytes that way, against 0.060 (PERF.md).
__device__ __forceinline__ void count_byte(unsigned* mine, unsigned b) {
  atomicAdd(mine + (b & 63u) * kByteThreads, 1u << ((b >> 3) & 24u));
}

// Every thread's 8-bit counters into the block's 32-bit totals, and back to
// 0: warp w takes words [4w, 4w + 4) of all the threads, a lane 16 words of
// each, summing its bytes two at a time in 16-bit halves (at most 16 * 255),
// then the warp's 32 lanes with __reduce_add_sync.  Called by every thread
// of the block, at block-uniform points.
__device__ __forceinline__ void flush_bytes(unsigned* cnt, unsigned* tot) {
  constexpr int kPerWarp = kByteWords / (kByteThreads / 32);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int k = warp * kPerWarp + i;
    unsigned* row = cnt + k * kByteThreads;
    unsigned even = 0, odd = 0;  // bytes 0 and 2, 1 and 3 of the word
#pragma unroll
    for (int j = lane; j < kByteThreads; j += 32) {
      const unsigned w = row[j];
      row[j] = 0u;
      even += w & 0x00FF00FFu;
      odd += (w >> 8) & 0x00FF00FFu;
    }
    const unsigned b0 = __reduce_add_sync(0xFFFFFFFFu, even & 0xFFFFu);
    const unsigned b1 = __reduce_add_sync(0xFFFFFFFFu, odd & 0xFFFFu);
    const unsigned b2 = __reduce_add_sync(0xFFFFFFFFu, even >> 16);
    const unsigned b3 = __reduce_add_sync(0xFFFFFFFFu, odd >> 16);
    if (lane == 0) {
      tot[k] += b0;
      tot[64 + k] += b1;
      tot[128 + k] += b2;
      tot[192 + k] += b3;
    }
  }
  __syncthreads();
}

// Block b counts the bytes of units [b*U/G, (b+1)*U/G) (16 bytes each) into
// its threads' private 8-bit counters, flushing them into its 32-bit totals
// every kByteFlushBytes bytes a thread, then writes the totals to
// partial[b * 256 ...].
__global__ void __launch_bounds__(kByteThreads)
hist_bytes(const unsigned char* __restrict__ x, long long n, long long U, int aligned,
           unsigned* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char byte_smem[];
  unsigned* cnt = reinterpret_cast<unsigned*>(byte_smem);
  __shared__ unsigned tot[256];
  for (int i = threadIdx.x; i < kByteWords * kByteThreads; i += kByteThreads) cnt[i] = 0u;
  if (threadIdx.x < 256) tot[threadIdx.x] = 0u;
  unsigned* mine = cnt + threadIdx.x;
  const long long u0 = run_start(blockIdx.x, U, gridDim.x), u1 = run_start(blockIdx.x + 1, U, gridDim.x);
  const long long whole = n / 16;  // units whose 16 bytes all lie in the data
  constexpr long long kRound = static_cast<long long>(kByteThreads) * kByteUnroll;
  long long base = u0;
  while (aligned && base + kRound <= u1 && base + kRound <= whole) {
    for (int r = 0; r < kByteFlushRounds && base + kRound <= u1 && base + kRound <= whole; ++r, base += kRound) {
      uint4 v[kByteUnroll];
#pragma unroll
      for (int k = 0; k < kByteUnroll; ++k) {
        v[k] = __ldg(reinterpret_cast<const uint4*>(x) + base + k * kByteThreads + threadIdx.x);
      }
#pragma unroll
      for (int k = 0; k < kByteUnroll; ++k) {
        const unsigned w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          count_byte(mine, w[j] & 0xFFu);
          count_byte(mine, (w[j] >> 8) & 0xFFu);
          count_byte(mine, (w[j] >> 16) & 0xFFu);
          count_byte(mine, w[j] >> 24);
        }
      }
    }
    flush_bytes(cnt, tot);
  }
  // the rest of the run (all of it for unaligned data) a byte a thread, in
  // steps of kByteFlushBytes bytes a thread
  const long long end = u1 * 16 < n ? u1 * 16 : n;
  constexpr long long kStep = static_cast<long long>(kByteThreads) * kByteFlushBytes;
  for (long long s = base * 16; s < end; s += kStep) {
    const long long stop = s + kStep < end ? s + kStep : end;
    for (long long e = s + threadIdx.x; e < stop; e += kByteThreads) count_byte(mine, x[e]);
    flush_bytes(cnt, tot);
  }
  __syncthreads();
  if (threadIdx.x < 256) partial[static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x] = tot[threadIdx.x];
}

// The finish: thread p adds pattern p's counts over the blocks in order and
// puts them into the bin of table[p], its value in the comparison type C.
template <typename C>
__global__ void __launch_bounds__(256)
bytes_finish(const unsigned* __restrict__ partial, int blocks, const C* __restrict__ table,
             const C* __restrict__ edges, int nb, unsigned long long* __restrict__ out) {
  using O = Ops<C>;
  const int p = threadIdx.x;
  unsigned long long s = 0;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * 256 + p];
  if (s == 0) return;
  const C v = table[p], e0 = edges[0], eN = edges[nb];
  if (O::nan(v) || O::lt(v, e0) || O::lt(eN, v)) return;
  const int bin = O::eq(v, eN) ? nb - 1 : search_bin<C>(v, edges, nb, false, 0, 0);
  atomicAdd(out + bin, s);
}

template <typename C>
cudaError_t launch_bytes(const void* x, long long n, const void* table, const void* edges, int nb, void* out,
                         void* partial, long long U, int blocks, int aligned, cudaStream_t st) {
  if (U != (n + 15) / 16) return cudaErrorInvalidValue;
  unsigned* p = static_cast<unsigned*>(partial);
  const cudaError_t err = cudaFuncSetAttribute(hist_bytes, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kByteShared));
  if (err != cudaSuccess) return err;
  hist_bytes<<<blocks, kByteThreads, kByteShared, st>>>(static_cast<const unsigned char*>(x), n, U, aligned, p);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return launched;
  bytes_finish<C><<<1, 256, 0, st>>>(p, blocks, static_cast<const C*>(table), static_cast<const C*>(edges), nb,
                                     static_cast<unsigned long long*>(out));
  return cudaGetLastError();
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
// 13 complex128, 14 bfloat16; comparison codes: 0 float32, 1 float64, 2 int64, 3 uint64,
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
      HIST_CASE(4, unsigned short) HIST_CASE(9, __half) HIST_CASE(10, float) HIST_CASE(14, __nv_bfloat16)
      default: break;
    }
  } else if constexpr (kF64) {
    switch (tcode) {
      HIST_CASE(0, unsigned char) HIST_CASE(1, unsigned char) HIST_CASE(2, signed char) HIST_CASE(3, short)
      HIST_CASE(4, unsigned short) HIST_CASE(5, int) HIST_CASE(6, unsigned) HIST_CASE(7, long long)
      HIST_CASE(8, unsigned long long) HIST_CASE(9, __half) HIST_CASE(10, float) HIST_CASE(11, double)
      HIST_CASE(14, __nv_bfloat16)
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
// a block; none for kGlobal; kPattern: smem bytes a block).  The plan
// (units, threads, blocks, mode, copies, edges_shared, smem) comes from
// kernels/histogram.py::launch_plan; aligned: x is 16-byte aligned.  mode
// kPattern takes counts (wk 0) of float16 or bfloat16 data (tcode 9, 14)
// against float32 or float64 edges, a 1024-thread block an SM and at least
// 128 KB (16-bit counters of every key).  All on the device.  Returns a
// cudaError_t.
int histogram_launch(const void* x, long long n, int tcode, int ccode, const void* edges, long long nb, int direct,
                     const double* w, int wk, void* out, void* partial, long long units, int threads,
                     long long blocks, int mode, int copies, int edges_shared, int aligned, long long smem,
                     void* stream) {
  if (n < 0 || nb <= 0 || nb > 2147483646LL || blocks <= 0 || blocks > 2147483647LL || wk < 0 || wk > 2 ||
      (threads != kThreads && threads != kWideThreads) || (threads == kWideThreads && (wk != 0 || mode == kGlobal)) ||
      mode < kCopies || mode > kPattern || smem < 0 || smem > 227 * 1024 || (wk > 0 && w == nullptr) ||
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
  if (mode == kPattern) {
    if (direct || wk != 0 || threads != kWideThreads || smem < 65536 / 2 * 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (ccode == 0) return static_cast<int>(patterns_by_data<float>(tcode, x, n, edges, nbi, out, partial, units, bi,
                                                                    aligned, sm, st));
    if (ccode == 1) return static_cast<int>(patterns_by_data<double>(tcode, x, n, edges, nbi, out, partial, units, bi,
                                                                     aligned, sm, st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

// The byte route: the counts of n bytes x (1-byte bit patterns) over edges
// (nb + 1 sorted values of comparison code ccode: 0 float, 1 double, 2 int64,
// 3 uint64), each pattern's value given by table (256 values of the same
// type; NaN for a NaN pattern).  out: nb int64 counts, zeroed by the caller;
// partial: blocks * 256 32-bit words of scratch.  The plan (units, blocks)
// comes from kernels/histogram.py::launch_plan (mode BYTES); aligned: x is
// 16-byte aligned.  Returns a cudaError_t.
int histogram_bytes_launch(const void* x, long long n, int ccode, const void* table, const void* edges,
                           long long nb, void* out, void* partial, long long units, long long blocks, int aligned,
                           void* stream) {
  if (n < 0 || nb <= 0 || nb > 2147483646LL || blocks <= 0 || blocks > 2147483647LL || table == nullptr ||
      edges == nullptr || partial == nullptr || ((n + 15) / 16 + blocks - 1) / blocks >= (1LL << 28)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbi = static_cast<int>(nb), bi = static_cast<int>(blocks);
  switch (ccode) {
    case 0: return static_cast<int>(launch_bytes<float>(x, n, table, edges, nbi, out, partial, units, bi, aligned, st));
    case 1: return static_cast<int>(launch_bytes<double>(x, n, table, edges, nbi, out, partial, units, bi, aligned, st));
    case 2: return static_cast<int>(launch_bytes<long long>(x, n, table, edges, nbi, out, partial, units, bi, aligned,
                                                            st));
    case 3: return static_cast<int>(launch_bytes<unsigned long long>(x, n, table, edges, nbi, out, partial, units, bi,
                                                                     aligned, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* histogram_bytes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

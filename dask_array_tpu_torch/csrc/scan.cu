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
// and the chains are independent.
//
// The step.  numpy rounds a 2-byte step as a float32 op rounded to the
// type; float32 has at least 2p + 2 bits of the type's p (24 >= 24 for
// float16, 24 >= 18 for bfloat16), so that double rounding equals one
// rounding of the exact result, and the step is one native op on the
// 2-byte carry: add.rn / mul.rn on .f16 or .bf16 (no .ftz, and an explicit
// rounding so no contraction); every pair of patterns of each type and op
// gives numpy's bytes so (tests/test_torch_gpu.py
// test_scan_kernel_on_every_pair).  The carry's chain is that one op.
// NaN bits come off the chain: NaN is absorbing along a scan, so the carry
// may hold the card's canonical NaN, and a second running value, which does
// not depend on the carry, holds the quieted bits of the last NaN term so
// far (the type's default NaN before any).  The stored output is
//   isnan(carry) ? that value : carry,   out[0] a copy of x[0], unquieted,
// which is numpy's result on x86-64 for every step, both operands NaN
// included: a NaN term's bits quieted where the term is NaN, else the
// running value's, else (inf - inf, 0 * inf) the negative default NaN.
// float16 quiets by setting the payload's top bit (h | 0x0200, default
// 0xfe00); bfloat16 by the sign and 0x7fc0 (ml_dtypes drops the payload;
// default 0xffc0).  A batch of steps whose last carry is not NaN has no
// NaN term and no NaN output, so it selects nothing.  A 1-byte step is a
// lookup in the type's 256 x 256 table of rounded results,
// table[running * 256 + term], made on the host from the type's own
// conversions and held here in shared memory (64 KiB).
//
// The ring.  A unit is a set of chains one block scans: a strip of `width`
// neighbouring columns of one p (Q > 1), or `width` neighbouring rows
// (Q == 1).  Its steps go through the block in tiles of `depth` steps,
// each held in one of `stages` shared-memory stages of `slots` slots of
// `pitch` bytes.  A slot is one contiguous run of the input: one step of
// the strip (column chains: slots = depth), or `depth` steps of one row
// (row chains: slots = width).  One producer warp keeps up to `stages`
// tiles in flight: it copies each slot's 16-byte-aligned envelope of its
// run in 16-byte cp.async copies, the lanes taking the tile's chunks in
// turn with their addresses walked by adds, and each lane arrives on the
// stage's "full" mbarrier once its copies land
// (cp.async.mbarrier.arrive.noinc).  A run starts `lead` bytes into its
// slot (0 when rows and pointers are 16-byte aligned), so every shape
// takes the one load path; pitch leaves the envelope 16 bytes of room.
// (A cp.async.bulk copy a slot costs about 35 ns of an SM's time whatever
// its size, which held the 16384^2 scan to 1.2 ms.)  Consumer thread t
// scans chain t of the unit out of the stage, then arrives on the stage's
// "done" mbarrier, after which the producer refills it: column chains
// read byte t * itemsize of each slot (neighbouring threads on
// neighbouring words, no bank conflict) and store each output straight
// from registers (a warp's 32 outputs of a step one coalesced run); row
// chains read slot t in 16-byte words, the next word's load ahead of the
// steps (pitch = 16 * (8n + 1) bytes, so a quarter-warp's eight reads fall
// in eight distinct bank groups), write the outputs back in place, and
// each warp stores its 32 rows' tile in 16-byte words, lanes across a row
// (unaligned rows: each output straight to memory).  A grid of at most
// `grid` blocks walks the units (block b takes units b, b + grid, ...),
// the ring running on from one unit's last tile to the next unit's first.
// The host picks every number of the plan (kernels/scan.py launch_plan)
// and passes it whole; scan_launch only checks it: strips of 256 bytes when
// the chains fill the card, down to one 32-byte sector a step so that few
// long chains spread over many SMs; rows 128 to a block; stages filling the
// 227 KiB of shared memory beside a 1-byte table.  A lone 1-byte row
// (P == Q == 1) takes the row-batch route below instead.
//
// Bound: many chains are bound by device memory, one read and one write
// of the block; few long chains by the latency of one step (one native
// op; a shift-add and a shared-memory load for a 1-byte type) times L,
// and in practice by one warp's instruction issue a step, which the
// consumers keep short (halves split and joined in place, words read a
// word ahead, the NaN test once a batch).  scan_floor_launch runs one
// thread's dependent chain of steps, to measure a step's latency.
// Offsets are 64-bit.  Launches on the caller's stream; the entry points
// return cudaGetLastError() or the error that refused the launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTableBytes = 256 * 256;
constexpr int kSmemLimit = 232448;  // shared memory a block may take on sm_90
constexpr int kProducer = 32;       // the producer warp
constexpr int kMaxThreads = 288;    // 256 consumers and the producer
constexpr int kMaxStages = 8;
constexpr int kBatch = 8;  // steps a consumer takes between NaN tests
constexpr int kBatchThreads = 128;  // threads a block of the row-batch route

// ---------------------------------------------------------------------------
// the steps

struct Half {
  static __device__ __forceinline__ bool nan(uint16_t h) { return (h & 0x7fffu) > 0x7c00u; }
  static __device__ __forceinline__ uint16_t quiet(uint16_t h) { return static_cast<uint16_t>(h | 0x0200u); }
  static constexpr uint16_t kDefaultNaN = 0xfe00u;
  static __device__ __forceinline__ uint16_t add(uint16_t a, uint16_t b) {
    uint16_t r;
    asm("add.rn.f16 %0, %1, %2;" : "=h"(r) : "h"(a), "h"(b));
    return r;
  }
  static __device__ __forceinline__ uint16_t mul(uint16_t a, uint16_t b) {
    uint16_t r;
    asm("mul.rn.f16 %0, %1, %2;" : "=h"(r) : "h"(a), "h"(b));
    return r;
  }
};

struct BFloat {
  static __device__ __forceinline__ bool nan(uint16_t h) { return (h & 0x7fffu) > 0x7f80u; }
  static __device__ __forceinline__ uint16_t quiet(uint16_t h) {
    return static_cast<uint16_t>((h & 0x8000u) | 0x7fc0u);
  }
  static constexpr uint16_t kDefaultNaN = 0xffc0u;
  static __device__ __forceinline__ uint16_t add(uint16_t a, uint16_t b) {
    uint16_t r;
    asm("add.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(a), "h"(b));
    return r;
  }
  static __device__ __forceinline__ uint16_t mul(uint16_t a, uint16_t b) {
    uint16_t r;
    asm("mul.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(a), "h"(b));
    return r;
  }
};

// a 2-byte step of type F, one native op: kMul picks the product
template <class F, bool kMul>
struct TwoByte {
  using T = uint16_t;
  static constexpr bool kNaN = true;
  static constexpr int kTable = 0;
  static constexpr T kDefaultNaN = F::kDefaultNaN;
  __device__ __forceinline__ explicit TwoByte(const uint8_t*) {}
  __device__ __forceinline__ T operator()(T s, T x) const { return kMul ? F::mul(s, x) : F::add(s, x); }
  static __device__ __forceinline__ bool nan(T h) { return F::nan(h); }
  static __device__ __forceinline__ T quiet(T h) { return F::quiet(h); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 1-byte step: its table, in shared memory.  The table's address plus the
// term is off the carry's chain, so a step is one shift-add and one load
// (written out, since the compiler otherwise adds the base on the chain)
struct OneByte {
  using T = uint8_t;
  static constexpr bool kNaN = false;
  static constexpr int kTable = kTableBytes;
  static constexpr T kDefaultNaN = 0;
  uint32_t tab;  // the table's shared-memory address
  __device__ __forceinline__ explicit OneByte(const uint8_t* shared) : tab(smem_addr(shared)) {}
  __device__ __forceinline__ T operator()(T s, T x) const {
    uint32_t r;
    asm volatile(
        "{\n\t.reg .u32 i;\n\t"
        "shl.b32 i, %1, 8;\n\t"
        "add.u32 i, i, %2;\n\t"
        "ld.shared.u8 %0, [i];\n\t}"
        : "=r"(r)
        : "r"(static_cast<uint32_t>(s)), "r"(tab + x)
        : "memory");
    return static_cast<T>(r);
  }
  static __device__ __forceinline__ bool nan(T) { return false; }
  static __device__ __forceinline__ T quiet(T h) { return h; }
};

// a chain's carry and the NaN bits of its outputs
template <class Step>
struct Chain {
  using T = typename Step::T;
  T carry;
  T nan_bits;

  // the chain's first term, copied
  __device__ __forceinline__ void start(T x0) {
    carry = x0;
    nan_bits = Step::nan(x0) ? Step::quiet(x0) : Step::kDefaultNaN;
  }

  // step over e[from], ..., e[V - 1]; each becomes its output
  template <int V>
  __device__ __forceinline__ void scan(const Step& step, T (&e)[V], int from = 0) {
    T r[V];
    T c = carry;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k >= from) c = step(c, e[k]);
      r[k] = k >= from ? c : e[k];
    }
    if constexpr (Step::kNaN) {
      if (Step::nan(c)) {  // NaN is absorbing: else no term and no output of the batch is NaN
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (k < from) continue;
          if (Step::nan(e[k])) nan_bits = Step::quiet(e[k]);
          if (Step::nan(r[k])) r[k] = nan_bits;
        }
      }
    }
    carry = c;
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = r[k];
  }
};

// ---------------------------------------------------------------------------
// barriers and asynchronous copies (sm_90)

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t ok;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!ok);
}

// a 16-byte copy from global to shared memory (cp.async, LDGSTS), in flight
// until the thread's cp_async_arrive on a barrier completes
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// an arrival on bar once every cp_async16 this thread issued has landed
// (noinc: the barrier's count includes this arrival)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ---------------------------------------------------------------------------
// the plan (kernels/scan.py launch_plan picks it; scan_launch checks it)

// the plan's fields as scan_launch receives them (kernels/scan.py Plan.fields)
enum Field { kMode, kWidth, kDepth, kSlots, kPitch, kStages, kConsumers, kAligned, kUnits, kTiles, kSmem, kGrid };

struct Plan {
  const uint8_t* x;
  uint8_t* out;
  const uint8_t* table;
  long long P, L, Q;
  long long units;  // units of chains
  long long tiles;  // tiles a unit: ceil(L / depth)
  int cols;         // 1: column chains (a unit a strip of one p), 0: row chains
  int width;        // chains a unit
  int depth;        // steps a tile
  int slots;        // slots a stage: depth (columns) or width (rows)
  int pitch;        // bytes a slot
  int stages;
  int consumers;  // consumer threads, a multiple of 32
  int aligned;    // rows and pointers 16-byte aligned: row chains read and write 16-byte words
};

// a unit's first chain (p, q0) and how many of its chains exist
struct Unit {
  long long p, q0;
  int chains;
};

__device__ __forceinline__ Unit unit_of(const Plan& pl, long long u) {
  Unit un;
  if (pl.cols) {
    const long long strips = (pl.Q + pl.width - 1) / pl.width;
    un.p = u / strips;
    un.q0 = (u - un.p * strips) * pl.width;
    un.chains = static_cast<int>(min(static_cast<long long>(pl.width), pl.Q - un.q0));
  } else {
    un.p = u * pl.width;
    un.q0 = 0;
    un.chains = static_cast<int>(min(static_cast<long long>(pl.width), pl.P - un.p));
  }
  return un;
}

// steps of tile k
__device__ __forceinline__ int steps_of(const Plan& pl, long long k) {
  return static_cast<int>(min(static_cast<long long>(pl.depth), pl.L - k * pl.depth));
}

// the run of tile k's first slot: its first element and its length (slot
// i's run starts i * Q elements later for column chains, i * L for rows)
__device__ __forceinline__ void first_run(const Plan& pl, const Unit& un, long long k, long long& off, int& n) {
  if (pl.cols) {
    off = (un.p * pl.L + k * pl.depth) * pl.Q + un.q0;
    n = un.chains;
  } else {
    off = un.p * pl.L + k * pl.depth;
    n = steps_of(pl, k);
  }
}

template <int ES>
__device__ __forceinline__ uint32_t lead_of(const uint8_t* base, long long off) {
  return static_cast<uint32_t>((reinterpret_cast<uintptr_t>(base) + static_cast<uintptr_t>(off) * ES) & 15);
}

// ---------------------------------------------------------------------------
// the producer warp: the copies of each tile, a stage ahead of the consumers

template <class Step>
__device__ __forceinline__ void produce(const Plan& pl, uint8_t* stage0, int stage_bytes, uint64_t* full,
                                       uint64_t* done, long long tiles, int lane) {
  constexpr int ES = sizeof(typename Step::T);
  const long long run_bytes = (pl.cols ? pl.Q : pl.L) * ES;  // from one slot's run to the next's
  for (long long g = 0; g < tiles; ++g) {
    const int s = static_cast<int>(g % pl.stages);
    if (g >= pl.stages) bar_wait(done + s, static_cast<uint32_t>(((g / pl.stages) & 1) ^ 1));  // tile g - stages
    const long long k = g % pl.tiles;
    const Unit un = unit_of(pl, blockIdx.x + (g / pl.tiles) * gridDim.x);
    const int nslots = pl.cols ? steps_of(pl, k) : un.chains;
    long long off;
    int n;
    first_run(pl, un, k, off, n);
    const uintptr_t run0 = reinterpret_cast<uintptr_t>(pl.x) + static_cast<uintptr_t>(off) * ES;  // slot 0's run
    const uint32_t nbytes = static_cast<uint32_t>(n) * ES;
    uint8_t* stage = stage0 + s * stage_bytes;
    // the lanes take the tile's 16-byte chunks in turn, cps a slot: lane l
    // chunk c of slot i for every l + 32m = i * cps + c, walked with adds
    const int cps = pl.aligned ? static_cast<int>(nbytes / 16) : pl.pitch / 16;
    const int dq = 32 / cps, dr = 32 - dq * cps;
    int i = lane / cps, c = lane - i * cps;
    for (int idx = lane; idx < nslots * cps; idx += 32) {
      const uintptr_t run = run0 + static_cast<uintptr_t>(i) * run_bytes;
      if (pl.aligned) {
        cp_async16(stage + i * pl.pitch + c * 16, reinterpret_cast<const void*>(run + c * 16));
      } else {  // the run's envelope; its chunks past the envelope skipped
        const uintptr_t a = run & ~static_cast<uintptr_t>(15);
        if (static_cast<uintptr_t>(c * 16) < ((run + nbytes + 15) & ~static_cast<uintptr_t>(15)) - a)
          cp_async16(stage + i * pl.pitch + c * 16, reinterpret_cast<const void*>(a + c * 16));
      }
      i += dq;
      c += dr;
      if (c >= cps) {
        c -= cps;
        ++i;
      }
    }
    cp_async_arrive(full + s);
  }
}

// ---------------------------------------------------------------------------
// the consumers: thread t scans chain t of the unit

// 16 bytes as V elements, and back, in registers: a 2-byte element is a
// half of a word (mov.b32 splits and joins, which the ops read in place),
// a 1-byte element a byte picked by PRMT
__device__ __forceinline__ void split(uint32_t w, uint16_t& lo, uint16_t& hi) {
  asm("mov.b32 {%0, %1}, %2;" : "=h"(lo), "=h"(hi) : "r"(w));
}

__device__ __forceinline__ uint32_t join(uint16_t lo, uint16_t hi) {
  uint32_t w;
  asm("mov.b32 %0, {%1, %2};" : "=r"(w) : "h"(lo), "h"(hi));
  return w;
}

__device__ __forceinline__ void unpack(const uint4& w, uint16_t (&e)[8]) {
  split(w.x, e[0], e[1]);
  split(w.y, e[2], e[3]);
  split(w.z, e[4], e[5]);
  split(w.w, e[6], e[7]);
}

__device__ __forceinline__ uint4 pack(const uint16_t (&e)[8]) {
  return make_uint4(join(e[0], e[1]), join(e[2], e[3]), join(e[4], e[5]), join(e[6], e[7]));
}

__device__ __forceinline__ void unpack(const uint4& w, uint8_t (&e)[16]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) e[k] = static_cast<uint8_t>(__byte_perm(words[k / 4], 0, 0x4440 | (k % 4)));
}

__device__ __forceinline__ uint4 pack(const uint8_t (&e)[16]) {
  uint32_t words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)  // bytes 4i .. 4i + 3 (each zero-extended) into word i
    words[i] = __byte_perm(__byte_perm(e[4 * i], e[4 * i + 1], 0x3340), __byte_perm(e[4 * i + 2], e[4 * i + 3], 0x3340),
                           0x5410);
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// tile k of a column unit: step j of chain t at byte j * pitch + lead_j +
// t * ES of the stage, its output straight to out (a warp's 32 outputs of
// a step are one coalesced run)
template <class Step, bool kAligned>
__device__ __forceinline__ void scan_cols(const Plan& pl, const Step& step, Chain<Step>& ch, const uint8_t* stage,
                                          const Unit& un, long long k, int t) {
  using T = typename Step::T;
  constexpr int ES = sizeof(T);
  const int steps = steps_of(pl, k);
  const long long first = (un.p * pl.L + k * pl.depth) * pl.Q + un.q0;  // the tile's first element of the strip
  const long long q = pl.Q;
  T* o = reinterpret_cast<T*>(pl.out) + first + t;  // step j's output: out + j * Q
  // a run's lead in its envelope moves by Q * ES mod 16 a step
  const uint32_t lead0 = kAligned ? 0u : lead_of<ES>(pl.x, first);
  const uint32_t dlead = kAligned ? 0u : static_cast<uint32_t>((pl.Q * ES) & 15);
  const uint8_t* in = stage + t * ES;
  auto at = [&](int j) -> T {
    const uint32_t lead = kAligned ? 0u : (lead0 + static_cast<uint32_t>(j) * dlead) & 15u;
    return *reinterpret_cast<const T*>(in + j * pl.pitch + lead);
  };
  int j = 0;
  if (k == 0) {
    const T x0 = at(0);
    ch.start(x0);
    *o = x0;
    o += q;
    j = 1;
  }
  for (; j + kBatch <= steps; j += kBatch) {
    T e[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) e[u] = at(j + u);
    ch.scan(step, e);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      *o = e[u];
      o += q;
    }
  }
  for (; j < steps; ++j) {
    T e[1] = {at(j)};
    ch.scan(step, e);
    *o = e[0];
    o += q;
  }
}

// tile k of a row unit: chain t's steps are slot t, from byte lead on.  With
// aligned rows the slot is read in 16-byte words (two in turn, each read a
// word ahead) and the outputs overwrite them, after which each warp stores
// its 32 rows' outputs in 16-byte words, lanes across a row; unaligned rows
// store each output straight to memory.  Every consumer thread calls it
// (for the warp's __syncwarp); ``active``: t is a chain of the unit.
template <class Step, bool kAligned>
__device__ __forceinline__ void scan_rows(const Plan& pl, const Step& step, Chain<Step>& ch, uint8_t* stage,
                                          const Unit& un, long long k, int t, bool active) {
  using T = typename Step::T;
  constexpr int ES = sizeof(T);
  const int steps = steps_of(pl, k);
  const long long first = (un.p + t) * pl.L + k * pl.depth;  // the tile's first element of row p + t
  uint8_t* slot = stage + t * pl.pitch;
  if constexpr (kAligned) {
    constexpr int V = 16 / ES;  // the row's length is a multiple of V
    const int vectors = steps / V;
    if (active) {
      uint4* words = reinterpret_cast<uint4*>(slot);
      auto scan_word = [&](uint4 w, int v) {
        T e[V];
        unpack(w, e);
        if (k == 0 && v == 0) {
          ch.start(e[0]);
          ch.scan(step, e, 1);
        } else {
          ch.scan(step, e);
        }
        words[v] = pack(e);
      };
      uint4 w0 = words[0], w1;
      for (int v = 0; v < vectors; v += 2) {
        if (v + 1 < vectors) w1 = words[v + 1];
        scan_word(w0, v);
        if (v + 1 == vectors) break;
        if (v + 2 < vectors) w0 = words[v + 2];
        scan_word(w1, v + 1);
      }
    }
    __syncwarp();
    // the warp's rows, lanes across each
    const int lane = t & 31, row0 = t & ~31;
    const int rows = min(32, un.chains - row0);
    for (int r = 0; r < rows; ++r) {
      const uint4* src = reinterpret_cast<const uint4*>(stage + (row0 + r) * pl.pitch);
      uint4* dst = reinterpret_cast<uint4*>(pl.out + ((un.p + row0 + r) * pl.L + k * pl.depth) * ES);
      for (int v = lane; v < vectors; v += 32) dst[v] = src[v];
    }
  } else {
    if (!active) return;
    const T* src = reinterpret_cast<const T*>(slot + lead_of<ES>(pl.x, first));
    T* dst = reinterpret_cast<T*>(pl.out) + first;
    int j = 0;
    if (k == 0) {
      ch.start(src[0]);
      dst[0] = src[0];
      j = 1;
    }
    for (; j + kBatch <= steps; j += kBatch) {
      T e[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) e[u] = src[j + u];
      ch.scan(step, e);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) dst[j + u] = e[u];
    }
    for (; j < steps; ++j) {
      T e[1] = {src[j]};
      ch.scan(step, e);
      dst[j] = e[0];
    }
  }
}

template <class Step, bool kAligned>
__device__ __forceinline__ void consume(const Plan& pl, const Step& step, uint8_t* stage0, int stage_bytes, uint64_t* full,
                        uint64_t* done, long long tiles, int t) {
  Chain<Step> ch{};
  int s = 0;
  uint32_t phase = 0;
  long long k = 0, i = 0;  // tile k of the block's unit i
  Unit un = unit_of(pl, blockIdx.x);
  for (long long g = 0; g < tiles; ++g) {
    bar_wait(full + s, phase);
    uint8_t* stage = stage0 + s * stage_bytes;
    if (pl.cols) {
      if (t < un.chains) scan_cols<Step, kAligned>(pl, step, ch, stage, un, k, t);
    } else {
      scan_rows<Step, kAligned>(pl, step, ch, stage, un, k, t, t < un.chains);
    }
    bar_arrive(done + s);  // the stage is read: the producer may refill it
    if (++s == pl.stages) {
      s = 0;
      phase ^= 1u;
    }
    if (++k == pl.tiles) {
      k = 0;
      ++i;
      un = unit_of(pl, blockIdx.x + i * gridDim.x);
    }
  }
}

template <class Step>
__global__ void __launch_bounds__(kMaxThreads) scan_ring(const Plan pl) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* stage0 = smem + Step::kTable;
  const int stage_bytes = pl.slots * pl.pitch;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage0 + pl.stages * stage_bytes);
  uint64_t* done = full + pl.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      bar_init(full + s, kProducer);
      bar_init(done + s, pl.consumers);
    }
    fence_bar_init();
  }
  if constexpr (Step::kTable > 0) {
    const uint4* src = reinterpret_cast<const uint4*>(pl.table);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  const long long units = (pl.units - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's
  const long long tiles = units * pl.tiles;
  const int t = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, t >> 5, 0);  // warp-uniform, so is the branch
  if (warp * 32 >= pl.consumers) {
    produce<Step>(pl, stage0, stage_bytes, full, done, tiles, t - pl.consumers);
  } else {
    const Step step(smem);
    if (pl.aligned) {
      consume<Step, true>(pl, step, stage0, stage_bytes, full, done, tiles, t);
    } else {
      consume<Step, false>(pl, step, stage0, stage_bytes, full, done, tiles, t);
    }
  }
}

// The route of a lone 1-byte row (kernels/scan.py launch_plan's
// `batches`: P == Q == 1, rows and pointers 16-byte aligned), the one
// shape where the ring is slower: 276.6 ms here against 285.5 for a
// 2^24-step float8_e4m3fn row, while the ring takes 8 and 64 rows in 35.71
// and 4.481 ms against 38.99 and 6.562 here (scripts/time_scan.py, both
// routes in one call, NVIDIA H100 80GB HBM3, 700 W).  A thread scans a
// row read straight from memory in 16-byte words: three batches of kWords
// words in registers, each loaded two batches ahead of its steps (the three
// rotate by name, so no register copy waits on a load in flight), each word
// of outputs stored straight back; threads past the last row return.
constexpr int kWords = 8;

// words v .. v + kWords - 1 of a row, each index clamped to its last
__device__ __forceinline__ void load_words(const uint4* src, long long v, long long last, uint4 (&b)[kWords]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) b[j] = __ldg(src + min(v + j, last));
}

// the steps of words v .. v + kWords - 1: all of them (kFull), or those before n
template <bool kFull, class Step>
__device__ __forceinline__ void scan_batch(const Step& step, Chain<Step>& ch, uint4* dst, long long v, long long n,
                                           const uint4 (&b)[kWords]) {
  using T = typename Step::T;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    if (kFull || v + j < n) {
      T e[16 / sizeof(T)];
      unpack(b[j], e);
      ch.scan(step, e);
      dst[v + j] = pack(e);
    }
  }
}

template <class Step>
__global__ void __launch_bounds__(kBatchThreads) scan_row_batches(const Plan pl) {
  using T = typename Step::T;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint4* tsrc = reinterpret_cast<const uint4*>(pl.table);
  for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x) reinterpret_cast<uint4*>(smem)[i] = tsrc[i];
  __syncthreads();
  const long long r = static_cast<long long>(blockIdx.x) * kBatchThreads + threadIdx.x;
  if (r >= pl.P) return;
  const Step step(smem);
  const long long n = pl.L * sizeof(T) / 16;  // words of a row
  const uint4* src = reinterpret_cast<const uint4*>(pl.x) + r * n;
  uint4* dst = reinterpret_cast<uint4*>(pl.out) + r * n;
  uint4 a[kWords], b[kWords], d[kWords];
  load_words(src, 1, n - 1, a);
  load_words(src, 1 + kWords, n - 1, b);
  Chain<Step> ch{};
  T e[16 / sizeof(T)];
  unpack(__ldg(src), e);
  ch.start(e[0]);  // the first element is a copy
  ch.scan(step, e, 1);
  dst[0] = pack(e);
  long long v = 1;
  for (; v + 3 * kWords <= n; v += 3 * kWords) {  // whole batches: no test a word
    load_words(src, v + 2 * kWords, n - 1, d);
    scan_batch<true>(step, ch, dst, v, n, a);
    load_words(src, v + 3 * kWords, n - 1, a);
    scan_batch<true>(step, ch, dst, v + kWords, n, b);
    load_words(src, v + 4 * kWords, n - 1, b);
    scan_batch<true>(step, ch, dst, v + 2 * kWords, n, d);
  }
  load_words(src, v + 2 * kWords, n - 1, d);  // fewer than 3 * kWords words left
  scan_batch<false>(step, ch, dst, v, n, a);
  scan_batch<false>(step, ch, dst, v + kWords, n, b);
  scan_batch<false>(step, ch, dst, v + 2 * kWords, n, d);
}

// one thread's dependent chain of n steps (n a multiple of 8) over the
// eight terms x[0..7], from x[8]; the last carry into out[0]
template <class Step>
__global__ void step_chain(const typename Step::T* __restrict__ x, typename Step::T* __restrict__ out,
                           const uint8_t* __restrict__ table, long long n) {
  using T = typename Step::T;
  extern __shared__ __align__(128) uint8_t smem[];
  if constexpr (Step::kTable > 0) {
    const uint4* src = reinterpret_cast<const uint4*>(table);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x) dst[i] = src[i];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const Step step(smem);
  T e[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = x[k];
  T c = x[8];
  for (long long i = 0; i < n; i += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) c = step(c, e[k]);
  }
  out[0] = c;
}

// a kernel's dynamic shared memory past 48 KiB, allowed on the current device
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
                           : cudaSuccess;
}

template <class Step>
int run(const Plan& pl, long long grid, int smem, cudaStream_t stream) {
  const cudaError_t e = allow_shared(scan_ring<Step>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_ring<Step><<<static_cast<unsigned>(grid), pl.consumers + kProducer, smem, stream>>>(pl);
  return static_cast<int>(cudaGetLastError());
}

template <class Step>
int run_chain(const void* x, void* out, const void* table, long long n, cudaStream_t stream) {
  using T = typename Step::T;
  const int smem = Step::kTable;
  const cudaError_t e = allow_shared(step_chain<Step>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  step_chain<Step><<<1, 32, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                             static_cast<const uint8_t*>(table), n);
  return static_cast<int>(cudaGetLastError());
}

// the step of (type, op): 0-3 the 2-byte steps, 4 the 1-byte one
int step_code(int type, int op) {
  if (type == 2) return 4;
  if (type < 0 || type > 1 || op < 0 || op > 1) return -1;
  return type * 2 + op;
}

template <template <class> class Fn, class... Args>
int dispatch(int code, Args... args) {
  switch (code) {
    case 0: return Fn<TwoByte<Half, false>>::call(args...);
    case 1: return Fn<TwoByte<Half, true>>::call(args...);
    case 2: return Fn<TwoByte<BFloat, false>>::call(args...);
    case 3: return Fn<TwoByte<BFloat, true>>::call(args...);
    case 4: return Fn<OneByte>::call(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Step>
struct RunRing {
  static int call(const Plan* pl, long long grid, int smem, cudaStream_t stream) {
    return run<Step>(*pl, grid, smem, stream);
  }
};

template <class Step>
struct RunChain {
  static int call(const void* x, void* out, const void* table, long long n, cudaStream_t stream) {
    return run_chain<Step>(x, out, table, n, stream);
  }
};

}  // namespace

extern "C" {

// x, out: contiguous (P, L, Q) blocks on the device, scanned along L.
// type: 0 float16, 1 bfloat16 (op: 0 add, 1 multiply), 2 a 1-byte type
// stepped through table (65536 bytes on the device, 16-byte aligned; op
// unread).  plan: kernels/scan.py launch_plan's fields in the order of
// Field (mode 0 the ring on row chains, 1 on column chains, 2 the
// row-batch route); the kernel derives none of them and refuses a plan that
// breaks an invariant it relies on.  Returns a cudaError_t.
int scan_launch(const void* x, void* out, const void* table, long long P, long long L, long long Q, int type,
                int op, const long long* plan, void* stream) {
  const int code = step_code(type, op);
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (code < 0 || plan == nullptr || P <= 0 || L <= 0 || Q <= 0) return kInvalid;
  if (type == 2 && (table == nullptr || reinterpret_cast<uintptr_t>(table) % 16 != 0)) return kInvalid;
  const long long es = type == 2 ? 1 : 2;
  const bool pointers16 = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const long long mode = plan[kMode], width = plan[kWidth], depth = plan[kDepth], slots = plan[kSlots],
                  pitch = plan[kPitch], stages = plan[kStages], consumers = plan[kConsumers],
                  aligned = plan[kAligned], units = plan[kUnits], tiles = plan[kTiles], smem = plan[kSmem],
                  grid = plan[kGrid];
  Plan pl{};
  pl.x = static_cast<const uint8_t*>(x);
  pl.out = static_cast<uint8_t*>(out);
  pl.table = static_cast<const uint8_t*>(table);
  pl.P = P;
  pl.L = L;
  pl.Q = Q;
  if (mode == 2) {  // a 1-byte type, rows and pointers 16-byte aligned, a thread a row
    if (type != 2 || Q != 1 || L % 16 != 0 || !pointers16 || grid != (P + kBatchThreads - 1) / kBatchThreads ||
        grid > 0x7fffffffLL)
      return kInvalid;
    const cudaError_t e = allow_shared(scan_row_batches<OneByte>, kTableBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    scan_row_batches<OneByte><<<static_cast<unsigned>(grid), kBatchThreads, kTableBytes,
                                static_cast<cudaStream_t>(stream)>>>(pl);
    return static_cast<int>(cudaGetLastError());
  }
  const bool cols = mode == 1;
  // what the ring relies on: every chain in one unit, whole 16-byte words
  // in a slot with room for an envelope, the consumers' warps, the shared
  // memory the stages and barriers take, and 16-byte access where it says so
  const long long run = (cols ? width : depth) * es;
  const bool ok = (mode == 0 || mode == 1) && (cols || Q == 1) && width >= 1 && depth >= 1 && stages >= 1 &&
                  stages <= kMaxStages && consumers >= width && consumers % 32 == 0 &&
                  consumers + kProducer <= kMaxThreads && slots == (cols ? depth : width) && run % 16 == 0 &&
                  pitch >= run + 16 && pitch % 16 == 0 && pitch <= kSmemLimit &&
                  units == (cols ? P * ((Q + width - 1) / width) : (P + width - 1) / width) &&
                  tiles == (L + depth - 1) / depth &&
                  smem >= (type == 2 ? kTableBytes : 0) + stages * slots * pitch + 16 * stages &&
                  smem <= kSmemLimit && grid >= 1 && grid <= units && grid <= 0x7fffffffLL &&
                  (aligned == 0 || (aligned == 1 && pointers16 && ((cols ? Q : L) * es) % 16 == 0));
  if (!ok) return kInvalid;
  pl.units = units;
  pl.tiles = tiles;
  pl.cols = cols;
  pl.width = static_cast<int>(width);
  pl.depth = static_cast<int>(depth);
  pl.slots = static_cast<int>(slots);
  pl.pitch = static_cast<int>(pitch);
  pl.stages = static_cast<int>(stages);
  pl.consumers = static_cast<int>(consumers);
  pl.aligned = static_cast<int>(aligned);
  return dispatch<RunRing>(code, static_cast<const Plan*>(&pl), grid, static_cast<int>(smem),
                           static_cast<cudaStream_t>(stream));
}

const char* scan_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// One thread's dependent chain of n steps (n a positive multiple of 8) of
// the step scan_launch takes for (type, op): terms x[0..7] in turn, from
// x[8]; the last carry into out[0].  Its time over n is one step's latency.
int scan_floor_launch(const void* x, void* out, const void* table, long long n, int type, int op, void* stream) {
  const int code = step_code(type, op);
  if (code < 0 || n <= 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (type == 2 && (table == nullptr || reinterpret_cast<uintptr_t>(table) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<RunChain>(code, x, out, table, n, static_cast<cudaStream_t>(stream));
}

const char* scan_floor_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

// Halo assembly: numpy's pad in its index-map modes, all axes in one pass
// (dask_array_tpu_torch).
//
// Replaces the Pallas probes bench/probe_band_bisect.py (cases halo_views,
// pid_select, concat0, concat1_flip; :32-122) and bench/probe_band_bisect2.py
// (:68; raw and clamped index maps), which take the band stencil's halo
// assembly apart: a band of T rows is joined with the H-row views above and
// below it (index maps i*(T/H)-1 and (i+1)*(T/H), raw in the interior and
// clamped at the array's edge), a program_id select picks the edge fill, and
// columns are extended by flipping slices.  On the card that assembly is one
// gather of the whole padded array: for an input x of rank k and widths
// (lo_a, hi_a),
//   out[i_0, ..., i_{k-1}] = x[m_0(i_0 - lo_0), ..., m_{k-1}(i_{k-1} - lo_{k-1})]
// where m_a maps a coordinate into [0, n_a) by axis a's mode:
//   symmetric (dask's "reflect"): period 2n over [x, x reversed];
//   reflect (numpy's reflect):    period 2n - 2, and n == 1 maps to 0;
//   edge (dask's "nearest"):      clamp;
//   wrap (dask's "periodic"):     modulo;
//   constant:                     the axis's fill for that side.
// Where several constant pads meet at a corner, the highest-numbered such
// axis wins, and a constant axis wins over any index-map axis: that is what
// numpy's axis-by-axis padding gives.  Widths past the axis follow numpy
// (the formulas above are periodic, so they extend to any width).
//
// Bound: device memory.  A call reads the input once and writes the padded
// output once, (prod n_a + prod (n_a + lo_a + hi_a)) * itemsize bytes, and
// computes only addresses.  The Pallas grid ran bands in order on one core;
// here row segments run on all SMs, and no halo view, select or
// concatenation is needed.  Two kernels, chosen by the C launcher:
//  - the row kernel, for a last axis of unit stride (every contiguous input
//    and every row-sliced view): a block takes one segment of one output
//    row, maps the row's leading coordinates once (32-bit), and writes the
//    row's interior in aligned 16-byte stores.  Source and destination rows
//    rarely share a 16-byte alignment (at depth 1 in f32 the destination
//    interior starts 4 bytes past it), so each stored vector is two aligned
//    source vectors funnel-shifted in registers by the row's byte offset.
//    A row inside a constant pad is written as 16-byte vectors of the fill.
//    Offsets inside a row are 32-bit.  The few bytes before the first and
//    after the last aligned vector, and the lo + hi pad columns, are written
//    element by element by the row's first segment;
//  - the strided kernel, for any other view: one element a thread per step,
//    64-bit offsets, a grid of at most 32 blocks per SM that loops.
//
// A pad moves bytes, so both kernels are templated on the element's size
// (1, 2, 4, 8 and 16 bytes) and every dtype of the port goes through them; a
// fill arrives as the bytes of the value already converted to the dtype.
// The wrapper merges adjacent unpadded axes, so rank up to 8 is enough; the
// input's strides are parameters, so a sliced view is read in place.
// Launches on the caller's stream; halo_pad_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxRank = 8;
constexpr int kThreads = 256;
constexpr long long kSegment = 8192;      // strided kernel: most output elements a tile holds
constexpr long long kBlocksPerSm = 32;    // strided kernel: blocks per SM in the grid; they loop beyond
constexpr long long kRowVectors = 2048;   // row kernel: most 16-byte vectors a tile writes (32 KiB)

enum Mode : int { kSymmetric = 0, kReflect = 1, kEdge = 2, kWrap = 3, kConstant = 4 };

struct Params {
  long long in_shape[kMaxRank];
  long long in_stride[kMaxRank];  // elements
  long long out_shape[kMaxRank];
  long long lo[kMaxRank];
  int mode[kMaxRank];
  int ndim;
  long long rows;      // product of out_shape[0 .. ndim-2]
  long long segments;  // tiles per row
  long long seg_len;   // per tile: output elements (strided kernel), 16-byte vectors (row kernel)
  alignas(16) unsigned char fill[kMaxRank][2][16];  // [axis][side]: the fill repeated over 16 bytes
};

template <int kBytes>
struct Element;
template <>
struct Element<1> { using type = uint8_t; };
template <>
struct Element<2> { using type = uint16_t; };
template <>
struct Element<4> { using type = uint32_t; };
template <>
struct Element<8> { using type = unsigned long long; };
template <>
struct Element<16> { using type = ulonglong2; };

__device__ __forceinline__ long long pmod(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

// The source index of coordinate i (output coordinate minus lo, possibly
// outside [0, n)) along an axis of length n >= 1 in an index-map mode.
__device__ __forceinline__ long long map_index(long long i, long long n, int mode) {
  switch (mode) {
    case kSymmetric: {
      const long long m = pmod(i, 2 * n);
      return m < n ? m : 2 * n - 1 - m;
    }
    case kReflect: {
      if (n == 1) return 0;
      const long long p = 2 * n - 2;
      const long long m = pmod(i, p);
      return m < n ? m : p - m;
    }
    case kEdge:
      return i < 0 ? 0 : (i >= n ? n - 1 : i);
    default:  // kWrap
      return pmod(i, n);
  }
}

template <typename T>
__device__ __forceinline__ T load_fill(const Params& p, int axis, int side) {
  return *reinterpret_cast<const T*>(p.fill[axis][side]);  // 16-byte aligned
}

// Where output row `row` reads: the source element offset of its leading
// coordinates, or the first constant pad met from the highest axis down.
struct RowSource {
  long long src;
  int const_axis;  // -1: not inside a constant pad
  int const_side;
};

template <typename Index>
__device__ __forceinline__ RowSource map_row(const Params& p, Index row) {
  RowSource r{0, -1, 0};
  Index rem = row;
  for (int a = p.ndim - 2; a >= 0; --a) {  // axis ndim-2 varies fastest
    const Index n = static_cast<Index>(p.out_shape[a]);
    const long long i = static_cast<long long>(rem % n) - p.lo[a];
    rem /= n;
    if (i >= 0 && i < p.in_shape[a]) {
      r.src += i * p.in_stride[a];
    } else if (p.mode[a] == kConstant) {
      if (r.const_axis < 0) {
        r.const_axis = a;
        r.const_side = i >= 0;
      }
    } else {
      r.src += map_index(i, p.in_shape[a], p.mode[a]) * p.in_stride[a];
    }
  }
  return r;
}

// The element at column c (output coordinate) of a row: what every path
// below writes outside the row kernel's aligned vectors.
template <typename T>
__device__ __forceinline__ T row_element(const Params& p, const RowSource& r, const T* srow, long long c) {
  const int last = p.ndim - 1;
  const int mode = p.mode[last];
  const long long n_in = p.in_shape[last];
  const long long i = c - p.lo[last];
  if (r.const_axis >= 0) {
    // inside a constant pad: its fill, except where the last axis's own
    // constant pad (the highest axis) covers the column
    if (mode == kConstant && (i < 0 || i >= n_in)) return load_fill<T>(p, last, i >= 0);
    return load_fill<T>(p, r.const_axis, r.const_side);
  }
  if (i >= 0 && i < n_in) return srow[i * p.in_stride[last]];
  if (mode == kConstant) return load_fill<T>(p, last, i >= 0);
  return srow[map_index(i, n_in, mode) * p.in_stride[last]];
}

// Strided kernel: any strides, one element a thread per step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_pad_strided(const T* __restrict__ x, T* __restrict__ out, const __grid_constant__ Params p) {
  const long long n_out = p.out_shape[p.ndim - 1];
  const long long tiles = p.rows * p.segments;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row = t / p.segments;
    const long long seg = t - row * p.segments;
    const RowSource r = map_row<long long>(p, row);
    T* dst = out + row * n_out;
    const T* srow = x + r.src;
    const long long c0 = seg * p.seg_len;
    const long long c1 = c0 + p.seg_len < n_out ? c0 + p.seg_len : n_out;
    for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) dst[c] = row_element<T>(p, r, srow, c);
  }
}

// 16 bytes starting `word` 32-bit words plus `bits` bits into a:b (a first):
// the realignment of two aligned source vectors onto one destination vector.
__device__ __forceinline__ uint4 realign(const uint4 a, const uint4 b, int word, int bits) {
  switch (word) {  // uniform within a row
    case 0:
      return make_uint4(__funnelshift_r(a.x, a.y, bits), __funnelshift_r(a.y, a.z, bits),
                        __funnelshift_r(a.z, a.w, bits), __funnelshift_r(a.w, b.x, bits));
    case 1:
      return make_uint4(__funnelshift_r(a.y, a.z, bits), __funnelshift_r(a.z, a.w, bits),
                        __funnelshift_r(a.w, b.x, bits), __funnelshift_r(b.x, b.y, bits));
    case 2:
      return make_uint4(__funnelshift_r(a.z, a.w, bits), __funnelshift_r(a.w, b.x, bits),
                        __funnelshift_r(b.x, b.y, bits), __funnelshift_r(b.y, b.z, bits));
    default:
      return make_uint4(__funnelshift_r(a.w, b.x, bits), __funnelshift_r(b.x, b.y, bits),
                        __funnelshift_r(b.y, b.z, bits), __funnelshift_r(b.z, b.w, bits));
  }
}

// Row kernel: the last axis has unit stride.  Tile t is segment
// t % segments of output row t / segments (both below 2^31).
template <int kBytes>
__global__ void __launch_bounds__(kThreads)
halo_pad_rows(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
              const __grid_constant__ Params p) {
  using T = typename Element<kBytes>::type;
  const int last = p.ndim - 1;
  const unsigned segs = static_cast<unsigned>(p.segments);
  const unsigned row = blockIdx.x / segs;
  const unsigned seg = blockIdx.x - row * segs;
  const RowSource r = map_row<unsigned>(p, row);
  const long long n_in = p.in_shape[last];
  const long long lo = p.lo[last];
  unsigned char* dst = out + static_cast<long long>(row) * p.out_shape[last] * kBytes;
  const unsigned char* src = x + r.src * kBytes;  // the source row, unit stride
  unsigned char* body = dst + lo * kBytes;        // the row's interior
  const unsigned long long body_bytes = static_cast<unsigned long long>(n_in) * kBytes;
  // aligned vectors [body + head, body + head + 16 * nvec) of the interior
  const unsigned head = static_cast<unsigned>(-reinterpret_cast<uintptr_t>(body) & 15);
  const unsigned nvec = body_bytes > head ? static_cast<unsigned>((body_bytes - head) / 16) : 0;
  uint4* vdst = reinterpret_cast<uint4*>(body + head);
  const unsigned v0 = seg * static_cast<unsigned>(p.seg_len);
  const unsigned v1 = v0 + static_cast<unsigned>(p.seg_len) < nvec ? v0 + static_cast<unsigned>(p.seg_len) : nvec;
  if (r.const_axis >= 0) {
    const uint4 fill = *reinterpret_cast<const uint4*>(p.fill[r.const_axis][r.const_side]);
#pragma unroll 4
    for (unsigned v = v0 + threadIdx.x; v < v1; v += kThreads) vdst[v] = fill;
  } else {
    const unsigned char* vsrc = src + head;  // the source byte of vdst[0]
    const unsigned mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(vsrc) & 15);
    const uint4* a = reinterpret_cast<const uint4*>(vsrc - mis);
    if (mis == 0) {
#pragma unroll 4
      for (unsigned v = v0 + threadIdx.x; v < v1; v += kThreads) vdst[v] = __ldg(a + v);
    } else {
      // both aligned vectors hold bytes of vdst[v]'s source, so neither read
      // leaves the source row's 16-byte granules
      const int word = static_cast<int>(mis >> 2);
      const int bits = static_cast<int>(mis & 3) * 8;
#pragma unroll 4
      for (unsigned v = v0 + threadIdx.x; v < v1; v += kThreads)
        vdst[v] = realign(__ldg(a + v), __ldg(a + v + 1), word, bits);
    }
  }
  if (seg == 0) {
    // element by element: the lo pad, the interior's unaligned head and
    // tail (all of it when no aligned vector fits), the hi pad
    const long long vbeg = nvec ? head / kBytes : n_in;
    const long long vend = nvec ? vbeg + 16LL * nvec / kBytes : n_in;
    const long long n_out = p.out_shape[last];
    const long long lead = lo + vbeg;                   // columns [0, lead)
    const long long trail = n_out - (lo + vend);        // columns [lo + vend, n_out)
    T* drow = reinterpret_cast<T*>(dst);
    const T* srow = reinterpret_cast<const T*>(src);
    for (long long k = threadIdx.x; k < lead + trail; k += kThreads) {
      const long long c = k < lead ? k : lo + vend + (k - lead);
      drow[c] = row_element<T>(p, r, srow, c);
    }
  }
}

// The grid cap of the strided kernel: kBlocksPerSm blocks for each SM of the
// current device.
int max_blocks(long long* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = kBlocksPerSm * sms;
  return static_cast<int>(e);
}

// Whether the row kernel takes this pad: a last axis of unit stride (or of
// at most one element), and every count it keeps in 32 bits below 2^31.
bool rows_fit(const Params& p, int elem_bytes) {
  const int last = p.ndim - 1;
  if (p.in_stride[last] != 1 && p.in_shape[last] > 1) return false;
  const long long vectors = p.in_shape[last] * elem_bytes / 16 + 1;
  const long long segments = (vectors + kRowVectors - 1) / kRowVectors;
  return vectors < 0x7fffffffLL && p.rows < 0x7fffffffLL && p.rows * segments < 0x7fffffffLL;
}

template <int kBytes>
int launch(const void* x, void* out, Params& p, cudaStream_t s) {
  using T = typename Element<kBytes>::type;
  const int last = p.ndim - 1;
  if (rows_fit(p, kBytes)) {
    const long long vectors = p.in_shape[last] * kBytes / 16 + 1;  // at most this many a row
    p.segments = (vectors + kRowVectors - 1) / kRowVectors;
    p.seg_len = (vectors + p.segments - 1) / p.segments;
    halo_pad_rows<kBytes><<<static_cast<unsigned>(p.rows * p.segments), kThreads, 0, s>>>(
        static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), p);
    return static_cast<int>(cudaGetLastError());
  }
  const long long n_out = p.out_shape[last];
  p.segments = (n_out + kSegment - 1) / kSegment;
  p.seg_len = (n_out + p.segments - 1) / p.segments;
  long long cap = 0;
  if (const int err = max_blocks(&cap)) return err;
  const long long tiles = p.rows * p.segments;
  halo_pad_strided<T><<<static_cast<unsigned>(tiles < cap ? tiles : cap), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// Read a plan (host int64s, as halo_pad_launch takes it) into p, with the
// fills when given; returns a cudaError_t.
int read_plan(const long long* plan, const void* fills, Params* p) {
  const int ndim = static_cast<int>(plan[0]);
  const int elem_bytes = static_cast<int>(plan[1]);
  if (ndim < 1 || ndim > kMaxRank) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4 && elem_bytes != 8 && elem_bytes != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* in_shape = plan + 2;
  const long long* in_stride = in_shape + ndim;
  const long long* lo = in_stride + ndim;
  const long long* hi = lo + ndim;
  const long long* modes = hi + ndim;
  memset(p, 0, sizeof(*p));
  p->ndim = ndim;
  p->rows = 1;
  const unsigned char* fill_bytes = static_cast<const unsigned char*>(fills);
  for (int a = 0; a < ndim; ++a) {
    if (in_shape[a] < 0 || lo[a] < 0 || hi[a] < 0 || modes[a] < kSymmetric || modes[a] > kConstant)
      return static_cast<int>(cudaErrorInvalidValue);
    if (modes[a] != kConstant && in_shape[a] == 0 && (lo[a] || hi[a]))
      return static_cast<int>(cudaErrorInvalidValue);
    p->in_shape[a] = in_shape[a];
    p->in_stride[a] = in_stride[a];
    p->lo[a] = lo[a];
    p->out_shape[a] = in_shape[a] + lo[a] + hi[a];
    p->mode[a] = static_cast<int>(modes[a]);
    if (a < ndim - 1) p->rows *= p->out_shape[a];
    if (fill_bytes)
      for (int side = 0; side < 2; ++side)
        for (int b = 0; b < 16; b += elem_bytes)  // the element repeated over 16 bytes
          memcpy(p->fill[a][side] + b, fill_bytes + (2 * a + side) * elem_bytes, elem_bytes);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" {

// x: a rank-ndim array on the device; out: a contiguous buffer on the
// device of shape in_shape + lo + hi.  plan: host int64s, [ndim, elem_bytes,
// in_shape[ndim], in_stride[ndim] (elements), lo[ndim], hi[ndim],
// mode[ndim]] with modes 0 symmetric, 1 reflect, 2 edge, 3 wrap,
// 4 constant; an index-map mode needs in_shape > 0 where it pads.  fills:
// host bytes, ndim * 2 * elem_bytes, [axis][lo side, hi side], read for
// constant axes.  elem_bytes is 1, 2, 4, 8 or 16 and both pointers are
// aligned to it.  Returns a cudaError_t.
int halo_pad_launch(const void* x, void* out, const long long* plan, const void* fills, void* stream) {
  Params p;
  if (const int err = read_plan(plan, fills, &p)) return err;
  if (p.rows == 0 || p.out_shape[p.ndim - 1] == 0) return static_cast<int>(cudaSuccess);  // nothing to write
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan[1]) {
    case 1: return launch<1>(x, out, p, s);
    case 2: return launch<2>(x, out, p, s);
    case 4: return launch<4>(x, out, p, s);
    case 8: return launch<8>(x, out, p, s);
    default: return launch<16>(x, out, p, s);
  }
}

// Which kernel halo_pad_launch takes for a plan: 1 the row kernel, 0 the
// strided kernel; -1 for a plan it refuses.
int halo_pad_kernel_for(const long long* plan) {
  Params p;
  if (read_plan(plan, nullptr, &p)) return -1;
  return rows_fit(p, static_cast<int>(plan[1])) ? 1 : 0;
}

const char* halo_pad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

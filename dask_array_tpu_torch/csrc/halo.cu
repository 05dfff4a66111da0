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
// computes only addresses.  Each block takes one segment of one output row:
// the row's leading coordinates are mapped once, a row inside a constant pad
// is written as fill, and the threads walk the last axis, so the interior is
// a coalesced copy and only the few pad columns are mapped.  The Pallas grid
// ran bands in order on one core; here many row segments run on all SMs, and
// no halo view, select or concatenation is needed.
//
// A pad moves bytes, so the kernel is templated on the element's size (1, 2,
// 4, 8 and 16 bytes) and every dtype of the port goes through it; a fill
// arrives as the bytes of the value already converted to the dtype.  The
// wrapper merges adjacent unpadded axes, so rank up to 8 is enough; the
// input's strides are parameters, so a sliced view is read in place.
// Offsets are 64-bit and tiles are numbered on gridDim.x with a grid-stride
// loop, so no grid dimension limits the shape.  Launches on the caller's
// stream; halo_pad_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxRank = 8;
constexpr int kThreads = 256;
constexpr long long kSegment = 8192;  // most output elements a tile holds
constexpr long long kBlocksPerSm = 32;  // the grid holds this many blocks per SM; they loop beyond

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
  long long seg_len;   // output elements per tile (the last one may be short)
  alignas(16) unsigned char fill[kMaxRank][2][16];  // [axis][side] bytes
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_pad_rows(const T* __restrict__ x, T* __restrict__ out, const __grid_constant__ Params p) {
  const int last = p.ndim - 1;
  const long long n_out = p.out_shape[last];
  const long long n_in = p.in_shape[last];
  const long long lo = p.lo[last];
  const long long stride = p.in_stride[last];
  const int mode = p.mode[last];
  const T fill_lo = load_fill<T>(p, last, 0);
  const T fill_hi = load_fill<T>(p, last, 1);
  const long long tiles = p.rows * p.segments;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row = t / p.segments;
    const long long seg = t - row * p.segments;

    // map the row's leading coordinates once (axis last-1 varies fastest);
    // the first constant pad met from the highest axis down gives the fill
    long long rem = row;
    long long src = 0;
    int const_axis = -1;
    int const_side = 0;
    for (int a = last - 1; a >= 0; --a) {
      const long long o = rem % p.out_shape[a];
      rem /= p.out_shape[a];
      const long long i = o - p.lo[a];
      if (i >= 0 && i < p.in_shape[a]) {
        src += i * p.in_stride[a];
      } else if (p.mode[a] == kConstant) {
        if (const_axis < 0) {
          const_axis = a;
          const_side = i >= 0;
        }
      } else {
        src += map_index(i, p.in_shape[a], p.mode[a]) * p.in_stride[a];
      }
    }

    T* dst = out + row * n_out;
    const long long c0 = seg * p.seg_len;
    const long long c1 = c0 + p.seg_len < n_out ? c0 + p.seg_len : n_out;
    if (const_axis >= 0) {
      // a row inside a constant pad: its fill, except where the last axis's
      // own constant pad (the highest axis) covers the column
      const T v = load_fill<T>(p, const_axis, const_side);
      for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) {
        const long long i = c - lo;
        if (mode == kConstant && i < 0) {
          dst[c] = fill_lo;
        } else if (mode == kConstant && i >= n_in) {
          dst[c] = fill_hi;
        } else {
          dst[c] = v;
        }
      }
    } else {
      const T* srow = x + src;
      for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) {
        const long long i = c - lo;
        if (i >= 0 && i < n_in) {
          dst[c] = srow[i * stride];
        } else if (mode == kConstant) {
          dst[c] = i < 0 ? fill_lo : fill_hi;
        } else {
          dst[c] = srow[map_index(i, n_in, mode) * stride];
        }
      }
    }
  }
}

// The grid cap: kBlocksPerSm blocks for each SM of the current device.
int max_blocks(long long* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = kBlocksPerSm * sms;
  return static_cast<int>(e);
}

template <int kBytes>
int launch(const void* x, void* out, const Params& p, cudaStream_t s) {
  using T = typename Element<kBytes>::type;
  long long cap = 0;
  if (const int err = max_blocks(&cap)) return err;
  const long long tiles = p.rows * p.segments;
  const long long blocks = tiles < cap ? tiles : cap;
  halo_pad_rows<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: a rank-ndim array on the device with element strides in_stride;
// out: a contiguous buffer on the device of shape in_shape + lo + hi.
// modes: 0 symmetric, 1 reflect, 2 edge, 3 wrap, 4 constant, per axis; an
// index-map mode needs in_shape > 0 where it pads.  fills: host bytes,
// ndim * 2 * elem_bytes, [axis][lo side, hi side], read for constant axes.
// elem_bytes is 1, 2, 4, 8 or 16 and both pointers are aligned to it.
// Returns a cudaError_t.
int halo_pad_launch(const void* x, void* out, int ndim, const long long* in_shape,
                    const long long* in_stride, const long long* lo, const long long* hi,
                    const int* modes, const void* fills, int elem_bytes, void* stream) {
  if (ndim < 1 || ndim > kMaxRank) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4 && elem_bytes != 8 && elem_bytes != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  memset(&p, 0, sizeof(p));
  p.ndim = ndim;
  p.rows = 1;
  const unsigned char* fill_bytes = static_cast<const unsigned char*>(fills);
  for (int a = 0; a < ndim; ++a) {
    if (in_shape[a] < 0 || lo[a] < 0 || hi[a] < 0 || modes[a] < kSymmetric || modes[a] > kConstant)
      return static_cast<int>(cudaErrorInvalidValue);
    if (modes[a] != kConstant && in_shape[a] == 0 && (lo[a] || hi[a]))
      return static_cast<int>(cudaErrorInvalidValue);
    p.in_shape[a] = in_shape[a];
    p.in_stride[a] = in_stride[a];
    p.lo[a] = lo[a];
    p.out_shape[a] = in_shape[a] + lo[a] + hi[a];
    p.mode[a] = modes[a];
    if (a < ndim - 1) p.rows *= p.out_shape[a];
    for (int side = 0; side < 2; ++side)
      memcpy(p.fill[a][side], fill_bytes + (2 * a + side) * elem_bytes, elem_bytes);
  }
  const long long n_out = p.out_shape[ndim - 1];
  if (p.rows == 0 || n_out == 0) return static_cast<int>(cudaSuccess);  // nothing to write
  p.segments = (n_out + kSegment - 1) / kSegment;
  p.seg_len = (n_out + p.segments - 1) / p.segments;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch<1>(x, out, p, s);
    case 2: return launch<2>(x, out, p, s);
    case 4: return launch<4>(x, out, p, s);
    case 8: return launch<8>(x, out, p, s);
    case 16: return launch<16>(x, out, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* halo_pad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

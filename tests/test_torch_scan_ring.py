"""K3's ring (``csrc/scan.cu``) run on the CPU: the kernel's own source,
compiled with g++ as host code under a shim that emulates the CUDA names
it uses, held to the plain version byte for byte.

The shim runs each block's threads as host threads, one block after the
other; an mbarrier is a count of arrivals with a phase, a 16-byte
asynchronous copy a copy made at once (refused unless 16-byte aligned),
its arrival an arrival, ``__syncwarp`` a barrier of the warp's 32
threads; the native 2-byte ops are the
float32 op rounded to the type (the same bytes: ``test_torch_scan_kernel``
pins the rounding fact, ``tests/test_torch_gpu.py`` every pair on the
card).  So this checks what the host can: the launch plan's numbers as the
kernel reads them, the units, tiles, slots and envelopes, the first step's
copy, the NaN rule off the carry's chain, the ring's phases across units,
aligned and unaligned stores, and that nothing is written outside the
output.  Timing, the memory model and the card's own ops are the card's
to check.
"""

import ctypes
import re
import shutil
import subprocess

import ml_dtypes
import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch._chunks import tensor_of
from dask_array_tpu_torch.kernels import _build, scan

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to build the host shim")

_SHIM = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <condition_variable>
#include <functional>
#include <map>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct dim3_ { unsigned x = 0; };
inline thread_local dim3_ threadIdx, blockIdx;
inline dim3_ blockDim, gridDim;
inline thread_local uint8_t* emu_smem;
struct uint4 { unsigned x, y, z, w; };
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef struct CUstream_st* cudaStream_t;
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "refused"; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline std::mutex g_m;
inline std::condition_variable g_cv;
inline int g_count = 0, g_gen = 0;
inline void __syncthreads() {
  std::unique_lock<std::mutex> lk(g_m);
  int gen = g_gen;
  if (++g_count == (int)blockDim.x) { g_count = 0; ++g_gen; g_cv.notify_all(); }
  else g_cv.wait(lk, [&] { return g_gen != gen; });
}
struct Bar { int count = 0, pending = 0; unsigned phase = 0; };
inline std::map<uintptr_t, Bar> g_bars;
inline void fail(const char* what) { fprintf(stderr, "%s\n", what); abort(); }
inline void settle(Bar& b) { if (b.pending == 0) { b.phase++; b.pending = b.count; } }
inline void bar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> lk(g_m); Bar& b = g_bars[(uintptr_t)bar]; b = Bar(); b.count = b.pending = count;
}
inline void bar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lk(g_m); Bar& b = g_bars.at((uintptr_t)bar);
  if (b.pending <= 0) fail("an arrival past the count"); b.pending--; settle(b);
}
inline void bar_wait(uint64_t* bar, uint32_t parity) {
  for (;;) {
    { std::lock_guard<std::mutex> lk(g_m); if ((g_bars.at((uintptr_t)bar).phase & 1u) != parity) return; }
    std::this_thread::yield();
  }
}
inline void cp_async16(void* dst, const void* src) {
  if (((uintptr_t)dst | (uintptr_t)src) % 16) fail("a 16-byte copy off 16 bytes");
  std::lock_guard<std::mutex> lk(g_m); memcpy(dst, src, 16);
}
inline void cp_async_arrive(uint64_t* bar) { bar_arrive(bar); }
inline std::map<unsigned, std::pair<int, int>> g_warps;  // a warp's arrivals and generation
inline void __syncwarp(unsigned = 0xffffffffu) {
  std::unique_lock<std::mutex> lk(g_m);
  auto& w = g_warps[threadIdx.x / 32];
  int gen = w.second;
  if (++w.first == 32) { w.first = 0; ++w.second; g_cv.notify_all(); }
  else g_cv.wait(lk, [&] { return w.second != gen; });
}
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline int __shfl_sync(unsigned, int v, int) { return v; }  // every caller passes a warp-uniform value
template <class T> T __ldg(const T* p) { return *p; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {  // PRMT: byte n of the result is byte s[n] of (y:x)
  unsigned long long v = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline void fence_bar_init() { std::lock_guard<std::mutex> lk(g_m); }
inline void emu_launch(long long grid, int threads, int smem, cudaStream_t, std::function<void()> fn) {
  gridDim.x = (unsigned)grid; blockDim.x = threads;
  for (long long b = 0; b < grid; ++b) {
    uint8_t* buf = (uint8_t*)aligned_alloc(128, (smem + 255) / 128 * 128);
    memset(buf, 0xA5, smem);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b] { threadIdx.x = t; blockIdx.x = (unsigned)b; emu_smem = buf; fn(); });
    for (auto& th : ts) th.join();
    free(buf);
    g_bars.clear();
    g_warps.clear();
  }
}
// the native ops as the float32 op rounded to the type
inline float f16_value(uint16_t h) { _Float16 f; memcpy(&f, &h, 2); return (float)f; }
inline uint16_t f16_round(float f) { _Float16 h = (_Float16)f; uint16_t r; memcpy(&r, &h, 2); return r; }
inline float bf16_value(uint16_t h) { uint32_t u = (uint32_t)h << 16; float f; memcpy(&f, &u, 4); return f; }
inline uint16_t bf16_round(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fff;
  u += 0x7fffu + ((u >> 16) & 1u); return (uint16_t)(u >> 16);
}
inline uint16_t emu_add_f16(uint16_t a, uint16_t b) { return f16_round(f16_value(a) + f16_value(b)); }
inline uint16_t emu_mul_f16(uint16_t a, uint16_t b) { return f16_round(f16_value(a) * f16_value(b)); }
inline uint16_t emu_add_bf16(uint16_t a, uint16_t b) { return bf16_round(bf16_value(a) + bf16_value(b)); }
inline uint16_t emu_mul_bf16(uint16_t a, uint16_t b) { return bf16_round(bf16_value(a) * bf16_value(b)); }
"""


# the 1-byte step with its table read through a host pointer (the kernel's
# reads it by a shared-memory address in PTX)
_ONE_BYTE = """struct OneByte {
  using T = uint8_t;
  static constexpr bool kNaN = false;
  static constexpr int kTable = kTableBytes;
  static constexpr T kDefaultNaN = 0;
  const uint8_t* tab;
  explicit OneByte(const uint8_t* shared) : tab(shared) {}
  T operator()(T s, T x) const { return tab[(static_cast<unsigned>(s) << 8) | x]; }
  static bool nan(T) { return false; }
  static T quiet(T h) { return h; }
};"""


def host_source(src: str) -> str:
    """``scan.cu`` for the shim: its PTX helpers, CUDA headers, shared
    declarations, native ops and launches swapped for the shim's."""
    subs = [
        (r"// -{10,}\n// barriers and asynchronous copies \(sm_90\).*?(?=// -{10,})", ""),
        (r"#include <cuda_(bf16|fp16|runtime)\.h>\n", ""),
        (r"extern __shared__ __align__\(128\) uint8_t smem\[\];", "uint8_t* smem = emu_smem;"),
        (r'asm\("(add|mul)\.rn\.(f16|bf16) %0, %1, %2;" : "=h"\(r\) : "h"\(a\), "h"\(b\)\);', r"r = emu_\1_\2(a, b);"),
        (r'asm\("mov\.b32 \{%0, %1\}, %2;" : "=h"\(lo\), "=h"\(hi\) : "r"\(w\)\);',
         "lo = static_cast<uint16_t>(w); hi = static_cast<uint16_t>(w >> 16);"),
        (r'asm\("mov\.b32 %0, \{%1, %2\};" : "=r"\(w\) : "h"\(lo\), "h"\(hi\)\);',
         "w = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);"),
        (r"(\w+<\w+>)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, [&] { \1(\3); });"),
        (r"struct OneByte \{.*?\n\};", _ONE_BYTE),
    ]
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n > 0, f"the shim no longer matches {pattern!r}"
    assert "asm" not in src and "<<<" not in src
    return _SHIM + src


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """The shim build of ``csrc/scan.cu``: its C entry point."""
    tmp = tmp_path_factory.mktemp("scan_ring")
    (tmp / "scan_host.cpp").write_text(host_source((_build.CSRC / "scan.cu").read_text()))
    lib = tmp / "libscan_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-pthread", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(lib),
                    str(tmp / "scan_host.cpp")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).scan_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, ll, ll, ll, i, i, ctypes.POINTER(ll), p]
    fn.restype = i
    return fn


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def aligned_buffer(nbytes, offset, fill):
    """A numpy byte buffer with a view of ``nbytes`` starting ``offset``
    bytes past a 16-byte boundary, 16 bytes of ``fill`` either side."""
    buf = np.full(nbytes + 64, fill, dtype=np.uint8)
    start = (-buf.ctypes.data) % 16 + 16 + offset
    return buf, start


def ring_scan(ring, x, kind, axis, sms=4, offsets=(0, 0), force=None):
    """K3's ring on the host: ``x`` scanned along ``axis`` with the plan
    ``launch_plan`` gives a card of ``sms`` SMs (or ``force`` of it),
    input and output ``offsets`` bytes past a 16-byte boundary."""
    dt = x.dtype
    es = dt.itemsize
    P, L, Q = scan.scan_plan(x.shape, axis)
    xbuf, xa = aligned_buffer(x.nbytes, offsets[0], 0)
    obuf, oa = aligned_buffer(x.nbytes, offsets[1], 0xEE)
    xbuf[xa:xa + x.nbytes] = np.ascontiguousarray(x).view(np.uint8).reshape(-1)
    xp, op = xbuf.ctypes.data + xa, obuf.ctypes.data + oa
    plan = scan.launch_plan(P, L, Q, es, sms, xp, op)
    if force is not None:
        plan = force(plan)
    code = scan.scan_type(dt)
    table = tp = None
    if code == 2:
        table, ta = aligned_buffer(scan.TABLE_BYTES, 0, 0)
        table[ta:ta + scan.TABLE_BYTES] = scan.step_table(dt, kind).numpy()
        tp = table.ctypes.data + ta
    err = ring(xp, op, tp, P, L, Q, code, 0 if kind.endswith("cumsum") else 1, plan.fields(), None)
    assert err == 0
    assert (obuf[:oa] == 0xEE).all() and (obuf[oa + x.nbytes:] == 0xEE).all(), "a write outside the output"
    return obuf[oa:oa + x.nbytes].copy(), plan


def ring_data(name, kind, shape, seed):
    """Normals (near 1 for products, times 300 for sums) with NaNs of both
    signs and two payloads, ±inf, ±0 and the smallest subnormals planted
    (the 1-byte types' NaN, ±inf where they have it and ±0)."""
    dt = np.dtype(np.float16) if name == "float16" else np.dtype(getattr(ml_dtypes, name))
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape)
    x = (1 + v / 64 if kind == "cumprod" else v * 300).astype(dt)
    flat = x.reshape(-1)
    if dt.itemsize == 2:
        half = dt == np.float16
        specials = [0x7E01 if half else 0x7FC1, 0xFD55 if half else 0xFFD5, 0x7C00 if half else 0x7F80,
                    0xFC00 if half else 0xFF80, 0x0000, 0x8000, 0x0001, 0x8001]
        bits = flat.view(np.uint16)
    else:
        specials = [int(b) for b in np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], dt).view(np.uint8)]
        bits = flat.view(np.uint8)
    for k, b in enumerate(specials):
        bits[rng.integers(0, flat.size, max(1, flat.size // 400))] = b
        bits[(k * 7919) % flat.size] = b
    return x


def _depth(shape, axis, es):
    p, _, q = scan.scan_plan(shape, axis)
    return scan.launch_plan(p, 10**7, q, es, 4).depth


# (shape, axis): column chains (strips ragged, narrower than a warp, P > 1,
# rows not 16-byte aligned), row chains (one a block, several, unaligned),
# one chain, L of 1 and 2, L one more than a stage
RING_SHAPES = [((300, 70), 0), ((300, 70), 1), ((45, 130), 1), ((5, 300, 7), 1), ((2100,), 0), ((6, 700, 40), 1),
               ((300, 200), 0), ((1, 300), 0), ((2, 300), 0), ((64, 333), 1), ((16, 4096), 1), ((3000, 16), 0),
               ((40, 1000, 1), 1), ((130, 256), 1)]
RING_TYPES = ["float16", "bfloat16", "float8_e4m3fn", "float8_e5m2"]


@pytest.mark.parametrize("kind", ["cumsum", "cumprod"])
@pytest.mark.parametrize("name", RING_TYPES)
def test_ring_equals_the_plain_version(ring, name, kind):
    for k, (shape, axis) in enumerate(RING_SHAPES):
        x = ring_data(name, kind, shape, seed=k)
        want = scan.rounded_scan_plain(tensor_of(x), kind, axis, x.dtype).view(
            torch.int16 if x.itemsize == 2 else torch.uint8).numpy().view(np.uint8).reshape(-1)
        for sms, offsets in ((4, (0, 0)), (132, (0, 0)), (4, (2, 0)), (4, (0, 6))):
            got, plan = ring_scan(ring, x, kind, axis, sms=sms, offsets=offsets)
            assert np.array_equal(got, want), (shape, axis, sms, offsets, plan)


@pytest.mark.parametrize("es", [2, 1])
def test_ring_tiles_one_past_a_stage(ring, es):
    """Chains one step longer than a tile: two tiles, the second of one
    step, along columns and rows."""
    name = "float16" if es == 2 else "float8_e4m3fn"
    for shape, axis in (((_depth((1, 64), 0, es) + 1, 64), 0), ((20, _depth((20, 1), 1, es) + 1), 1)):
        x = ring_data(name, "cumsum", shape, seed=3)
        want = scan.rounded_scan_plain(tensor_of(x), "cumsum", axis, x.dtype).view(
            torch.int16 if es == 2 else torch.uint8).numpy().view(np.uint8).reshape(-1)
        got, plan = ring_scan(ring, x, "cumsum", axis)
        assert plan.tiles == 2 and np.array_equal(got, want)


def test_ring_refuses_a_plan_it_cannot_take(ring):
    """The entry point takes the host's plan whole and refuses one that
    breaks an invariant the kernel relies on."""
    buf, start = aligned_buffer(256, 0, 0)
    xp = op = buf.ctypes.data + start
    plan = scan.launch_plan(1, 64, 1, 2, 4, xp, op)
    assert ring(xp, op, None, 1, 64, 1, 0, 0, plan.fields(), None) == 0

    def tampered(**fields):
        values = list(plan.fields())
        for name, value in fields.items():
            values[FIELDS.index(name)] = value
        return (ctypes.c_longlong * len(values))(*values)

    for bad in (plan._replace(depth=60).fields(),  # rows: a slot of 120 bytes, not whole 16-byte words
                plan._replace(stages=9).fields(),  # more stages than the kernel keeps
                plan._replace(depth=64 * 2048).fields(),  # a stage past the shared memory
                plan._replace(grid=2).fields(),  # a grid past the units
                plan._replace(width=300, units=1).fields(),  # more consumers than the kernel's threads
                tampered(pitch=plan.depth * 2),  # no room for a slot's envelope
                tampered(slots=2),  # slots that are not the unit's rows
                tampered(units=2, grid=2),  # units the block does not have
                tampered(tiles=2),  # tiles the chain does not have
                tampered(smem=plan.smem - 16),  # shared memory short of the stages and barriers
                tampered(consumers=48),  # consumers not whole warps
                tampered(mode=3)):
        assert ring(xp, op, None, 1, 64, 1, 0, 0, bad, None) != 0
    assert ring(xp, op, None, 1, 64, 1, 2, 0, plan.fields(), None) != 0  # a 1-byte type without its table
    assert ring(xp + 2, op, None, 1, 64, 1, 0, 0, plan.fields(), None) != 0  # "aligned" on a pointer off 16 bytes
    table, ta = aligned_buffer(scan.TABLE_BYTES, 0, 0)
    tp = table.ctypes.data + ta
    rows = scan.launch_plan(3, 64, 1, 1, 4, xp, op)._replace(batches=True, grid=1)
    assert ring(xp, op, tp, 3, 64, 1, 2, 0, rows.fields(), None) == 0
    assert ring(xp, op, None, 3, 64, 1, 0, 0, rows.fields(), None) != 0  # the row-batch route takes 1-byte types,
    assert ring(xp, op, tp, 3, 60, 1, 2, 0, rows.fields(), None) != 0  # rows of whole 16-byte words,
    assert ring(xp, op, tp, 3, 64, 1, 2, 0, rows._replace(grid=2).fields(), None) != 0  # a block a 128 rows


FIELDS = ["mode", "width", "depth", "slots", "pitch", "stages", "consumers", "aligned", "units", "tiles", "smem",
          "grid"]


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_ring_row_batch_route(ring, name):
    """A lone 1-byte row takes the row-batch route (a thread a row read
    from memory in register batches); more rows, each alone in a unit of
    the ring, do not.  Forced, the route also scans 130 rows over two
    blocks and rows that end inside a batch (as ``scripts/time_scan.py``
    times it against the ring)."""
    for shape in ((4096,), (130, 400), (3, 16 * 37)):
        x = ring_data(name, "cumsum", shape, seed=len(shape))
        axis = len(shape) - 1
        want = scan.rounded_scan_plain(tensor_of(x), "cumsum", axis, x.dtype).view(torch.uint8).numpy().reshape(-1)
        got, plan = ring_scan(ring, x, "cumsum", axis, sms=1000)
        assert plan.batches == (len(shape) == 1) and plan.width == 1 and np.array_equal(got, want), (shape, plan)
        got, plan = ring_scan(ring, x, "cumsum", axis, sms=1000, force=scan.row_batch_plan)
        assert plan.mode == 2 and np.array_equal(got, want), (shape, plan)

"""K3, the step-rounded scan of 2-byte and 1-byte floats, with its plain
PyTorch version.

Counterpart of the JAX package's dense scan, ``jnp.cumsum`` /
``jnp.cumprod`` in ``CumReduction._build``
(``dask_array_tpu/ops/reductions.py:831-845``), for the result types whose
scan numpy rounds to the type after every step: float16, bfloat16 (each
step a float32 add or multiply, rounded to the type) and the 1-byte floats
(torch's float8 types and the narrow float carriers of ``_narrow``: each
step a lookup in the type's 256 x 256 table of rounded results).  A torch
scan carries float32 and rounds once, so it gives other bytes.

A block is viewed as ``(P, L, Q)`` around the scanned axis (``scan_plan``):
``P * Q`` independent chains of ``L`` steps, each
``out[0] = x[0]`` and ``out[i] = step(out[i - 1], x[i])``.  A 2-byte step
makes a NaN by numpy's rule on x86-64, not by a conversion's: a NaN term's
bits quieted where the term is NaN, else the running value's bits quieted,
else (inf - inf, 0 * inf) the negative default NaN.  float16 quiets by
setting the payload's top bit, bfloat16 by the sign and 0x7fc0 (ml_dtypes
drops the payload).  Since NaN is absorbing along a scan, that is one rule
applied to the outputs: a NaN output holds the quieted bits of the last
NaN term at or before it, or the default NaN where none is.

The kernel (``csrc/scan.cu``) keeps a 2-byte carry in its type and takes
one native ``add.rn``/``mul.rn`` a step (float32 holds at least 2p + 2 bits
of the type's p, so the float32 op rounded to the type is the once-rounded
result), with the NaN rule off the carry's chain.  One producer warp stages the
terms through a ring of shared-memory stages with 16-byte asynchronous
copies that complete on the stages' mbarriers; consumer threads scan a
chain each out of the stage and store the outputs (a column chain's
straight from registers, a warp's row chains' from the stage in 16-byte
words).  ``launch_plan`` picks the chains a block takes, the steps a tile
and the stages, on the host, and passes the plan whole; the kernel only
checks it.  A lone 1-byte row takes a register-batch route instead (one
thread reads its row straight from memory), the one shape where the ring
is slower.

- ``rounded_scan_plain(held, kind, axis, dtype)`` is a loop over ``L`` in
  torch ops, every chain at once;
- ``rounded_scan_cuda(...)`` launches the CUDA kernel and counts
  ``LAUNCHES``;
- ``rounded_scan(...)`` runs the plain version for a CPU tensor and the
  kernel for a CUDA tensor, with no fallback between them;
- ``step_chain_cuda(...)`` runs one thread's dependent chain of the
  kernel's step (the latency a step costs a long chain).

``kind`` is ``cumsum``, ``cumprod``, ``nancumsum`` or ``nancumprod``; the
nan-scans' replacement of NaN terms happens before (``CumReduction``), so
here a nan-scan steps as its scan.  ``dtype`` is the block's numpy dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dask_array_tpu_torch.kernels._build import Launcher

# kernel launches since the last reset; only rounded_scan_cuda adds to it
LAUNCHES = 0

# the kernel's type codes, and each 2-byte type's NaN rule as int16 bits:
# (the bits a quieted NaN sets, the bits it keeps, the default NaN)
_HALF, _BFLOAT, _BYTE = 0, 1, 2
_NAN_RULES = {
    torch.float16: (0x0200, -1, -512),  # h | 0x0200; 0xfe00
    torch.bfloat16: (0x7FC0, -32768, -64),  # (h & 0x8000) | 0x7fc0; 0xffc0
}


def scan_plan(shape, axis):
    """``(P, L, Q)`` of a scan of a block of ``shape`` along ``axis``."""
    shape = tuple(shape)
    return math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:])


def scan_type(dtype) -> int | None:
    """The kernel's type code of numpy dtype ``dtype`` (float16, bfloat16
    or a 1-byte float), or None when K3 does not scan it."""
    from dask_array_tpu_torch._chunks import format_of, is_narrow

    dtype = np.dtype(dtype)
    if dtype == np.float16:
        return _HALF
    if dtype.name == "bfloat16":
        return _BFLOAT
    fmt = format_of(dtype)
    if is_narrow(dtype) and (fmt is None or fmt.is_float):
        return _BYTE
    return None


def _code(held, kind, dtype) -> int:
    """The kernel's type code of ``held``; raises on a block or a scan
    neither version takes."""
    if kind not in ("cumsum", "cumprod", "nancumsum", "nancumprod"):
        raise ValueError(f"rounded_scan: unknown scan {kind!r}")
    code = scan_type(dtype)
    if code is None or held.element_size() != (1 if code == _BYTE else 2) or \
            (code != _BYTE and held.dtype not in _NAN_RULES):
        raise TypeError(f"rounded_scan takes float16, bfloat16 or a 1-byte float block, got {held.dtype} "
                        f"({np.dtype(dtype)})")
    return code


@functools.lru_cache(maxsize=None)
def step_table(dtype, kind) -> torch.Tensor:
    """The 256 x 256 table of a 1-byte float type's rounded sums (products)
    of two patterns, ``table[running * 256 + term]`` (uint8, on the CPU).
    It is made from the type's own conversions on the CPU, so a NaN's sign
    (which a CPU and a card propagate differently) is the same wherever the
    table is used."""
    from dask_array_tpu_torch._chunks import as_stored, to_compute, torch_dtype

    held = torch_dtype(dtype)
    vals = to_compute(torch.arange(256, dtype=torch.int32).to(torch.uint8).view(held), dtype)
    step = torch.add if kind.endswith("cumsum") else torch.mul
    return as_stored(step(vals[:, None], vals[None, :]), dtype).view(torch.uint8).reshape(-1).contiguous()


@functools.lru_cache(maxsize=None)
def device_table(dtype, kind, device) -> torch.Tensor:
    """``step_table`` on ``device`` (cached there)."""
    return step_table(dtype, kind).to(device)


@functools.lru_cache(maxsize=None)
def _shifted_table(dtype, kind, device) -> torch.Tensor:
    """``step_table`` as int32 patterns times 256 on ``device``: a running
    value held so is its own row of the table."""
    return device_table(dtype, kind, device).to(torch.int32) << 8


def _byte_scan_plain(held, kind, axis, dtype):
    """The table scan: a running row of patterns times 256 (its row of the
    table, int32), one add of the terms and one ``index_select`` a step."""
    table = _shifted_table(np.dtype(dtype), kind, held.device)
    codes = held.view(torch.uint8).movedim(axis, 0)
    runs = torch.empty(codes.shape, dtype=torch.int32, device=held.device)
    flat = runs.reshape(codes.shape[0], -1)
    terms = codes.reshape(codes.shape[0], -1)
    flat[0] = terms[0].to(torch.int32) << 8
    index = torch.empty_like(flat[0])
    for i in range(1, codes.shape[0]):
        torch.add(terms[i], flat[i - 1], out=index)
        torch.index_select(table, 0, index, out=flat[i])
    return (runs >> 8).to(torch.uint8).movedim(0, axis).contiguous().view(held.dtype)


def _float_scan_plain(held, kind, axis):
    """The 2-byte scan: values stepped in float32 and rounded into the
    output row by row, then every NaN's bits set by the rule at once (a NaN
    output holds the quieted bits of the last NaN term at or before it, or
    the default NaN where none is)."""
    quiet, keep, default = _NAN_RULES[held.dtype]
    step = torch.add if kind.endswith("cumsum") else torch.mul
    out = torch.empty_like(held, memory_format=torch.contiguous_format)
    terms = held.movedim(axis, 0)
    rows = out.movedim(axis, 0)
    values = terms.float()
    rows[0] = terms[0]
    prev = values[0]
    for i in range(1, terms.shape[0]):
        rows[i] = step(prev, values[i])
        prev = rows[i].float()
    bits, term_bits = rows.view(torch.int16), terms.view(torch.int16)
    index = torch.arange(terms.shape[0], device=held.device).reshape((-1,) + (1,) * (terms.ndim - 1))
    last = torch.where(torch.isnan(terms), index, -1).cummax(0).values
    source = torch.gather(term_bits, 0, last.clamp(min=0))
    nan_bits = torch.where(last >= 0, (source & keep) | quiet, default)
    fixed = torch.where(torch.isnan(rows), nan_bits, bits)
    fixed[0] = term_bits[0]  # the first element is a copy
    bits.copy_(fixed)
    return out


def rounded_scan_plain(held: torch.Tensor, kind: str, axis: int, dtype) -> torch.Tensor:
    """numpy's scan of a held block of numpy dtype ``dtype`` along ``axis``,
    rounded to the type after every step, in torch ops on its device."""
    code = _code(held, kind, dtype)
    if held.numel() == 0:
        return torch.empty_like(held, memory_format=torch.contiguous_format)
    if code == _BYTE:
        return _byte_scan_plain(held, kind, axis, dtype)
    return _float_scan_plain(held, kind, axis)


def rounded_scan(held: torch.Tensor, kind: str, axis: int, dtype) -> torch.Tensor:
    """The step-rounded scan: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if held.device.type == "cpu":
        return rounded_scan_plain(held, kind, axis, dtype)
    return rounded_scan_cuda(held, kind, axis, dtype)


def rounded_scan_cuda(held: torch.Tensor, kind: str, axis: int, dtype) -> torch.Tensor:
    """Launch K3 on a CUDA tensor (made contiguous first); the output is
    contiguous in the input's shape."""
    global LAUNCHES
    if held.device.type != "cuda":
        raise ValueError(f"rounded_scan_cuda needs a CUDA tensor, got one on {held.device}")
    code = _code(held, kind, dtype)
    out = torch.empty_like(held, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    x = held.contiguous()
    p, n, q = scan_plan(x.shape, axis)
    op = 0 if kind.endswith("cumsum") else 1
    index = x.get_device()
    plan = launch_plan(p, n, q, x.element_size(), _sm_count(index), x.data_ptr(), out.data_ptr())
    table = device_table(np.dtype(dtype), kind, x.device) if code == _BYTE else None
    _launcher()(index, x.data_ptr(), out.data_ptr(), None if table is None else table.data_ptr(),
                p, n, q, code, op, plan.fields())
    LAUNCHES += 1
    return out


def step_chain_cuda(terms: torch.Tensor, kind: str, dtype, steps: int) -> torch.Tensor:
    """One thread's dependent chain of ``steps`` (a multiple of 8) of K3's
    step over the terms ``terms[0..7]`` in turn, from ``terms[8]``: the last
    carry, a one-element tensor.  Its time over ``steps`` is the latency
    one step adds to a chain.  Not a scan: ``LAUNCHES`` does not count it."""
    if terms.device.type != "cuda" or terms.numel() < 9:
        raise ValueError("step_chain_cuda takes nine or more terms on a CUDA tensor")
    code = _code(terms, kind, dtype)
    x = terms.contiguous()
    out = torch.empty(1, dtype=x.dtype, device=x.device)
    op = 0 if kind.endswith("cumsum") else 1
    table = device_table(np.dtype(dtype), kind, x.device) if code == _BYTE else None
    _chain_launcher()(x.get_device(), x.data_ptr(), out.data_ptr(), None if table is None else table.data_ptr(),
                      steps, code, op)
    return out


# -- the launch plan (csrc/scan.cu checks it) ------------------------------------

SMEM_LIMIT = 232448  # shared memory a block may take on sm_90 (227 KiB)
SMEM_SM = 233472  # shared memory of an SM (228 KiB); each block also takes 1 KiB
THREADS_SM = 2048  # threads resident on an SM
TABLE_BYTES = 256 * 256  # a 1-byte type's step table, in shared memory
PRODUCER = 32  # the producer warp
MAX_THREADS = 288  # the kernel's __launch_bounds__: 256 consumers and the producer
BATCH_THREADS = 128  # threads a block of the row-batch route
STAGES = 4  # stages of the ring, at most
MAX_DEPTH = 512  # steps a column tile
MAX_SEGMENT = 32768  # bytes of a row a slot holds
STRIP_BYTES = (32, 256)  # bytes a step of a column strip: one sector, up to 256


class Plan(NamedTuple):
    """How K3 covers a ``(P, L, Q)`` block of ``itemsize``-byte elements.

    A unit is the chains one block scans: ``cols``, a strip of ``width``
    neighbouring columns of one p (unit ``u`` is p ``u // strips``, columns
    from ``(u % strips) * width``); else ``width`` neighbouring rows (unit
    ``u`` rows from ``u * width``).  A tile is ``depth`` steps of the unit,
    held in one of ``stages`` shared-memory stages of ``slots`` slots of
    ``pitch`` bytes: a slot is one step of the strip (``slots = depth``), or
    ``depth`` steps of one row (``slots = width``), each a contiguous run of
    the input, copied with its 16-byte-aligned envelope (16 bytes of room).
    Block ``b`` of ``grid`` takes units ``b, b + grid, ...``; its consumer
    thread ``t < width`` scans chain ``t`` of each.  ``aligned``: rows and
    pointers are 16-byte aligned, so a row chain reads its slot and writes
    its outputs in 16-byte words (else element by element).

    ``batches``: the row-batch route instead of the ring, for a lone
    1-byte row with aligned rows (``grid`` blocks of ``BATCH_THREADS``
    threads, a thread a row read straight from memory in register
    batches; the kernel reads only ``mode`` and ``grid``)."""

    cols: bool
    width: int
    depth: int
    stages: int
    itemsize: int
    P: int
    L: int
    Q: int
    units: int
    grid: int
    aligned: bool
    batches: bool = False

    @property
    def mode(self) -> int:
        """The kernel's mode: 0 the ring on row chains, 1 on column chains, 2
        the row-batch route."""
        return 2 if self.batches else int(self.cols)

    @property
    def slots(self) -> int:
        return self.depth if self.cols else self.width

    @property
    def pitch(self) -> int:
        return (self.width if self.cols else self.depth) * self.itemsize + 16

    @property
    def consumers(self) -> int:
        return -(-self.width // 32) * 32

    @property
    def threads(self) -> int:
        return BATCH_THREADS if self.batches else self.consumers + PRODUCER

    @property
    def tiles(self) -> int:
        """Tiles a unit."""
        return -(-self.L // self.depth)

    @property
    def smem(self) -> int:
        """Shared bytes a block: the 1-byte table, the stages and two
        mbarriers a stage."""
        table = TABLE_BYTES if self.itemsize == 1 else 0
        if self.batches:
            return table
        return table + self.stages * self.slots * self.pitch + 16 * self.stages

    def fields(self):
        """The plan as ``scan_launch`` (``csrc/scan.cu``) reads it, in the
        order of its ``Field`` enum: the kernel derives none of it and
        refuses a plan that breaks an invariant it relies on."""
        values = (self.mode, self.width, self.depth, self.slots, self.pitch, self.stages, self.consumers,
                  int(self.aligned), self.units, self.tiles, self.smem, self.grid)
        return (ctypes.c_longlong * len(values))(*values)


def launch_plan(P: int, L: int, Q: int, itemsize: int, sms: int = 132, x_ptr: int = 0, out_ptr: int = 0) -> Plan:
    """K3's launch plan for a ``(P, L, Q)`` block on a card of ``sms`` SMs.

    Column chains (``Q > 1``) go to strips of 256 bytes a step (128 2-byte
    or 256 1-byte chains) where the strips fill at least half the SMs,
    narrower ones down to one 32-byte sector otherwise (128 chains of 1e6
    steps take 8 blocks, not one).  Row chains (``Q == 1``) go 128 rows to
    a block, fewer where that leaves SMs idle (a 1-D scan is one row, one
    thread).  Stages fill the shared memory a block may take beside a
    1-byte table, ``STAGES`` of them, each a whole number of 8-step
    batches (columns) or of 128-byte row segments (rows), no longer than
    the chains need.  A persistent grid of as many blocks as fit the SMs
    walks the units.  A lone 1-byte row (``P == Q == 1``, aligned) takes
    the row-batch route instead, the one shape where the ring is slower:
    ``scripts/time_scan.py`` on an H100, both routes in one call, took a
    2^24-step float8_e4m3fn row in 276.6 ms by the route and 285.5 by the
    ring, but 8 rows of 2^21 steps in 38.99 and 35.71 ms and 64 rows of
    2^18 in 6.562 and 4.481 (the ring gives each row its own SM; the
    route's block of rows shares one)."""
    es = itemsize
    budget = SMEM_LIMIT - (TABLE_BYTES if es == 1 else 0) - 16 * STAGES
    if Q > 1:
        width = min(STRIP_BYTES[1] // es, max(STRIP_BYTES[0] // es, 1 << (Q - 1).bit_length()))
        while width * es > STRIP_BYTES[0] and P * -(-Q // width) < sms // 2:
            width //= 2
        depth = min(MAX_DEPTH, -(-L // 8) * 8, budget // STAGES // (width * es + 16) // 8 * 8)
        units = P * -(-Q // width)
        run = Q * es
    else:
        width = 128
        while width > 1 and -(-P // width) < sms // 2:
            width //= 2
        segment = min(MAX_SEGMENT, -(-L * es // 128) * 128, (budget // STAGES // width - 16) // 128 * 128)
        depth = segment // es
        units = -(-P // width)
        run = L * es
    stages = min(STAGES, -(-L // depth))
    aligned = (x_ptr | out_ptr) % 16 == 0 and run % 16 == 0
    plan = Plan(Q > 1, width, depth, stages, es, P, L, Q, units, 0, aligned)
    if P == 1 and Q == 1 and es == 1 and aligned:
        return row_batch_plan(plan)
    per_sm = max(1, min(THREADS_SM // plan.threads, SMEM_SM // (plan.smem + 1024), 32))
    return plan._replace(grid=min(units, sms * per_sm))


def row_batch_plan(plan: Plan) -> Plan:
    """The row-batch route for the aligned 1-byte rows (``Q == 1``) of
    ``plan``: a block of ``BATCH_THREADS`` rows.  ``launch_plan`` takes it
    for a lone row only; ``scripts/time_scan.py`` times it on more."""
    return plan._replace(batches=True, grid=-(-plan.P // BATCH_THREADS))


def unit_chains(plan: Plan, u: int):
    """``(p, q0, chains)``: unit ``u``'s first chain and how many of its
    ``width`` chains exist (its consumer threads ``t < chains`` scan chain
    ``(p, q0 + t)``, or row ``p + t``)."""
    if plan.cols:
        strips = -(-plan.Q // plan.width)
        p, q0 = divmod(u, strips)
        q0 *= plan.width
        return p, q0, min(plan.width, plan.Q - q0)
    p = u * plan.width
    return p, 0, min(plan.width, plan.P - p)


def slot_runs(plan: Plan, u: int, k: int):
    """``[(slot, first element, elements), ...]``: the runs tile ``k`` of
    unit ``u`` copies into a stage's slots (the producer's copies)."""
    p, q0, chains = unit_chains(plan, u)
    steps = min(plan.depth, plan.L - k * plan.depth)
    if plan.cols:
        return [(i, (p * plan.L + k * plan.depth + i) * plan.Q + q0, chains) for i in range(steps)]
    return [(i, (p + i) * plan.L + k * plan.depth, steps) for i in range(chains)]


def envelope(ptr: int, first: int, n: int, itemsize: int):
    """``(start, bytes, lead)``: the 16-byte-aligned envelope the producer
    takes of ``n`` elements from element ``first`` of an array at ``ptr``;
    the run begins ``lead`` bytes into it."""
    a = ptr + first * itemsize
    start = a & ~15
    return start, ((a + n * itemsize + 15) & ~15) - start, a - start


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return Launcher("scan", "scan_launch", [p, p, p, ll, ll, ll, i, i, ctypes.POINTER(ll)], "scan")


@functools.lru_cache(maxsize=None)
def _chain_launcher():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return Launcher("scan", "scan_floor_launch", [p, p, p, ll, i, i], "scan step chain")

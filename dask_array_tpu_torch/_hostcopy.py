"""Host <-> card copies through bounded rings of pinned staging buffers.

A copy from pageable host memory blocks the host for its whole length, and
the CUDA runtime stages it through buffers of its own.  Here every host leaf goes
up, and every result comes back, through a ring of a few pinned buffers per
device and direction (``SLOTS`` of ``SLOT_BYTES``), each direction on a copy
stream of its own:

* **up** (``upload``): the host fills slot *k* from the source (a strided
  source is gathered in the same pass) while the card copies slot *k-1*; a
  slot is refilled only after the event of its previous copy.  The
  destination is allocated on the copy stream, the compute stream waits on
  the copy's event, and the tensor is recorded on the compute stream, so
  the caching allocator reuses its memory only after the work that reads
  it.  The host returns as soon as the last piece is queued.
* **down** (``fetch_into``): after the event of the work that made the
  tensor, the card copies pieces into the slots and the host drains each
  slot into a preallocated numpy result as its event completes.

The pinned memory is allocated once per device and direction and stays in
the rings: no numpy array returned to a caller is pinned, and the caching
host allocator is never asked for more than the rings hold.  A pinned
buffer that cannot be had raises; nothing falls back to a pageable copy.
The bytes that move are those of ``torch.from_numpy(x).to(device)`` and
``t.cpu().numpy()``, piece by piece.
"""

from __future__ import annotations

import collections
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dask_array_tpu_torch._chunks import array_of, tensor_of
from dask_array_tpu_torch._spans import call

SLOT_BYTES = 32 << 20
SLOTS = 4
# host threads that copy a piece between a slot and the caller's array: one
# thread copies at about 10 GB/s into warm memory and much slower into a
# fresh result, whose first touch faults its pages in; several share both
COPY_THREADS = min(8, os.cpu_count() or 1)
_MIN_PART = 1 << 20

# bytes and pieces moved, per direction (tests and the chip smoke read them)
COPIES = {"h2d_bytes": 0, "d2h_bytes": 0, "h2d_pieces": 0, "d2h_pieces": 0}

_rings: dict = {}
_rings_lock = threading.Lock()
_pool = None


class _Ring:
    """``SLOTS`` pinned buffers, their last copies' events and one copy
    stream, for one device and one direction."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slot_bytes = SLOT_BYTES
        self.slots = [torch.empty(SLOT_BYTES, dtype=torch.uint8, pin_memory=True) for _ in range(SLOTS)]
        self.views = [s.numpy() for s in self.slots]
        self.events = [torch.cuda.Event() for _ in range(SLOTS)]
        self.next = 0
        self.lock = threading.Lock()

    def take(self) -> int:
        """The next slot, once its previous copy has completed."""
        i = self.next
        self.next = (i + 1) % SLOTS
        self.events[i].synchronize()
        return i


def _ring(device: torch.device, direction: str) -> _Ring:
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, direction)
    with _rings_lock:
        ring = _rings.get(key)
        if ring is None:
            ring = _rings[key] = _Ring(torch.device("cuda", index))
    return ring


def _pieces(arr: np.ndarray, size: int, base: int = 0):
    """(byte offset in C order, bytes, sub-array) pieces of at most
    ``size`` bytes that cover ``arr``.  A C-contiguous array splits into
    flat byte ranges; any other into row groups of its first axis (a row
    larger than a slot splits the same way, one level down)."""
    nbytes = arr.nbytes
    if nbytes == 0:
        return
    if arr.flags.c_contiguous:
        flat = arr.reshape(-1).view(np.uint8)
        for off in range(0, nbytes, size):
            nb = min(size, nbytes - off)
            yield base + off, nb, flat[off : off + nb]
        return
    row = nbytes // arr.shape[0]
    if row > size:
        for r in range(arr.shape[0]):
            yield from _pieces(arr[r], size, base + r * row)
        return
    per = size // row
    for r0 in range(0, arr.shape[0], per):
        r1 = min(arr.shape[0], r0 + per)
        yield base + r0 * row, (r1 - r0) * row, arr[r0:r1]


def _copy(dst: np.ndarray, src: np.ndarray) -> None:
    """``np.copyto(dst, src)``, split along the first axis over
    ``COPY_THREADS`` threads (numpy releases the GIL while it copies)."""
    global _pool
    parts = min(COPY_THREADS, dst.nbytes // _MIN_PART, dst.shape[0] if dst.ndim else 1)
    if parts <= 1:
        np.copyto(dst, src)
        return
    if _pool is None:
        with _rings_lock:
            if _pool is None:
                _pool = ThreadPoolExecutor(COPY_THREADS, thread_name_prefix="hostcopy")
    bounds = [dst.shape[0] * k // parts for k in range(parts + 1)]
    list(_pool.map(lambda k: np.copyto(dst[bounds[k] : bounds[k + 1]], src[bounds[k] : bounds[k + 1]]), range(parts)))


def _staged(view: np.ndarray, nb: int, like: np.ndarray) -> np.ndarray:
    """The first ``nb`` bytes of a slot, shaped as the piece ``like``."""
    return view[:nb].view(like.dtype).reshape(like.shape)


def _torch_dtype_of(dtype: np.dtype) -> torch.dtype:
    # the dtype ``_chunks.tensor_of`` gives (ml_dtypes' bfloat16 as
    # torch's, a datetime as int64 ticks): the upload keeps it
    return tensor_of(np.empty(0, dtype)).dtype


def _numpy_dtype_of(dtype: torch.dtype) -> np.dtype:
    return array_of(torch.empty(0, dtype=dtype)).dtype


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 tensor (a view)."""
    flat = t.reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def upload(buf, device: torch.device) -> torch.Tensor:
    """A host numpy array (or a CPU tensor) on the CUDA ``device``, through
    the pinned ring: non-blocking copies on the copy stream, which the
    current stream waits for before any later work."""
    return call("upload", _upload, buf, device)


def _upload(buf, device: torch.device) -> torch.Tensor:
    ring = _ring(device, "h2d")
    size = ring.slot_bytes
    if isinstance(buf, torch.Tensor):
        src_t = buf.detach().contiguous()
        dst_dtype, shape, nbytes = src_t.dtype, tuple(src_t.shape), src_t.numel() * src_t.element_size()
        src_bytes = _as_bytes(src_t)
        pieces = ((off, min(size, nbytes - off), None) for off in range(0, nbytes, size))
    else:
        arr = np.asarray(buf)
        if not arr.dtype.isnative:
            arr = arr.astype(arr.dtype.newbyteorder("="))
        dst_dtype, shape, nbytes = _torch_dtype_of(arr.dtype), arr.shape, arr.nbytes
        pieces = _pieces(arr, size)
    with ring.lock, torch.cuda.stream(ring.stream):
        # allocated on the copy stream: the allocator orders its reuse
        # after this stream's copies, and after the compute stream's reads
        # through record_stream below
        dst = torch.empty(shape, dtype=dst_dtype, device=ring.device)
        if nbytes:
            dst_bytes = _as_bytes(dst)
            for off, nb, sub in pieces:
                i = ring.take()
                if sub is None:
                    ring.slots[i][:nb].copy_(src_bytes[off : off + nb])
                else:
                    _copy(_staged(ring.views[i], nb, sub), sub)
                dst_bytes[off : off + nb].copy_(ring.slots[i][:nb], non_blocking=True)
                ring.events[i].record(ring.stream)
                COPIES["h2d_pieces"] += 1
            COPIES["h2d_bytes"] += nbytes
        done = torch.cuda.Event()
        done.record(ring.stream)
    compute = torch.cuda.current_stream(ring.device)
    compute.wait_event(done)
    dst.record_stream(compute)
    return dst


def fetch_into(t: torch.Tensor, out: np.ndarray, ready=None) -> np.ndarray:
    """Copy the CUDA tensor ``t`` into the numpy array ``out`` (same shape
    and dtype; any strides) through the pinned ring.  ``ready`` is the event
    after which ``t`` holds its value; without one, the copy waits for all
    work queued on the current stream.  Returns ``out`` once it is filled."""
    return call("fetch", _fetch_into, t, out, ready)


def _fetch_into(t: torch.Tensor, out: np.ndarray, ready) -> np.ndarray:
    if tuple(t.shape) != tuple(out.shape) or _numpy_dtype_of(t.dtype) != out.dtype:
        raise ValueError(f"cannot fetch a {tuple(t.shape)} {t.dtype} tensor into a {out.shape} {out.dtype} array")
    if out.size == 0:
        return out
    compute = torch.cuda.current_stream(t.device)
    if not t.is_contiguous():
        t = t.contiguous()
        ready = None  # the copy above is queued after the given event
    src_bytes = _as_bytes(t)
    ring = _ring(t.device, "d2h")
    with ring.lock:
        if ready is None:
            ring.stream.wait_stream(compute)
        else:
            ring.stream.wait_event(ready)
        t.record_stream(ring.stream)
        todo = iter(_pieces(out, ring.slot_bytes))
        issued = collections.deque()

        def issue(i, piece):
            off, nb, _sub = piece
            with torch.cuda.stream(ring.stream):
                ring.slots[i][:nb].copy_(src_bytes[off : off + nb], non_blocking=True)
            ring.events[i].record(ring.stream)
            issued.append((i, piece))
            COPIES["d2h_pieces"] += 1

        for _ in range(SLOTS):
            piece = next(todo, None)
            if piece is None:
                break
            issue(call("fetch.wait", ring.take), piece)
        while issued:
            i, (_off, nb, sub) = issued.popleft()
            call("fetch.wait", ring.events[i].synchronize)
            call("fetch.piece", _copy, sub, _staged(ring.views[i], nb, sub))
            piece = next(todo, None)
            if piece is not None:
                issue(i, piece)
        COPIES["d2h_bytes"] += out.nbytes
    return out


def fetch(t: torch.Tensor, ready=None) -> np.ndarray:
    """A new numpy array holding the CUDA tensor ``t`` (see ``fetch_into``)."""
    out = np.empty(tuple(t.shape), dtype=_numpy_dtype_of(t.dtype))
    return fetch_into(t, out, ready)


def ring_bytes() -> int:
    """Pinned bytes the rings hold now (all devices, both directions)."""
    return sum(len(r.slots) * r.slot_bytes for r in _rings.values())

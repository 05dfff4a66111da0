"""GPU smoke run of dask_array_tpu_torch, the PyTorch/CUDA port.

Drives the port's main paths on one CUDA card through their public entry
points and checks every kernel on those paths against its plain PyTorch
version.  Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints one line of its own numbers; any failure raises):
  1. setup: config "device" = "cuda"; build the band-stencil, the
     multi-statistic, the transpose, the halo, the scale and the histogram
     kernels from dask_array_tpu_torch/csrc (one nvcc each, started
     together); print the card's name and power limit;
  2. the band-stencil kernel against its plain version on the card: every
     boundary and every mixed pair, depths (1,1) (2,1) (1,0) (8,8),
     float16/32/64, a ragged shape; then the redesign's paths: 16-byte rows
     (1024^2) in each dtype at depths (1,1) (2,2) (1,0) (0,1) (2,1) (8,8)
     (the register window and the tap list, each with 16-byte and scalar
     rows), 4096^2 (interior and edge blocks), contiguous
     tensors at storage offset 1 (scalar rows), and an inf input to the
     5-point stencil (the window skips its empty corners: no NaN);
  3. the README example (slice pushdown + fusion) on the card;
  4. stencil2d (BASELINE config 4): 4096x4096 float32, chunks 1024,
     depth 1, reflect, in the roll form (BandStencil) and the slices form
     (Overlap), both against a float64 numpy reference;
  5. stencil2d at 16384x16384 float32, chunks 4096, through compute(),
     against the plain version on the card;
  6. timing of the stencil: the kernel and the plain version at both sizes
     (CUDA events, median of 30 after warm-up, in the order plain, kernel,
     kernel, plain; the faster median of each is reported), a device copy
     of the same bytes, torch's conv2d of the padded array with the 3x3
     Laplace taps (the nearest single library call, padding outside the
     timed window), and the whole compute(); the kernel, conv2d and the copy
     also on the device alone (device_ms), and the kernel's host share of a
     call (per call less on the device, in µs);
  7. the multi-statistic kernel against its plain version on the card:
     (10000, 10000), (1000, 1003), (1, 7), (4097, 33), (1000000, 128),
     (128, 1000000) and a contiguous (1000, 1024) at storage offset 1 (the
     scalar loads) float32, each run twice for the same bits;
  8. reduction_tree (BASELINE config 2): 10000x10000 float32, chunks 1000,
     split_every 4, the three arrays computed together through compute(),
     against numpy in float64, and the kernel's three results on the same
     device tensor against the reductions computed one at a time;
  9. normalize_contract: a (32768, 4096) float32 in (4096, 4096) chunks,
     b (2048, 4096) in chunks of 1024, through compute(), against numpy in
     float64 on 256 rows (column mean and std from the whole of a);
 10. blocked_matmul (BASELINE config 3): 8192x8192 float32, chunks 1024
     against 512, against torch.matmul in float64 on the card;
 11. timing of phases 7-10: the multi-statistic kernel (per call and on
     the device alone), its plain version, torch's trio x.sum(0), x.sum(1) /
     N, x.std(correction=0) and a device copy of the same bytes at 10000^2,
     1000000x128 and 128x1000000, each with its bound; compute() and
     compute_device() of phases 8-10; the TFLOP/s of phase 10's contraction;
 12. the transpose kernel against its plain version on the card, byte for
     byte through an integer view (NaN payloads and -0.0 count): (8192,
     8192), (16384, 16384), (32768, 4096), (1000, 1003), (1, 7), (4097, 33),
     a batched (3, 513, 257), a row-sliced and a column-sliced view, each in
     bool, int8, float16, float32, float64, int64, complex64, complex128,
     uint16, uint32, uint64;
 13. rechunk_relayout (BASELINE metric 2): 8192x8192 float32, chunks 1024,
     through compute(), byte for byte against x.T; then the persist form,
     whose compute_device() must be a contiguous tensor on the card;
 14. the slice's other ops at 4096x4096 float32 against numpy: reshape/ravel,
     concatenate/stack/block, roll and the flips, squeeze/expand_dims/
     broadcast_to, vdot/outer and cumsum(axis=None);
 15. timing of phases 12-13: the transpose kernel, its plain version,
     x.mT.contiguous() (the nearest library call) and a device copy at
     8192^2 and 16384^2 float32, with GB/s and the bound; the relayout's
     compute() and compute_device() in both forms;
 16. the halo kernel against its plain version on the card, byte for byte
     through an integer view: (16384, 16384) depth 1 in each of the five
     modes and (4096, 4096) depth 8 in float32; then in bool, int8,
     float16, float32, float64, int64, complex64, complex128, uint16, uint32
     and uint64: (1000, 1003) with widths ((3, 0), (0, 5)), a 1-D (1 << 24,),
     a 3-D (64, 513, 257) with widths (1, 2, 3), widths of 7 on a length-3
     axis in wrap,
     symmetric and reflect, mixed modes with constant corners and per-side
     fills, a row-sliced and a column-sliced view; then the row kernel
     against the strided kernel on the same values, lo 0-4 in every mode
     and dtype: a contiguous input and a view one element into its rows
     (the row kernel) and a column-major copy (the strided kernel), the
     path each takes checked through kernels.halo.kernel_for;
 17. stencil2d's slices form (the general halo path: Overlap -> map_blocks)
     at 16384x16384 (chunks 4096) and 4096x4096 (chunks 1024) float32
     against numpy, each compute() launching the halo kernel once and the
     band stencil never;
 18. a func the band kernel cannot read, tanh of the roll Laplace, through
     map_overlap at 4096x4096 (chunks 1024, trim=True) against numpy, one
     halo launch and no band-stencil launch;
 19. da.pad at 4096x4096 float32 against np.pad in constant, edge, reflect,
     symmetric and wrap (equal) and in linear_ramp and mean;
 20. on (1 << 24,) float32 with NaNs: sliding_window_view(x, 64).sum(-1)
     (fused), move_mean and move_std with window 64 and push with n=3,
     against numpy;
 21. timing at 16384^2 float32 depth 1: the halo kernel in dask's
     "reflect" (numpy symmetric; the main path's) and its plain version
     interleaved, the kernel in reflect/edge/wrap/constant beside
     F.pad's reflect/replicate/circular/constant (the same functions), F.pad
     replicate as the library call of the main path's function (at depth 1
     dask's "reflect" equals numpy's edge), a device copy of the same bytes
     and the bound, each also on the device alone (device_ms); the kernel's
     host share of a call at 4096^2; compute() and compute_device() of
     phases 17-18;
 22. the scale kernel against its plain version on the card, equal bytes
     (a NaN matching any NaN) in float16, bfloat16, float32 and float64, in
     the scalar, row and column forms: the probe's 256x256 * 2.0, (128,
     128) (svd_flip's vh * signs.T), (1000, 1003), (4097, 33), a 1x128
     row, (1e6, 128) by a row, a strided u[:, :128] view of (100000, 256),
     a 1-D (1 << 24,) and its unaligned x[1:], and the narrow (1e7, 1) and
     (1e7, 3);
 23. tall_skinny_svd (BASELINE config 5): 1e6x128 float32 in row chunks of
     100 000 through compute(u, s, vh): s against float64 numpy, the
     reconstruction, the orthogonality and the sign rule; three scale
     launches and one factorization.  Then, against numpy: qr (TSQR) of
     100000x128, lu and solve of 4096^2 float64 in 1024^2 blocks (the
     blocked path), cholesky and inv of 4096^2 float64, lstsq of
     100000x128 and norm(ord=2);
 24. timing: the scale kernel, its plain version, torch.mul and the bound
     at 1e6x128 float32 by a row, and beside torch.mul at (1 << 24,) * 2.0,
     (1e7, 1) * s and (1e7, 3) * s, each call as a caller pays it and its
     device time alone (the card spinning first); compute() and compute_device() of
     tall_skinny_svd, and compute_device() with the input persisted on the
     card (the device walk alone); torch.linalg.svd of the whole 1e6x128
     as a reference;
 25. numpy's unsigned integers on the card: 4096x4096 uint16, uint32 and
     uint64 (0, 1, the maximum, 2**63) in chunks of 1024 through +, -, *,
     a scalar, negation, ~, comparisons (2**63 included), maximum/minimum,
     //, % (zero divisors), >>, << (past the width), astype to float64,
     float32, int64, uint8, and sum/prod/nansum/cumsum/max/min/nanmax/
     argmax/argmin/any/all, each equal to numpy; mean/std/var to 1e-12.
 26. the NumPy surface: every new ufunc at 2048^2 in eight dtypes against
     numpy (units in the last place), then at 16384^2 float32 (persisted)
     the indexing, assignment and routine paths against numpy, timed beside
     plain torch, with their host syncs;
 27. the second half of the routines, the gufuncs, shuffle and the
     quantiles (ROUTINE_SIZES): at 16384^2 float32 (persisted) median,
     quantile, nanmedian (1 % NaN), topk/argtopk, coarsen, gradient,
     apply_along_axis, apply_gufunc, shuffle and isin (int32); on 2^26
     values histogram (256 uniform bins, weighted, 257 edges), histogram2d,
     bincount (weighted too) and unique; searchsorted/digitize of 2^24
     values into 2^20 edges, ravel_multi_index/unravel_index of 2^24
     points; cov, corrcoef and a weighted cov of 256 x 2^20 float32 (the
     transpose and scale kernels launched, and held against their plain
     versions at that shape); repeat with one count per row at 4096^2.
     Each against numpy (a part of the large results), with
     compute_device()/compute() times, the nearest torch call, the bound,
     the host syncs and the histogram kernel's launches (one on each
     histogram and bincount path); then the histogram kernel (K2) on 2^26
     float32 values into 256 bins (also weighted, its sums the same bits
     on three runs) and 65536 bins (also with every value in one bin), and
     a 65536-bin bincount of 2^26 int64 (also weighted), each equal to
     numpy (weighted sums to rtol 1e-12) and beside its plain version,
     torch.histc (or bucketize + bincount, bincount) and its bound;
 28. da.random, fft, svd_compressed and multi-output map_blocks
     (RANDOM_SIZES), with inputs drawn on the card: (a) a 16384^2 float32
     standard normal (1 GiB) in chunks of 4096: the same bytes twice and at
     chunks 1024, two draws of one Generator differ, compute_device()
     beside torch.randn; (b) every distribution at 2^24 values (nsample 50
     for the urns) held to its law's mean and variance (scipy.stats, 6
     standard errors), with its time and host syncs; (c) reduction_tree,
     stencil2d (roll form), tall_skinny_svd and rechunk_relayout drawn by
     da.random (the JAX package's input form) beside their numpy-input
     forms fed the same values: equal bytes, compute() and compute_device(),
     and the launches of the band-stencil, multi-statistic, transpose and
     scale kernels, read per form; (d) rfft along axis 1 of 16384^2 float32
     in row chunks of 2048, its irfft round trip, fft2 of 8192^2 complex64
     and fftn of 512^3 complex64, each beside the torch.fft call on the
     tensor already on the card, the bound from bytes, and the same
     transform against numpy at 4096^2 (256^3 for fftn); (e)
     svd_compressed(x, k=32, n_power_iter=2) of a persisted 1e6x1024
     float32 of rank 32 plus 1e-4 noise in row chunks of 100 000: s within
     1e-3 of svd(x)'s top 32, with the scale kernel's launches; (f) sin and
     cos through map_blocks_multi_output at 16384^2 float32: one call per
     block;
 29. IO and interop (IO_SIZES; float32 from a numpy seed; files under a
     temporary directory in build/, deleted at the end; no h5py, zarr,
     xarray or tiledb): (a) stencil2d's roll form at 16384^2 (chunks 4096,
     one band-stencil launch) written by to_zarr (v2, raw, the vendored
     store), every chunk file equal to compute()'s bytes, beside np.save of
     the same array; (b) from_zarr of it (16 blocks of 64 MiB through
     FromMap) and compute(x.sum(0), x.mean(1), x.var()) (one
     multi-statistic launch where the route takes the FromMap leaf; the
     route reported) against float64 under STATS_TOLERANCE, with the share
     of compute_device() that the chunk reads and the upload take; (c) a
     [:4096, :4096] slice of it loads one chunk file (LOADS == 1); (d)
     rechunk_relayout at 8192^2 (one transpose launch) to an npy stack and
     back through from_npy_stack(mmap_mode="r"), equal bytes; (e) store
     into open_memmap targets with regions and compute=False, with
     return_stored, from_map of np.load, from_delayed, from_blocks and
     barrier, each equal byte for byte; (f) the xarray chunk manager at
     4096^2 (chunks 1024): rechunk, reduction of np.nansum, scan of
     np.cumsum, map_blocks of a numpy function, apply_gufunc of np.mean and
     store against numpy, with the host lane's calls (one a block on the
     numpy paths, none on the torch ones); (g) plankit loads, and
     optimize() of a plan of 600-block axes with the library and with its
     Python paths, beside each helper's time both ways.

 30. the out-of-core lane (STREAM_SIZES; host numpy inputs from one
     broadcast fill; sizes halve, each cut printed, when MemAvailable is
     short), each case streamed under an explicit "memory-budget" and held
     against its in-core compute() ("out-of-core": "off") in this process:
     (a) stencil2d's roll form on 32768^2 float32 in chunks of 4096 under
     3 GiB (K1 once a panel, equal bytes), (b) tanh(laplace) through
     map_overlap (the halo kernel once a panel, equal bytes), (c)
     sum(axis=0), mean() and nanmax() of 2^20 x 2048 float32 in row chunks
     of 2^16 under 2 GiB (rtol 1e-4 against plain torch in float64), (d) A @ W of
     2^20 x 1024 by a numpy 1024^2 under 2 GiB (W pinned once; rtol 1e-5
     against in-core); each with its panels, pinned leaves, launches, host
     GB each way, streamed and in-core ms and GB/s; then the "auto"
     budget (the same, within 1 GiB, before and after the in-core runs),
     "auto" off for a 1 GiB program, and that an xla_profile trace of
     case (a) names K1's kernel; then datetime, bfloat16 and float8
     data (``streaming_dtype_paths``): (e) stencil2d's roll form on a host
     32768^2 bfloat16 (2 GiB) under 1 GiB (K1's 2-byte build once a panel,
     equal bytes), (f) sum(axis=0) of 2^20 x 2048 float8_e4m3fn (2 GiB)
     under 512 MiB (at most one step of the type from in-core and from the
     float64 sum rounded once), (g) min and max along axis 0 of 2^20 x 512
     datetime64[ns] (4 GiB, 64 NaT) under 2 GiB (equal to in-core and to
     numpy);
 31. S9 (S9_SIZES): (a) K1 in bfloat16 and float16 at 4096^2 and 16384^2
     (depth 1, reflect; the 256-column tile) against its plain version (at
     most 1 step of the type apart: ``close16``), with conv2d in the same
     type and the bound; K2 on 2^26 bfloat16 and float16 values into 256
     and 65536 bins (the pattern route; counts equal to the plain version)
     beside torch.histc of the float32 cast; (b) where ml_dtypes imports: blocked_matmul at 8192^2 in
     bfloat16 (chunks 1024 against 512; float32 accumulation) against a
     float32 product, with TFLOP/s beside one torch.matmul, and stencil2d's
     roll form and a histogram of a 4096^2 bfloat16 numpy input through
     compute() (K1 and K2 launches counted); (c) 2^24 datetime64[ns] with
     1 % NaT: diff, min, max, a compare/where and a cast to [s], equal to
     numpy, computed as int64 ticks on the card; (d) the host lanes, each
     equal to numpy: a 4096^2 float64 masked array with 10 % masked
     (chunks 1024) through sum/mean/var/argmax/cumsum and sqrt beside
     numpy.ma, 2^20 records (field arithmetic on the card), and a
     registered duck type end to end.
 32. the mesh (S12; MESH_SIZES): 4 slots on cuda:0 (on 4 cards where
     there are 4), 2 x 2 ("x", "y") and a ring ("r",), the JAX package's
     multichip dry run at full width, each part against the port without
     a mesh in this process, with its compute_device() both ways, its
     collectives (parallel._sharded.COLLECTIVES) and lane programs: (a)
     the flagship step (feature-normalise, contract, row-reduce) on a
     16384^2 float32 a and a 8192 x 16384 b with a rechunk boundary (one
     permute); (b) the Laplace stencil under "overlap-method": "shard" (K1
     once a slot, two permutes a sharded axis) and tanh(laplace) through
     ShardStencil (the halo kernel once a slot); (c) cumsum (one
     all_gather of the scan's totals where its axis is sharded), a rechunk
     that moves a mesh axis (a permute on the grid, an all_to_all on the
     ring), sum; (d) the shard lane on 1e6 x 128 float32 in 11 uneven row
     blocks: elemwise + sum, mean, var (one psum a reduction, no
     all_gather), the Blelloch cumsum (one all_gather), x @ w (no
     collective), argmax (the vote); (e) auto_mesh() over the cards.
 33. the partitioned walk (PARTITIONED_SIZES): the same 4 slots, a 2 x 2
     grid and a ring, each workload under "execution-lane" "gspmd" and
     "auto" against the port without a mesh in this process: the flagship
     (n = 16384; no node gathers a), reduction_tree at 10000^2 (the
     multi-statistic kernel once a slot, one psum), rechunk_relayout at
     8192^2 (the transpose kernel once a slot), blocked_matmul at 8192^2
     (chunks 1024 against 512), a column weighting of 1e6 x 128 (the scale
     kernel once a slot), tall_skinny_svd at 1e6 x 128 (TSQR has no rule:
     it reads its operand's dense form, here the persisted leaf itself, and
     svd_flip's multiplies then run dense), a histogram of 2^26
     float32 into 256 bins (the histogram kernel once a slot, one psum),
     and cumsum -> rechunk -> * 2 -> sum at 8192^2 (inputs persisted on the
     card without a mesh, so the times are the device work and the walk;
     under a mesh the walk binds their slot parts as views); each with its values,
     compute_device() ms both ways, the COLLECTIVES deltas with bytes, the
     PARTITIONED record and the kernels' launches.
 34. ml_dtypes' narrow types (NARROW_SIZES, ``narrow_paths``): each of
     int2, uint2, int4, uint4, float4_e2m1fn, float8_e3m4, float8_e4m3,
     float8_e4m3b11fnuz and float8_e8m0fnu at 16384^2 (a 256 MiB uint8
     carrier, chunks 4096, persisted) through astype(float32), x * 2 + 1,
     sums, max, cumsum(axis=0) and where against the port's own CPU run of
     the same programs (bit for bit on 512 columns, sum() and max()
     whole; a float sum at most one step of the type apart), 8192^2
     float8_e4m3 and int4 products (float32 and int8, chunks 2048) against
     the CPU's rows, and histograms of 2^26 float8_e4m3fn, float8_e5m2 and
     int4 values into 256 bins through da.histogram: K2's byte route, one
     launch each, equal to its plain version, then timed per call and on
     the device beside its plain version and torch.histc of the float32
     values, with its bound (2^26 bytes over 3.35 TB/s).

Each main path runs with its kernel's launch count set to 0 just before it
and read just after; a kernel of a path launched no time fails the run.
The README example and normalize_contract (b.T) launch the transpose too;
their launch counts say so.
Prints the kernels' JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when torch finds no CUDA device.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase(n, name, **numbers):
    print(f"phase {n} {name}: {json.dumps(numbers)}", flush=True)


def cuda_ms(fn, reps=30, warmup=3):
    """Median milliseconds of ``fn`` on the card, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=30, warmup=3):
    """Median device milliseconds of ``fn``: the card spins for about a
    millisecond before each start event, so the host's launch time (which
    ``cuda_ms`` counts when the card would otherwise wait) stays outside."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def paired_ms(plain, kernel, reps=30):
    """Plain, kernel, kernel, plain: drift in clocks hits both alike.
    Returns (kernel_ms, plain_ms, kernel runs, plain runs), the faster
    median of each."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return min(k1, k2), min(p1, p2), [k1, k2], [p1, p2]


def host_ms(fn, reps):
    """Median host milliseconds of ``fn`` (which ends in a synchronize)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes, flops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stencil_for(d0, d1):
    """A linear stencil reaching exactly (d0, d1), with asymmetric weights
    so a wrong tap sign shows, and a corner tap when both depths are set."""
    import torch

    def f(b):
        out = -3.0 * b
        for s in range(1, d0 + 1):
            out = out + torch.roll(b, s, 0) * (0.5 / s) - torch.roll(b, -s, 0) * (0.25 / s)
        for s in range(1, d1 + 1):
            out = out + torch.roll(b, s, 1) * (0.75 / s) + torch.roll(b, -s, 1) / (2.0 * s)
        if d0 and d1:
            out = out + torch.roll(torch.roll(b, d0, 0), -d1, 1) * 0.125
        return out

    return f


def numpy_laplace(x):
    import numpy as np

    p = np.pad(x.astype(np.float64), 1, mode="symmetric")
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]


def stats_errors(got, want, x):
    """Max abs errors of (colsum, rowmean, std) and a check against the
    stated tolerances: colsum/rowmean rtol 1e-5 with atol 4 * sqrt(terms) *
    max|x| * 2^-23 (rowmean's divided by N), std rtol 1e-4."""
    import torch

    M, N = x.shape
    amax = float(x.abs().max())
    atols = (4 * M**0.5 * amax * 2.0**-23, 4 * N**0.5 * amax * 2.0**-23 / N, 0.0)
    rtols = (1e-5, 1e-5, 1e-4)
    errs = []
    for g, w, rt, at in zip(got, want, rtols, atols):
        g = torch.as_tensor(g).to(device=x.device, dtype=torch.float64)
        w = torch.as_tensor(w).to(device=x.device, dtype=torch.float64)
        torch.testing.assert_close(g, w, rtol=rt, atol=at)
        errs.append(float((g - w).abs().max()))
    return errs


def random_bytes(shape, dtype, seed):
    """Random bits of ``dtype`` on the card (NaN payloads, -0.0 and
    infinities included), made through an integer view of the bytes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    size = torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(0, 256, (*shape[:-1], shape[-1] * size), generator=gen, device="cuda",
                        dtype=torch.uint8)
    return raw % 2 == 1 if dtype == torch.bool else raw.view(dtype)


def check_halo(halo, x, widths, modes, what):
    """The halo kernel against its plain version, byte for byte."""
    import torch

    got = halo.halo_pad_cuda(x, widths, modes)
    want = halo.halo_pad_plain(x, widths, modes)
    check(got.shape == want.shape and got.dtype == want.dtype and got.is_contiguous(), f"{what}: shape/dtype")
    check(bool(torch.equal(got.view(torch.uint8), want.contiguous().view(torch.uint8))), f"{what}: bytes differ")


def same_values(a, b):
    """Equal bytes, a NaN matching any NaN (the scale kernel and torch may
    canonicalise a NaN differently)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(((a.view(bits) == b.view(bits)) | (a.isnan() & b.isnan())).all())


def check_transpose(tk, x, what):
    """The transpose kernel against its plain version, byte for byte."""
    import torch

    got = tk.transpose_last2_cuda(x)
    want = tk.transpose_last2_plain(x)
    check(got.shape == want.shape and got.dtype == want.dtype and got.is_contiguous(), f"{what}: shape/dtype")
    check(bool(torch.equal(got.view(torch.uint8), want.view(torch.uint8))), f"{what}: bytes differ")


def unsigned_cases(da, n25, seed=25):
    """numpy's unsigned integers through the port: arithmetic, comparisons,
    //, %, shifts, casts and the reductions of uint16/32/64 (n25, n25) arrays,
    each against numpy; returns (exact cases, relative errors of the moments)."""
    import numpy as np

    rng25 = np.random.default_rng(seed)
    exact_cases = 0
    float_errs = {}
    for dt in (np.uint16, np.uint32, np.uint64):
        info = np.iinfo(dt)
        a = rng25.integers(0, info.max, size=(n25, n25), dtype=dt, endpoint=True)
        a.ravel()[:6] = [0, 1, info.max, info.max - 1, 2**15, info.max // 2 + 1]  # 2**63 for uint64
        b = rng25.integers(0, info.max, size=(n25, n25), dtype=dt, endpoint=True)
        b.ravel()[::97] = 0  # numpy's 0 for // and % by zero
        s = (np.arange(n25 * n25) % 70).astype(dt).reshape(n25, n25)  # shifts past every width
        x, y, sh = (da.from_array(v, chunks=1024) for v in (a, b, s))
        with np.errstate(all="ignore"):
            exact = {
                "add": (x + y, a + b), "subtract": (x - y, a - b), "multiply": (x * y, a * b),
                "add_scalar": (x + 7, a + 7), "negative": (-x, -a), "invert": (~x, ~a),
                "less": (x < y, a < b), "greater_equal": (x >= y, a >= b), "equal": (x == y, a == b),
                "less_scalar": (x < info.max // 2 + 1, a < info.max // 2 + 1),
                "maximum": (da.maximum(x, y), np.maximum(a, b)), "minimum": (da.minimum(x, y), np.minimum(a, b)),
                "floor_divide": (x // y, a // b), "remainder": (x % y, a % b), "floor_divide_scalar": (x // 3, a // 3),
                "right_shift": (x >> sh, a >> s), "left_shift": (x << sh, a << s),
                "astype_float64": (x.astype(np.float64), a.astype(np.float64)),
                "astype_float32": (x.astype(np.float32), a.astype(np.float32)),
                "astype_int64": (x.astype(np.int64), a.astype(np.int64)),
                "astype_uint8": (x.astype(np.uint8), a.astype(np.uint8)),
                "sum": (x.sum(), a.sum()), "sum_axis0": (x.sum(axis=0), a.sum(axis=0)),
                "prod_axis1": (x.prod(axis=1), a.prod(axis=1)), "nansum_axis1": (da.nansum(x, axis=1), np.nansum(a, axis=1)),
                "cumsum_axis1": (da.cumsum(x, axis=1), np.cumsum(a, axis=1)),
                "max": (x.max(), a.max()), "min_axis0": (x.min(axis=0), a.min(axis=0)),
                "nanmax_axis1": (da.nanmax(x, axis=1), np.nanmax(a, axis=1)),
                "argmax": (x.argmax(), a.argmax()), "argmin_axis0": (x.argmin(axis=0), a.argmin(axis=0)),
                "any_axis0": (x.any(axis=0), a.any(axis=0)), "all": (x.all(), a.all()),
            }
            close = {"mean": (x.mean(), a.mean()), "mean_axis1": (x.mean(axis=1), a.mean(axis=1)),
                     "std": (x.std(), a.std()), "var_axis0": (x.var(axis=0), a.var(axis=0))}
        names = list(exact) + list(close)
        got = da.compute(*[v[0] for v in exact.values()], *[v[0] for v in close.values()])
        for name, g in zip(names, got):
            want = exact[name][1] if name in exact else close[name][1]
            g, want = np.asarray(g), np.asarray(want)
            check(g.dtype == want.dtype and g.shape == want.shape, f"{dt.__name__} {name}: {g.dtype} {g.shape}")
            if name in exact:
                check(bool(np.array_equal(g, want)), f"{dt.__name__} {name}: values differ from numpy")
                exact_cases += 1
            else:
                np.testing.assert_allclose(g, want, rtol=1e-12)
                float_errs[f"{dt.__name__} {name}"] = float(np.max(np.abs(g / want - 1)))
        del got, a, b, s, x, y, sh, exact, close
    return exact_cases, float_errs


NEW_UNARY = ["fabs", "cbrt", "degrees", "radians", "isneginf", "isposinf", "signbit", "spacing", "real", "imag",
             "angle", "i0", "sinc", "nan_to_num", "fix", "isreal", "iscomplex"]
NEW_BINARY = ["float_power", "nextafter", "heaviside", "gcd", "lcm", "ldexp"]
# units in the last place of numpy's result (0: equal, the sign of a zero too);
# divmod: the card's float16 floor division rounds its quotient once more;
# i0: numpy's own series, but the card's exp is not the host's (3 units seen)
# phase 26's side for every new ufunc in 8 dtypes: its time is numpy's
# references on the host (277 s at 4096^2 on the H100's host)
UFUNC_SWEEP = 2048

SURFACE_ULPS = {"cbrt": 2, "i0": 4, "sinc": 2, "degrees": 2, "radians": 1, "angle": 4, "float_power": 4,
                "divmod": 1}


def agree_ulps(got, want, ulps):
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if want.dtype.kind not in "fc":
        return bool(np.array_equal(got, want))
    with np.errstate(all="ignore"):
        if ulps == 0:
            zero = (want == 0) & (got == 0)
            return bool(np.array_equal(got, want, equal_nan=True)
                        and np.array_equal(np.signbit(got[zero]), np.signbit(want[zero])))
        tol = ulps * np.abs(np.spacing(np.abs(want)))
        return bool(np.all((np.abs(got - want) <= tol) | (got == want) | (np.isnan(got) & np.isnan(want))))


def ulps_off(got, want):
    """The most units in ``want``'s last place ``got`` is off (NaN matching
    NaN and equal values count 0)."""
    import numpy as np

    with np.errstate(all="ignore"):
        d = np.abs(got - want) / np.abs(np.spacing(np.abs(want)))
        d[(got == want) | (np.isnan(got) & np.isnan(want))] = 0
        return float(np.nanmax(d)) if d.size else 0.0


def surface_data(dt, n, seed):
    """(n, n) of dtype ``dt``: its special values (NaN, ±inf, ±0, the
    smallest subnormal, ±max, exact cubes; 0, 1, the extremes) in the first
    row, random values after."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dt = np.dtype(dt)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        a = rng.integers(info.min, info.max, size=(n, n), dtype=dt, endpoint=True)
        special = [0, 1, info.max, info.min, 2, 3, 6, 12, 27] + ([-1, -8, -27] if dt.kind == "i" else [])
    else:
        a = (rng.standard_normal((n, n), dtype=np.float32) * 10).astype(dt)
        fi = np.finfo(dt)
        special = [np.nan, np.inf, -np.inf, 0.0, -0.0, fi.smallest_subnormal, -fi.smallest_subnormal, fi.max,
                   -fi.max, 1.0, -1.0, 27.0, -8.0, 0.5, 2.5, -2.5]
    a[0, :len(special)] = np.array(special, dtype=dt)
    return a


def ufunc_surface(da, n):
    """Every new ufunc and elementwise function at (n, n) in float16/32/64
    and the integer types it takes, through compute() on the card, against
    numpy with equal dtypes.  Returns (cases checked, cases numpy refuses,
    the units in the last place each float case is off where it is)."""
    import warnings

    import numpy as np

    checked, refused, worst = 0, 0, {}
    for dt in ["float16", "float32", "float64", "int8", "int32", "int64", "uint8", "uint64"]:
        a, b = surface_data(dt, n, 26), surface_data(dt, n, 27)
        e = (np.arange(n * n, dtype=np.int64).reshape(n, n) % 61 - 30).astype(np.int32)
        x, y, xe = (da.from_array(v, chunks=n // 4) for v in (a, b, e))
        lazy, want, ulps = [], [], []
        with warnings.catch_warnings(), np.errstate(all="ignore"):
            warnings.simplefilter("ignore")
            for name in NEW_UNARY + NEW_BINARY + ["frexp", "modf", "divmod", "clip"]:
                args = {"ldexp": (a, e), "clip": (a, 1, 100)}.get(name, (a, b) if name in NEW_BINARY + ["divmod"] else (a,))
                largs = {"ldexp": (x, xe), "clip": (x, 1, 100)}.get(name, (x, y) if name in NEW_BINARY + ["divmod"] else (x,))
                try:
                    if name == "i0" and dt in ("float16", "float32"):
                        w = np.i0(a.astype(np.float64)).astype(dt)  # numpy's own loops are units off
                    else:
                        w = getattr(np, name)(*args)
                except TypeError:
                    refused += 1
                    continue
                outs = getattr(da, name)(*largs)
                outs, w = (outs, w) if isinstance(w, tuple) else ((outs,), (w,))
                for o, wi in zip(outs, w):
                    lazy.append((name, o))
                    want.append(wi)
                    ulps.append(SURFACE_ULPS.get(name, 0))
            got = da.compute(*[o for _, o in lazy])
        for (name, _), g, w, u in zip(lazy, got, want, ulps):
            g, w = np.asarray(g), np.asarray(w)
            if name in ("frexp", "modf", "divmod") and w.dtype.kind == "f":
                g = np.where(np.isnan(w), np.nan, g).astype(w.dtype)  # a NaN's sign aside
            off = ulps_off(g, w) if w.dtype.kind in "fc" and g.shape == w.shape else 0.0
            if off:
                worst[f"{name} {dt}"] = off
            if not agree_ulps(g, w, u):
                bad = np.argwhere(~((g == w) | (np.isnan(g) & np.isnan(w))))[:4] if g.shape == w.shape else []
                shown = [(a[tuple(i)].item(), g[tuple(i)].item(), w[tuple(i)].item()) for i in bad]
                check(False, f"{name} {dt}: differs from numpy ({g.dtype}, {w.dtype}) by {off} units in the "
                             f"last place; (x, got, numpy): {shown}")
            checked += 1
        del a, b, e, x, y, xe, lazy, want, got
    return checked, refused, worst


def surface_paths(da, torch, n, smi):
    """The indexing, assignment and routine paths at (n, n) float32 on the
    card: each against numpy; the host syncs of the boolean paths; an
    out-of-range index raising IndexError before any gather, the next
    compute() working; compute() and compute_device() of each path (the
    input persisted on the card) beside a plain torch expression of the
    same operation on the tensor already there, with effective GB/s."""
    import numpy as np

    from dask_array_tpu_torch.ops import _fancy_indexing as fi
    from dask_array_tpu_torch.ops._blocks import FromBlocks

    rng = np.random.default_rng(2026)
    a = rng.standard_normal((n, n), dtype=np.float32)
    s = (a + rng.standard_normal((n, n), dtype=np.float32) * 1e-6).astype(np.float32)
    x = da.from_array(a, chunks=4096).persist()
    xs = da.from_array(s, chunks=4096).persist()
    t, ts = x.compute_device(), xs.compute_device()
    rows = rng.permutation(n)[:4096]
    pi, pj = rng.integers(0, n, 10**7), rng.integers(0, n, 10**7)
    keep = rng.random(n) < 0.25
    vals = rng.standard_normal((100, n), dtype=np.float32)
    rows_t, pi_t, pj_t = (torch.from_numpy(v).cuda() for v in (rows, pi, pj))
    keep_t, vals_t = torch.from_numpy(keep).cuda(), torch.from_numpy(vals).cuda()
    vals_lazy = da.from_array(vals, chunks=(100, 4096)).persist()
    nb = a.nbytes
    out = {"shape": [n, n], "chunks": 4096, "card": smi}

    # each path: (lazy, numpy result, plain torch on the card, bytes it must move)
    def masked():
        z = x.copy()
        z[z < -1] = 0
        return z

    def slab():
        z = x.copy()
        z[100:200] = vals_lazy
        return z

    sel = int((a > 0).sum())
    paths = {
        "newaxis": (lambda: x[:, None], lambda: a[:, None], lambda: t[:, None], 2 * nb),
        "bool_mask": (lambda: x[x > 0], lambda: a[a > 0], lambda: torch.masked_select(t, t > 0), nb + 4 * sel),
        "take_rows": (lambda: x[rows], lambda: a[rows], lambda: torch.index_select(t, 0, rows_t), 2 * 4096 * n * 4),
        "take_cols": (lambda: x[:, rows], lambda: a[:, rows], lambda: torch.index_select(t, 1, rows_t), 2 * 4096 * n * 4),
        "vindex_1e7": (lambda: x.vindex[pi, pj], lambda: a[pi, pj], lambda: t[pi_t, pj_t], 10**7 * 24),
        "setitem_mask": (masked, lambda: np.where(a < -1, np.float32(0), a),
                         lambda: t.masked_fill(t < -1, 0), 2 * nb),
        "setitem_slab": (slab, lambda: np.concatenate([a[:100], vals, a[200:]]),
                         lambda: torch.cat([t[:100], vals_t, t[200:]]), 2 * nb),
        "where": (lambda: da.where(x > 0, x, 0), lambda: np.where(a > 0, a, np.float32(0)),
                  lambda: torch.where(t > 0, t, 0), 2 * nb),
        "tril": (lambda: da.tril(x), lambda: np.tril(a), lambda: torch.tril(t), 2 * nb),
        "diff": (lambda: da.diff(x), lambda: np.diff(a), lambda: torch.diff(t), 2 * nb),
        "isclose": (lambda: da.isclose(x, xs), lambda: np.isclose(a, s), lambda: torch.isclose(t, ts),
                    2 * nb + a.size),
        "nonzero_sparse": (lambda: da.nonzero(x > 4.5), lambda: np.nonzero(a > 4.5),
                           lambda: torch.nonzero(t > 4.5), nb),
        "compress": (lambda: da.compress(keep, x, axis=0), lambda: np.compress(keep, a, axis=0),
                     lambda: torch.index_select(t, 0, torch.nonzero(keep_t).reshape(-1)), 2 * int(keep.sum()) * n * 4),
    }
    for name, (lazy, ref, plain, nbytes) in paths.items():
        arr = lazy()
        outs = arr if isinstance(arr, tuple) else (arr,)
        fi.SYNCS = 0
        got = da.compute(*outs)
        syncs = fi.SYNCS
        want = ref()
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), f"{name}: differs from numpy")
        del got, want

        def run_device(outs=outs):
            for o in outs:
                o.compute_device()
            torch.cuda.synchronize()

        def run_compute(outs=outs):
            da.compute(*outs)

        dev_ms = host_ms(run_device, 5)
        comp_ms = host_ms(run_compute, 3)
        plain_ms = cuda_ms(plain, reps=10)
        out[name] = {"compute_ms": comp_ms, "compute_device_ms": dev_ms, "plain_torch_ms": plain_ms,
                     "bytes": nbytes, "device_GBps": nbytes / dev_ms / 1e6, "plain_GBps": nbytes / plain_ms / 1e6,
                     "host_syncs": syncs}
        torch.cuda.empty_cache()

    # x[x > 0] then compute_chunk_sizes(): the grid kept, its blocks on the card
    y = x[x > 0]
    nblocks = len(y.chunks[0])
    fi.SYNCS = 0
    t0 = time.perf_counter()
    y.compute_chunk_sizes()
    ccs_ms = (time.perf_counter() - t0) * 1e3
    check(fi.SYNCS == nblocks and isinstance(y.expr, FromBlocks), "compute_chunk_sizes: one sync per block")
    check(all(b.device.type == "cuda" for b in y.expr.blocks.values()), "compute_chunk_sizes: blocks left the card")
    check(sum(y.chunks[0]) == sel and np.array_equal(y.compute(), a[a > 0]), "compute_chunk_sizes: values")
    out["compute_chunk_sizes"] = {"ms": ccs_ms, "blocks": nblocks, "host_syncs": nblocks, "on_card": True}
    del y

    # an out-of-range index raises before any gather; the card keeps working
    raised = []
    try:
        x[[10**9]]
    except IndexError:
        raised.append("numpy index")
    try:
        x[da.from_array(np.array([0, 10**9]), chunks=1)].compute()
    except IndexError:
        raised.append("lazy index")
    again = x[da.from_array(np.array([n - 1, 0]), chunks=1)].compute()
    torch.cuda.synchronize()
    check(raised == ["numpy index", "lazy index"] and np.array_equal(again, a[[n - 1, 0]]),
          "out-of-range index: no IndexError, or the card stopped working")
    out["out_of_range"] = {"raised": raised, "next_compute_ok": True}
    del x, xs, t, ts
    torch.cuda.empty_cache()
    return out


ROUTINE_SIZES = {"square": 16384, "flat": 1 << 26, "vars": 256, "obs": 1 << 20, "rows": 4096, "points": 1 << 24,
                 "edges": 1 << 20}


def routine_paths(da, torch, sizes, timer, sync):
    """The routines, gufuncs, shuffle and quantiles of the ninth slice on
    the configured device, each against numpy on the host: (square,)^2
    float32 (persisted), ``flat`` elements, ``vars`` x ``obs`` float32 for
    cov/corrcoef, ``rows``^2 for repeat.  The host references take a part
    of the large results (columns or rows, cov's top-left 32x32 block).
    For each path: its max error against numpy (0: equal), compute_device()
    (median of 5) and compute() (median of 3) in ms, the nearest torch call
    on the tensor already on the device (``timer``), the bytes the path
    must move and their least time at 3.35 TB/s, the host syncs, and the
    transpose and scale launches of one compute()."""
    import warnings

    import numpy as np

    from dask_array_tpu_torch.kernels import histogram as hk
    from dask_array_tpu_torch.kernels import scale as sk
    from dask_array_tpu_torch.kernels import transpose as tk
    from dask_array_tpu_torch.ops import _fancy_indexing as fi

    n, flat, nv, nobs, nr = (sizes[k] for k in ("square", "flat", "vars", "obs", "rows"))
    npts, nedges = sizes["points"], sizes["edges"]
    rng = np.random.default_rng(2027)
    device = torch.device(da.config.get("device"))
    out = {}

    def on_device(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)

    def run(name, lazy, ref, lib, nbytes, rtol=0.0):
        """``lazy()`` gives the arrays, ``ref(results)`` the pairs (got,
        numpy) to compare, ``lib()`` the torch call."""
        arrs = lazy()
        arrs = arrs if isinstance(arrs, tuple) else (arrs,)
        fi.SYNCS, tk.LAUNCHES, sk.LAUNCHES, hk.LAUNCHES = 0, 0, 0, 0
        got = da.compute(*arrs)
        syncs, p3t, p3c, k2 = fi.SYNCS, tk.LAUNCHES, sk.LAUNCHES, hk.LAUNCHES
        t0 = time.perf_counter()
        err = 0.0
        with warnings.catch_warnings(), np.errstate(all="ignore"):
            warnings.simplefilter("ignore")
            for g, w in ref(got):
                g, w = np.asarray(g), np.asarray(w)
                check(g.shape == w.shape and g.dtype == w.dtype, f"{name}: shape/dtype {g.shape} {g.dtype} against "
                                                                 f"numpy's {w.shape} {w.dtype}")
                check(np.array_equal(np.isnan(g), np.isnan(w)) if w.dtype.kind == "f" else True, f"{name}: NaNs differ")
                if rtol:
                    # the error relative to the largest of numpy's values (a mean near 0 has no relative error)
                    fin = np.isfinite(w)
                    e = float(np.abs(g[fin].astype(np.float64) - w[fin]).max() / max(np.abs(w[fin]).max(), 1e-300)) \
                        if fin.any() else 0.0
                    check(e <= rtol, f"{name}: error {e} of numpy's largest value, over {rtol}")
                    err = max(err, e)
                else:
                    check(np.array_equal(g, w, equal_nan=w.dtype.kind in "fc"), f"{name}: differs from numpy")
        ref_s = time.perf_counter() - t0
        del got

        def run_device():
            for a in arrs:
                a.compute_device()
            sync()

        out[name] = {"max_err_of_max" if rtol else "vs_numpy": err if rtol else "equal", "numpy_s": ref_s,
                     "compute_device_ms": host_ms(run_device, 5),
                     "compute_ms": host_ms(lambda: da.compute(*arrs), 3),
                     "torch_call": lib[0], "torch_call_ms": timer(lib[1]) if lib[1] else None,
                     "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "host_syncs": syncs,
                     "transpose_launches": p3t, "scale_launches": p3c, "histogram_launches": k2}
        phase(27, name, **out[name])
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # -- (n, n) float32, persisted -------------------------------------------------
    a = rng.standard_normal((n, n), dtype=np.float32)
    s = a.copy()
    s.ravel()[rng.choice(n * n, n * n // 100, replace=False)] = np.nan
    ai = (a * 100).astype(np.int32)
    x, xs, xi = (da.from_array(v, chunks=n // 4).persist() for v in (a, s, ai))
    t, ts, ti = x.compute_device(), xs.compute_device(), xi.compute_device()
    k = min(256, n)
    cols = slice(0, k)
    nb = a.nbytes
    q = [0.1, 0.5, 0.9]
    perm = rng.permutation(n)
    groups = [perm[i * (n // 4):(i + 1) * (n // 4)].tolist() for i in range(4)]
    test = np.arange(-5000, 5000, 37, dtype=np.int32)
    test_t = on_device(test)
    perm_t = on_device(perm)
    mid = [n // 2 - 1, n // 2]
    qidx = [int((n - 1) * v) for v in q]
    run("median_axis0", lambda: da.median(x, axis=0), lambda g: [(g[0][cols], np.median(a[:, cols], axis=0))],
        ("torch.sort + gather", lambda: torch.sort(t, 0).values[mid].mean(0)), nb + n * 4)
    run("quantile_axis1", lambda: da.quantile(x, q, axis=1),
        lambda g: [(g[0][:, :k], np.quantile(a[:k], q, axis=1))],
        ("torch.sort + gather", lambda: torch.sort(t, 1).values[:, qidx]), nb + 3 * n * 8, rtol=1e-6)
    run("nanmedian_axis0", lambda: da.nanmedian(xs, axis=0), lambda g: [(g[0][cols], np.nanmedian(s[:, cols], axis=0))],
        ("torch.nanmedian (the lower middle)", lambda: torch.nanmedian(ts, 0)), nb + n * 4)
    run("topk_64_axis1", lambda: da.topk(x, 64, 1), lambda g: [(g[0][:k], -np.sort(-a[:k], axis=1)[:, :64])],
        ("torch.topk", lambda: torch.topk(t, 64, 1)), nb + n * 64 * 4)
    run("argtopk_-64_axis0", lambda: da.argtopk(x, -64, 0),
        lambda g: [(np.take_along_axis(a[:, cols], g[0][:, cols], 0), np.sort(a[:, cols], axis=0)[:64])],
        ("torch.topk(largest=False)", lambda: torch.topk(t, 64, 0, largest=False)), nb + n * 64 * 8)
    run("coarsen_mean_4x4", lambda: da.coarsen(np.mean, x, {0: 4, 1: 4}),
        lambda g: [(g[0][:k // 4], a[:k].reshape(k // 4, 4, n // 4, 4).mean(axis=(1, 3)))],
        ("F.avg_pool2d", lambda: torch.nn.functional.avg_pool2d(t[None, None], 4)), nb + nb // 16, rtol=1e-6)
    run("gradient", lambda: tuple(da.gradient(x)),
        lambda g: [(g[0][:k], np.gradient(a[:k + 1], axis=0)[:k]), (g[0][-1], np.gradient(a[-2:], axis=0)[-1]),
                   (g[1][:k], np.gradient(a[:k], axis=1))],
        ("torch.gradient", lambda: torch.gradient(t)), 3 * nb)
    run("apply_along_axis_ptp", lambda: da.apply_along_axis(lambda r: r.amax() - r.amin(), 1, x),
        lambda g: [(g[0][:k], np.ptp(a[:k], axis=1))], ("t.amax(1) - t.amin(1)", lambda: t.amax(1) - t.amin(1)),
        nb + n * 4)
    run("apply_gufunc_max", lambda: da.apply_gufunc(lambda v: v.amax(-1), "(i)->()", x, allow_rechunk=True),
        lambda g: [(g[0][:k], a[:k].max(axis=1))], ("t.amax(1)", lambda: t.amax(1)), nb + n * 4)
    run("shuffle_4_row_groups", lambda: da.shuffle(x, groups, axis=0),
        lambda g: [(g[0][:k], a[perm[:k]])], ("torch.index_select", lambda: torch.index_select(t, 0, perm_t)), 2 * nb)
    run("isin_int32", lambda: da.isin(xi, test), lambda g: [(g[0][:k], np.isin(ai[:k], test))],
        ("torch.isin", lambda: torch.isin(ti, test_t)), nb + n * n)
    del x, xs, xi, t, ts, ti, a, s, ai

    # -- flat elements: histograms, counts, search, index math ---------------------
    h = rng.standard_normal(flat, dtype=np.float32)
    hy = rng.standard_normal(flat, dtype=np.float32)
    w = rng.random(flat, dtype=np.float32)
    ints = rng.integers(0, 65536, flat)
    u32 = rng.integers(0, 1 << 20, flat, dtype=np.int32)
    edges = np.sort(rng.standard_normal(257) * 2)
    hv, hyv, wv, iv, uv = (da.from_array(v, chunks=flat // 4).persist() for v in (h, hy, w, ints, u32))
    ht, hyt, it, ut = hv.compute_device(), hyv.compute_device(), iv.compute_device(), uv.compute_device()
    wt = wv.compute_device()
    edges_t = on_device(edges)
    hb = h.nbytes
    run("histogram_256", lambda: da.histogram(hv, bins=256, range=(-4, 4))[0],
        lambda g: [(g[0], np.histogram(h, bins=256, range=(-4, 4))[0])],
        ("torch.histc", lambda: torch.histc(ht, 256, -4, 4)), hb + 256 * 8)
    run("histogram_256_weighted", lambda: da.histogram(hv, bins=256, range=(-4, 4), weights=wv)[0],
        lambda g: [(g[0], np.histogram(h, bins=256, range=(-4, 4), weights=w)[0])],
        ("torch.bucketize + torch.bincount", None), 2 * hb + 256 * 4, rtol=1e-4)
    run("histogram_257_edges", lambda: da.histogram(hv, bins=edges)[0], lambda g: [(g[0], np.histogram(h, bins=edges)[0])],
        ("torch.bucketize + torch.bincount", lambda: torch.bincount(torch.bucketize(ht, edges_t.float()), minlength=258)),
        hb + 256 * 8)
    run("histogram2d_64x64", lambda: da.histogram2d(hv, hyv, bins=64, range=[(-4, 4), (-4, 4)])[0],
        lambda g: [(g[0], np.histogram2d(h, hy, bins=64, range=[(-4, 4), (-4, 4)])[0])],
        ("torch.bucketize x2 + torch.bincount", None), 2 * hb + 64 * 64 * 8)
    run("bincount_65536", lambda: da.bincount(iv), lambda g: [(g[0], np.bincount(ints))],
        ("torch.bincount", lambda: torch.bincount(it)), ints.nbytes + 65536 * 8)
    run("bincount_65536_weighted", lambda: da.bincount(iv, weights=wv),
        lambda g: [(g[0], np.bincount(ints, weights=w))], ("torch.bincount(weights)", lambda: torch.bincount(it, wt)),
        ints.nbytes + w.nbytes + 65536 * 8, rtol=1e-9)
    counts = np.bincount(u32, minlength=1 << 20)
    run("unique_counts_int32", lambda: da.unique(uv, return_counts=True),
        lambda g: [(g[0], np.nonzero(counts)[0].astype(np.int32)), (g[1], counts[counts > 0])],
        ("torch.unique(return_counts=True)", lambda: torch.unique(ut, return_counts=True)),
        u32.nbytes + int((counts > 0).sum()) * 12)
    for name in ("histogram_256", "histogram_256_weighted", "histogram_257_edges", "bincount_65536",
                 "bincount_65536_weighted"):
        check(out[name]["histogram_launches"] == 1 or device.type != "cuda", f"{name}: the histogram kernel "
              f"launched {out[name]['histogram_launches']} times")
    del h, hy, w, ints, u32, counts, hv, hyv, wv, iv, uv, ht, hyt, it, ut, wt
    sorted_edges = np.sort(rng.standard_normal(nedges))
    vals = rng.standard_normal(npts) * 1.1
    se_v, vals_v = da.from_array(sorted_edges, chunks=nedges).persist(), da.from_array(vals, chunks=npts // 4).persist()
    se_t, vals_t = se_v.compute_device(), vals_v.compute_device()
    part = slice(0, npts // 16)  # numpy's searches of 2^24 values take 10 s each: a sixteenth of them
    run("searchsorted_2^24_into_2^20", lambda: da.searchsorted(se_v, vals_v),
        lambda g: [(g[0][part], np.searchsorted(sorted_edges, vals[part]))],
        ("torch.searchsorted", lambda: torch.searchsorted(se_t, vals_t)), vals.nbytes + sorted_edges.nbytes + npts * 8)
    run("digitize_2^24_into_2^20", lambda: da.digitize(vals_v, sorted_edges),
        lambda g: [(g[0][part], np.digitize(vals[part], sorted_edges))],
        ("torch.bucketize(right=True)", lambda: torch.bucketize(vals_t, se_t, right=True)),
        vals.nbytes + sorted_edges.nbytes + npts * 8)
    del se_v, vals_v, se_t, vals_t, vals
    ci, cj = rng.integers(0, 4096, npts), rng.integers(0, 4096, npts)
    civ, cjv = (da.from_array(v, chunks=npts // 4).persist() for v in (ci, cj))
    cit, cjt = civ.compute_device(), cjv.compute_device()
    run("ravel_multi_index_2^24", lambda: da.ravel_multi_index((civ, cjv), (4096, 4096)),
        lambda g: [(g[0], np.ravel_multi_index((ci, cj), (4096, 4096)))], ("i * 4096 + j", lambda: cit * 4096 + cjt),
        3 * npts * 8)
    flat_idx = ci * 4096 + cj
    fv = da.from_array(flat_idx, chunks=npts // 4).persist()
    ft = fv.compute_device()
    run("unravel_index_2^24", lambda: da.unravel_index(fv, (4096, 4096)),
        lambda g: list(zip(g, np.unravel_index(flat_idx, (4096, 4096)))),
        ("// and %", lambda: (torch.div(ft, 4096, rounding_mode="floor"), ft % 4096)), 3 * npts * 8)
    del civ, cjv, cit, cjt, fv, ft, ci, cj, flat_idx

    # -- cov and corrcoef: vars x obs float32 ---------------------------------------
    X = rng.standard_normal((nv, nobs), dtype=np.float32)
    X += np.arange(nv, dtype=np.float32)[:, None] * 0.01 * X[:1]  # correlated variables
    aw = rng.random(nobs) + 0.5
    Xv = da.from_array(X, chunks=(nv, nobs // 4)).persist()
    Xt = Xv.compute_device()
    top = X[:32]
    cov_bytes = X.nbytes + nv * nv * 8
    run("cov", lambda: da.cov(Xv), lambda g: [(g[0][:32, :32], np.cov(top))],
        ("torch.cov (float64)", lambda: torch.cov(Xt.double())), cov_bytes, rtol=1e-9)
    run("corrcoef", lambda: da.corrcoef(Xv), lambda g: [(g[0][:32, :32], np.corrcoef(top))],
        ("torch.corrcoef (float64)", lambda: torch.corrcoef(Xt.double())), cov_bytes, rtol=1e-9)
    aw_t = on_device(aw)
    run("cov_aweights", lambda: da.cov(Xv, aweights=aw), lambda g: [(g[0][:32, :32], np.cov(top, aweights=aw))],
        ("torch.cov(aweights) (float64)", lambda: torch.cov(Xt.double(), aweights=aw_t)), cov_bytes + aw.nbytes,
        rtol=1e-9)
    for name in ("cov", "corrcoef", "cov_aweights"):
        check(out[name]["transpose_launches"] >= 1 or device.type != "cuda", f"{name}: no transpose launch")
    check(out["cov_aweights"]["scale_launches"] >= 1 or device.type != "cuda", "cov_aweights: no scale launch")
    if device.type == "cuda":
        # the two kernels at cov's shapes against their plain versions
        X64 = Xt.double()
        check_transpose(tk, X64, "transpose (vars, obs) float64")
        row = torch.from_numpy(aw.reshape(1, nobs)).to(device)
        check(same_values(sk.scale_cuda(X64, row), sk.scale_plain(X64, row)), "scale (vars, obs) float64 by a row")
        check(same_values(sk.scale_cuda(X64, 1.0 / (nobs - 1)), sk.scale_plain(X64, 1.0 / (nobs - 1))),
              "scale (vars, obs) float64 by a scalar")
        phase(27, "kernels-at-cov-shape", shape=[nv, nobs], dtype="float64",
              transpose="equal bytes to its plain version", scale="a row and a scalar: equal bytes to its plain version")
        del X64, row
    del Xv, Xt, X, top

    # -- repeat with one count per row -----------------------------------------------
    r = rng.standard_normal((nr, nr), dtype=np.float32)
    reps = rng.integers(0, 4, nr)
    rv = da.from_array(r, chunks=nr // 4).persist()
    rt, reps_t = rv.compute_device(), on_device(reps)
    run("repeat_counts_rows", lambda: da.repeat(rv, reps, axis=0), lambda g: [(g[0], np.repeat(r, reps, axis=0))],
        ("torch.repeat_interleave", lambda: torch.repeat_interleave(rt, reps_t, dim=0)),
        r.nbytes + int(reps.sum()) * nr * 4)
    del rv, rt, r
    return out


RANDOM_SIZES = {"leaf": 16384, "values": 1 << 24, "nsample": 50, "tree": 10000, "tree_chunk": 1000,
                "stencil": 4096, "stencil_chunk": 1024, "svd_rows": 1_000_000, "svd_cols": 128,
                "svd_chunk": 100_000, "relayout": 8192, "relayout_chunk": 1024, "rfft": 16384, "rfft_rows": 2048,
                "fft2": 8192, "fftn": 512, "check": 4096, "check3": 256, "cs_rows": 1_000_000,
                "cs_cols": 1024, "cs_chunk": 100_000, "cs_k": 32, "multi": 16384}

# phase 28 (b): name -> (draw of (generator, n values), scipy law and its arguments); the
# several-column laws draw n values in all and are held by one column's marginal law
RANDOM_LAWS = {
    "random": (lambda r, n: r.random(n), ("uniform", ())),
    "uniform": (lambda r, n: r.uniform(-1, 3, n), ("uniform", (-1, 4))),
    "normal": (lambda r, n: r.normal(1, 2, n), ("norm", (1, 2))),
    "standard_normal": (lambda r, n: r.standard_normal(n), ("norm", ())),
    "integers": (lambda r, n: r.integers(-5, 12, n), ("randint", (-5, 12))),
    "integers_uint64_2^64": (lambda r, n: r.integers(0, 2**64, n, dtype="uint64") / 2.0**64,
                             ("uniform", ())),
    "beta": (lambda r, n: r.beta(2, 3, n), ("beta", (2, 3))),
    "binomial": (lambda r, n: r.binomial(10, 0.3, n), ("binom", (10, 0.3))),
    "chisquare": (lambda r, n: r.chisquare(3, n), ("chi2", (3,))),
    "exponential": (lambda r, n: r.exponential(2, n), ("expon", (0, 2))),
    "standard_exponential": (lambda r, n: r.standard_exponential(n), ("expon", ())),
    "f": (lambda r, n: r.f(5, 20, n), ("f", (5, 20))),
    "gamma": (lambda r, n: r.gamma(2.5, 1.5, n), ("gamma", (2.5, 0, 1.5))),
    "standard_gamma": (lambda r, n: r.standard_gamma(0.5, n), ("gamma", (0.5,))),
    "geometric": (lambda r, n: r.geometric(0.3, n), ("geom", (0.3,))),
    "gumbel": (lambda r, n: r.gumbel(1, 2, n), ("gumbel_r", (1, 2))),
    "laplace": (lambda r, n: r.laplace(1, 2, n), ("laplace", (1, 2))),
    "logistic": (lambda r, n: r.logistic(1, 2, n), ("logistic", (1, 2))),
    "lognormal": (lambda r, n: r.lognormal(0.5, 0.25, n), ("lognorm", (0.25, 0, 1.6487212707001282))),
    "negative_binomial": (lambda r, n: r.negative_binomial(5, 0.4, n), ("nbinom", (5, 0.4))),
    "pareto": (lambda r, n: r.pareto(10, n), ("lomax", (10,))),
    "poisson": (lambda r, n: r.poisson(4, n), ("poisson", (4,))),
    "power": (lambda r, n: r.power(3, n), ("powerlaw", (3,))),
    "rayleigh": (lambda r, n: r.rayleigh(2, n), ("rayleigh", (0, 2))),
    "standard_cauchy": (lambda r, n: r.standard_cauchy(n), ("cauchy", ())),
    "standard_t": (lambda r, n: r.standard_t(10, n), ("t", (10,))),
    "triangular": (lambda r, n: r.triangular(0, 1, 3, n), ("triang", (1 / 3, 0, 3))),
    "vonmises": (lambda r, n: r.vonmises(0.0, 2, n), ("vonmises", (2,))),
    "wald": (lambda r, n: r.wald(2, 3, n), ("invgauss", (2 / 3, 0, 3))),
    "weibull": (lambda r, n: r.weibull(2, n), ("weibull_min", (2,))),
    "hypergeometric": (lambda r, n: r.hypergeometric(100, 100, RANDOM_SIZES["nsample"], n),
                       ("hypergeom", (200, 100, RANDOM_SIZES["nsample"]))),
    "logseries": (lambda r, n: r.logseries(0.6, n), ("logser", (0.6,))),
    "noncentral_chisquare": (lambda r, n: r.noncentral_chisquare(3, 2, n), ("ncx2", (3, 2))),
    "noncentral_f": (lambda r, n: r.noncentral_f(5, 20, 2, n), ("ncf", (5, 20, 2))),
    "zipf": (lambda r, n: r.zipf(6, n), ("zipf", (6,))),
    "multinomial": (lambda r, n: r.multinomial(20, [0.1, 0.2, 0.3, 0.4], n // 4)[:, 1], ("binom", (20, 0.2))),
    "multivariate_hypergeometric": (
        lambda r, n: r.multivariate_hypergeometric([40, 60, 100], RANDOM_SIZES["nsample"], n // 3)[:, 0],
        ("hypergeom", (200, 40, RANDOM_SIZES["nsample"]))),
    "multivariate_normal": (lambda r, n: r.multivariate_normal([1.0, -2.0], [[2.0, 0.5], [0.5, 1.0]], n // 2)[:, 0],
                            ("norm", (1.0, 2.0**0.5))),
    "permutation": (lambda r, n: r.permutation(n), None),
}


def random_paths(da, torch, sizes, timer, sync, device):
    """da.random, fft, svd_compressed and multi-output map_blocks on the
    configured device (phase 28): (a) a random
    leaf at (leaf,)^2 float32 beside torch.randn; (b) every distribution at
    ``values`` float64 values, held to its law's mean and variance; (c) the
    BASELINE pipelines drawn by ``da.random`` beside their numpy-input
    forms; (d) the FFTs beside torch.fft; (e) svd_compressed of a persisted
    rank-``cs_k`` matrix; (f) a two-output map_blocks.  Returns one dict of
    numbers per part and the hand kernels' launches on (c) and (e)."""
    import numpy as np
    from scipy import stats

    from dask_array_tpu_torch._materialize import compute_exprs
    from dask_array_tpu_torch.kernels import mstat, stencil
    from dask_array_tpu_torch.kernels import scale as sk
    from dask_array_tpu_torch.kernels import transpose as tk
    from dask_array_tpu_torch.models import pipelines as P
    from dask_array_tpu_torch.ops import _fancy_indexing
    from dask_array_tpu_torch.ops._map_blocks import map_blocks_multi_output

    out = {}

    def dev_ms(arrays, reps=3):
        exprs = [a.expr for a in arrays]
        return host_ms(lambda: (compute_exprs(exprs), sync()), reps)

    # -- (a) the random leaf: the same bytes twice and on two grids; two draws differ
    n = sizes["leaf"]
    draw = lambda chunks: da.random.default_rng(0).standard_normal((n, n), dtype="float32", chunks=chunks)  # noqa: E731
    leaf = draw(n // 4)
    a = leaf.compute_device()
    check(a.device.type == device.type and a.dtype == torch.float32, "random leaf: device/dtype")
    check(bool(torch.equal(a, draw(n // 4).compute_device())), "random leaf: one seed, two runs differ")
    check(bool(torch.equal(a, draw(n // 16).compute_device())), "random leaf: the chunk grid changed values")
    r = da.random.default_rng(0)
    r.standard_normal((n, n), dtype="float32", chunks=n // 4)
    second = r.standard_normal((n, n), dtype="float32", chunks=n // 4).compute_device()
    check(not bool(torch.equal(a, second)), "random leaf: two draws are equal")
    del second
    z_mean = float(a.double().mean()) * n  # the mean over its standard error 1 / n
    check(abs(z_mean) < 6 and abs(float(a.double().std()) - 1) < 6 * (0.5 / n**2) ** 0.5, "random leaf: moments")
    gen = torch.Generator(device=device).manual_seed(0)
    nbytes = n * n * 4
    out["a"] = {"shape": [n, n], "chunks": [n // 4, n // 16], "same_bytes_twice": True,
                "same_bytes_on_both_grids": True, "two_draws_differ": True, "mean_over_se": z_mean,
                "compute_device_ms": host_ms(lambda: (leaf.compute_device(), sync()), 5),
                "compute_device_event_ms": timer(leaf.compute_device),
                "torch_randn_ms": timer(lambda: torch.randn((n, n), generator=gen, device=device)),
                "bound_ms": bound(nbytes, 0)[0], "bound_by": "bytes"}
    del a

    # -- (b) every distribution at ``values`` values: time, host syncs, moments
    nv = sizes["values"]
    laws = {}
    for name, (call, law) in RANDOM_LAWS.items():
        x = call(da.random.default_rng(28), nv)
        _fancy_indexing.SYNCS = 0
        v = x.compute_device()
        sync()
        syncs = _fancy_indexing.SYNCS
        ms = host_ms(lambda: (x.compute_device(), sync()), 3)
        v = v.double()
        count = v.numel()
        got = {"ms": ms, "syncs": syncs, "values": count, "dtype": str(x.dtype)}
        if law is None:  # the permutation: every index once
            check(bool(torch.equal(v.sort().values, torch.arange(count, device=v.device, dtype=v.dtype))),
                  "permutation is not one")
            laws[name] = got
            continue
        mean, var, kurt = (float(t) for t in getattr(stats, law[0])(*law[1]).stats(moments="mvk"))
        if np.isfinite(mean):
            se_mean, se_var = (var / count) ** 0.5, ((kurt + 2) * var**2 / count) ** 0.5
            got.update(mean=float(v.mean()), var=float(v.var(correction=0)), law_mean=mean, law_var=var)
            got.update(mean_over_se=(got["mean"] - mean) / se_mean, var_over_se=(got["var"] - var) / se_var)
            check(abs(got["mean_over_se"]) <= 6 and abs(got["var_over_se"]) <= 6, f"{name}: moments {got}")
        else:  # Cauchy: its median, standard error pi / (2 sqrt(n))
            got.update(median=float(v.median()))
            check(abs(got["median"]) <= 6 * np.pi / 2 / count**0.5, f"{name}: median {got}")
        check(bool(torch.isfinite(v).all()), f"{name}: non-finite values")
        laws[name] = got
        del v
    out["b"] = laws

    # -- (c) the BASELINE pipelines drawn by da.random beside their numpy-input forms
    counters = {"band_stencil": stencil, "multi_stat": mstat, "transpose": tk, "scale": sk}

    def launches(fn):
        for m in counters.values():
            m.LAUNCHES = 0
        res = fn()
        return res, {k: m.LAUNCHES for k, m in counters.items()}

    def host(seed, shape, chunks):
        return da.random.default_rng(seed).standard_normal(shape, dtype="float32", chunks=chunks).compute()

    pipes = {}
    nt, ct = sizes["tree"], sizes["tree_chunk"]
    x_np = host(0, (nt, nt), ct)
    forms = {"random": P.reduction_tree(chunk=ct, n=nt), "numpy": P.reduction_tree(x_np, chunk=ct)}
    res = {}
    for form, arrays in forms.items():
        res[form], lc = launches(lambda: da.compute(*arrays))
        pipes[f"reduction_tree_{form}"] = {"compute_ms": host_ms(lambda: da.compute(*arrays), 3),
                                           "compute_device_ms": dev_ms(arrays), "launches": lc}
        check(lc["multi_stat"] == 1, f"reduction_tree {form}: multi-statistic launches {lc}")
    check(all(np.asarray(g).tobytes() == np.asarray(w).tobytes() for g, w in zip(res["random"], res["numpy"])),
          "reduction_tree: the random-input form differs from the numpy form")
    xd = torch.from_numpy(x_np).to(device)
    ref64 = [xd.double().sum(0), xd.double().mean(1), xd.double().std(correction=0)]
    pipes["reduction_tree_random"]["max_abs_err_vs_f64"] = stats_errors(res["random"], ref64, xd)
    del xd, ref64, x_np

    ns, cs = sizes["stencil"], sizes["stencil_chunk"]
    x_np = host(0, (ns, ns), cs)
    forms = {"random": P.stencil2d(chunk=cs, form="roll", n=ns), "numpy": P.stencil2d(x_np, chunk=cs, form="roll")}
    for form, arr in forms.items():
        res[form], lc = launches(arr.compute)
        pipes[f"stencil2d_roll_{form}"] = {"compute_ms": host_ms(arr.compute, 3), "compute_device_ms": dev_ms([arr]),
                                           "launches": lc}
        check(lc["band_stencil"] == 1, f"stencil2d {form}: band-stencil launches {lc}")
    check(res["random"].tobytes() == res["numpy"].tobytes(), "stencil2d: the two forms differ")
    xd = torch.from_numpy(x_np).to(device)
    want = stencil.band_stencil_plain(xd, P.laplace_roll, (1, 1), ("reflect", "reflect"))
    atol = 8 * float(xd.abs().max()) * 2.0**-21
    got = torch.from_numpy(res["random"]).to(device)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    pipes["stencil2d_roll_random"]["max_abs_err_vs_plain"] = float((got - want).abs().max())
    del xd, want, got, x_np

    nr, nc, cr = sizes["svd_rows"], sizes["svd_cols"], sizes["svd_chunk"]
    x_np = host(0, (nr, nc), (cr, nc))
    forms = {"random": P.tall_skinny_svd(chunk_rows=cr, rows=nr, cols=nc),
             "numpy": P.tall_skinny_svd(x_np, chunk_rows=cr)}
    for form, arrays in forms.items():
        res[form], lc = launches(lambda: da.compute(*arrays))
        pipes[f"tall_skinny_svd_{form}"] = {"compute_ms": host_ms(lambda: da.compute(*arrays), 3),
                                            "compute_device_ms": dev_ms(arrays), "launches": lc}
        check(lc["scale"] == 3, f"tall_skinny_svd {form}: scale launches {lc}")
    check(all(g.tobytes() == w.tobytes() for g, w in zip(res["random"], res["numpy"])),
          "tall_skinny_svd: the two forms differ")
    s64 = torch.linalg.svdvals(torch.from_numpy(x_np).to(device).double())
    s_err = float((torch.from_numpy(res["random"][1]).to(device).double() - s64).abs().max() / s64.max())
    check(s_err < 1e-4, f"tall_skinny_svd: s relative error {s_err}")
    pipes["tall_skinny_svd_random"]["s_max_rel_err_vs_f64"] = s_err
    del s64, x_np

    nl, cl = sizes["relayout"], sizes["relayout_chunk"]
    x_np = host(0, (nl, nl), (cl, nl))
    forms = {"random": P.rechunk_relayout(chunk=cl, n=nl), "numpy": P.rechunk_relayout(x_np, chunk=cl)}
    for form, arr in forms.items():
        res[form], lc = launches(arr.compute)
        pipes[f"rechunk_relayout_{form}"] = {"compute_ms": host_ms(arr.compute, 3), "compute_device_ms": dev_ms([arr]),
                                             "launches": lc}
        check(lc["transpose"] == 1, f"rechunk_relayout {form}: transpose launches {lc}")
        check(res[form].tobytes() == np.ascontiguousarray(x_np.T).tobytes(), f"rechunk_relayout {form}: bytes")
    del x_np, res
    out["c"] = pipes
    kernel_launches = {k: sum(p["launches"][k] for name, p in pipes.items() if name.endswith("_random"))
                       for k in counters}

    # -- (d) the FFTs beside torch.fft on the tensor already on the device
    ffts = {}

    def fft_case(name, port, plain, nbytes, small_port, small_numpy, tol):
        y = port()
        ms = host_ms(lambda: (y.compute_device(), sync()), 5)
        got_small = small_port().compute()
        want_small = small_numpy()
        check(got_small.dtype == want_small.dtype, f"{name}: dtype {got_small.dtype} against {want_small.dtype}")
        err = float(np.abs(got_small.astype(np.complex128) - want_small).max() / np.abs(want_small).max())
        check(err <= tol, f"{name}: relative error {err} against numpy")
        ffts[name] = {"compute_device_ms": ms, "torch_fft_ms": timer(plain), "bound_ms": bound(nbytes, 0)[0],
                      "bound_by": "bytes", "max_rel_err_vs_numpy_small": err, "tolerance": tol}

    nf, rows = sizes["rfft"], sizes["rfft_rows"]
    x = da.random.default_rng(1).standard_normal((nf, nf), dtype="float32", chunks=(rows, nf)).persist()
    xt = x.compute_device()
    k = sizes["check"]
    xs = da.random.default_rng(11).standard_normal((k, k), dtype="float32", chunks=(k // 8, k))
    xs_np = xs.compute()
    fft_case("rfft_axis1", lambda: da.fft.rfft(x, axis=1), lambda: torch.fft.rfft(xt, dim=1),
             nf * nf * 4 + nf * (nf // 2 + 1) * 8, lambda: da.fft.rfft(xs, axis=1),
             lambda: np.fft.rfft(xs_np, axis=1), 1e-5)
    rt = da.fft.irfft(da.fft.rfft(x, axis=1), n=nf, axis=1)
    rt_err = float((rt.compute_device() - xt).abs().max() / xt.abs().max())
    check(rt_err <= 1e-5, f"irfft round trip: relative error {rt_err}")
    fft_case("irfft_of_rfft", lambda: rt, lambda: torch.fft.irfft(torch.fft.rfft(xt, dim=1), n=nf, dim=1),
             2 * nf * nf * 4, lambda: da.fft.irfft(da.fft.rfft(xs, axis=1), n=k, axis=1),
             lambda: np.fft.irfft(np.fft.rfft(xs_np, axis=1), n=k, axis=1), 1e-5)
    ffts["irfft_of_rfft"]["round_trip_max_rel_err"] = rt_err
    del x, xt, rt

    def complex_draw(seed, shape, chunks):
        g = da.random.default_rng(seed)
        re, im = (g.standard_normal(shape, dtype="float32", chunks=chunks) for _ in range(2))
        z = re + 1j * im
        check(z.dtype == np.complex64, f"complex draw dtype {z.dtype}")
        return z

    n2 = sizes["fft2"]
    z = complex_draw(2, (n2, n2), n2).persist()
    zt = z.compute_device()
    zs = complex_draw(12, (k, k), k)
    zs_np = zs.compute()
    fft_case("fft2_complex64", lambda: da.fft.fft2(z), lambda: torch.fft.fft2(zt), 2 * n2 * n2 * 8,
             lambda: da.fft.fft2(zs), lambda: np.fft.fft2(zs_np), 1e-5)
    del z, zt
    n3, k3 = sizes["fftn"], sizes["check3"]
    z = complex_draw(3, (n3, n3, n3), n3).persist()
    zt = z.compute_device()
    zs = complex_draw(13, (k3, k3, k3), k3)
    zs_np = zs.compute()
    fft_case("fftn_complex64", lambda: da.fft.fftn(z), lambda: torch.fft.fftn(zt), 2 * n3**3 * 8,
             lambda: da.fft.fftn(zs), lambda: np.fft.fftn(zs_np), 1e-5)
    del z, zt, zs_np, xs_np
    out["d"] = ffts

    # -- (e) svd_compressed of a persisted rank-k matrix plus noise
    m, ncs, ch, kk = sizes["cs_rows"], sizes["cs_cols"], sizes["cs_chunk"], sizes["cs_k"]
    g = da.random.default_rng(5)
    a_ = g.standard_normal((m, kk), dtype="float32", chunks=(ch, kk))
    b_ = g.standard_normal((kk, ncs), dtype="float32", chunks=(kk, ncs))
    noise = g.standard_normal((m, ncs), dtype="float32", chunks=(ch, ncs))
    x = (a_ @ b_ + 1e-4 * noise).persist()
    s_exact = da.linalg.svd(x)[1].compute_device()[:kk].double()
    cu, cs, cvh = da.svd_compressed(x, k=kk, n_power_iter=2, seed=0)
    got, lc = launches(lambda: compute_exprs([cu.expr, cs.expr, cvh.expr]))
    check(lc["scale"] >= 1, f"svd_compressed: scale launches {lc}")
    s_err = float(((got[1].double() - s_exact).abs() / s_exact).max())
    check(s_err <= 1e-3, f"svd_compressed: s relative error {s_err} against svd")
    orth = float((got[0].double().mT @ got[0].double() - torch.eye(kk, device=got[0].device, dtype=torch.float64))
                 .abs().max())
    out["e"] = {"shape": [m, ncs], "chunk_rows": ch, "k": kk, "n_power_iter": 2, "s_max_rel_err_vs_svd": s_err,
                "u_orthogonality_max": orth, "launches": lc,
                "compute_device_ms": dev_ms([cu, cs, cvh]), "compute_ms": host_ms(lambda: da.compute(cu, cs, cvh), 3),
                "svd_compute_device_ms": dev_ms([da.linalg.svd(x)[1]])}
    kernel_launches["scale_svd_compressed"] = lc["scale"]
    del x, got, s_exact

    # -- (f) a two-output map_blocks: the function runs once per block
    nm = sizes["multi"]
    x = da.random.default_rng(6).standard_normal((nm, nm), dtype="float32", chunks=nm // 4).persist()
    xt = x.compute_device()
    calls = [0]

    def sin_cos(b):
        calls[0] += 1
        return torch.sin(b), torch.cos(b)

    s_, c_ = map_blocks_multi_output(sin_cos, x, dtypes=["float32", "float32"])
    got = compute_exprs([s_.expr, c_.expr])
    blocks = int(np.prod(x.numblocks))
    check(calls[0] == blocks, f"map_blocks_multi_output: {calls[0]} calls for {blocks} blocks")
    err = max(float((got[0] - torch.sin(xt)).abs().max()), float((got[1] - torch.cos(xt)).abs().max()))
    check(err <= 1e-6, f"map_blocks_multi_output: error {err} against torch.sin/cos")
    del got
    out["f"] = {"shape": [nm, nm], "blocks": blocks, "calls_per_compute": blocks, "max_abs_err": err,
                "tolerance": "1e-6 against torch.sin/cos of the whole tensor",
                "compute_device_ms": dev_ms([s_, c_]),
                "torch_sin_cos_ms": timer(lambda: (torch.sin(xt), torch.cos(xt))),
                "bound_ms": bound(3 * nm * nm * 4, 0)[0]}
    del x, xt
    return out, kernel_launches


IO_SIZES = {"stencil": 16384, "stencil_chunk": 4096, "relayout": 8192, "relayout_chunk": 1024, "surface": 4096,
            "surface_chunk": 1024, "plan_blocks": 600}


def io_paths(da, torch, sizes, sync, device, root):
    """IO and interop on the configured device (phase 29), writing under a
    temporary directory in ``root`` (deleted at the end): (a) stencil2d's
    roll form to zarr (v2, raw) beside np.save; (b) from_zarr of it through
    the reductions path; (c) a culled read; (d) rechunk_relayout to an npy
    stack and back; (e) store, from_map, from_delayed, from_blocks, barrier;
    (f) the xarray chunk manager with numpy callables; (g) plankit.
    Returns one dict of numbers per part and the kernels' launches."""
    import shutil
    import tempfile

    import numpy as np

    from dask_array_tpu_torch import _host, native
    from dask_array_tpu_torch._chunks import common_blockdim, unify_blockdims
    from dask_array_tpu_torch._materialize import compute_exprs
    from dask_array_tpu_torch._slicing import sliced_blockdim
    from dask_array_tpu_torch._xarray import make_manager_class
    from dask_array_tpu_torch.io import _from_map, delayed
    from dask_array_tpu_torch.io._from_map import FromMap
    from dask_array_tpu_torch.kernels import mstat, stencil
    from dask_array_tpu_torch.kernels import transpose as tk
    from dask_array_tpu_torch.models import pipelines as P
    from dask_array_tpu_torch.ops._multistat import MultiStat, fuse_multi_stat

    out = {}
    launches = {}
    root.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="io-", dir=root)
    try:
        # -- (a) write: stencil2d's roll form to zarr, beside np.save of the same array
        n, c = sizes["stencil"], sizes["stencil_chunk"]
        x_np = np.random.default_rng(29).random((n, n), dtype=np.float32)
        arr = P.stencil2d(x_np, chunk=c, form="roll")
        url = f"{tmp}/stencil.zarr"
        stencil.LAUNCHES = 0
        t0 = time.perf_counter()
        arr.to_zarr(url, zarr_format=2)
        write_s = time.perf_counter() - t0
        launches["band_stencil"] = stencil.LAUNCHES
        check(stencil.LAUNCHES == 1, f"to_zarr of stencil2d: band-stencil launches {stencil.LAUNCHES}")
        ref = arr.compute()
        t0 = time.perf_counter()
        np.save(f"{tmp}/stencil.npy", ref)
        npsave_s = time.perf_counter() - t0
        equal_files = 0
        for i in range(n // c):
            for j in range(n // c):
                raw = np.fromfile(f"{url}/{i}.{j}", dtype=np.float32)
                check(raw.tobytes() == np.ascontiguousarray(ref[i * c:(i + 1) * c, j * c:(j + 1) * c]).tobytes(),
                      f"to_zarr: chunk file {i}.{j} differs from compute()")
                equal_files += 1
        nbytes = n * n * 4
        out["a"] = {"shape": [n, n], "chunks": c, "chunk_files_equal": equal_files, "to_zarr_s": write_s,
                    "to_zarr_GBps": nbytes / write_s / 1e9, "np_save_s": npsave_s,
                    "np_save_GBps": nbytes / npsave_s / 1e9, "band_stencil_launches": launches["band_stencil"]}
        del x_np, arr

        # -- (b) read: from_zarr through the reductions path (the multi-statistic route)
        z = da.from_zarr(url)
        check(type(z.expr) is FromMap and z.numblocks == (n // c, n // c),
              f"from_zarr: {type(z.expr).__name__} of {z.numblocks} blocks")
        stats = [z.sum(0), z.mean(1), z.var()]
        # the route is taken where the fused plans hold a MultiStat node over
        # the FromMap leaf; where not, the reason is reported, not forced
        fused = fuse_multi_stat([st.expr for st in stats])
        routed = [type(nd.array).__name__ for e in fused for nd in e.walk() if isinstance(nd, MultiStat)]
        mstat.LAUNCHES = 0
        _from_map.LOADS = 0
        got = da.compute(*stats)
        launches["multi_stat"] = mstat.LAUNCHES
        loads = _from_map.LOADS
        check(loads == (n // c) ** 2, f"from_zarr read: {loads} loads for {(n // c) ** 2} blocks")
        check(mstat.LAUNCHES == (1 if routed else 0), f"from_zarr read: multi-statistic launches {mstat.LAUNCHES}, "
              f"route over {routed}")
        route = (f"MultiStat over {routed[0]}" if routed else
                 "not taken: fuse_multi_stat found fewer than two of its statistics of one float32 operand")
        xd = torch.from_numpy(ref).to(device)
        ref64 = [xd.double().sum(0), xd.double().mean(1), xd.double().std(correction=0)]
        errs = stats_errors([got[0], got[1], np.sqrt(got[2])], ref64, xd)
        del ref64
        cd_ms = host_ms(lambda: (compute_exprs([s.expr for s in stats]), sync()), 3)
        zarr_arr = da.io._zarr._require_zarr().open_array(url, mode="r")
        slices = [(slice(i * c, (i + 1) * c), slice(j * c, (j + 1) * c)) for i in range(n // c) for j in range(n // c)]
        t0 = time.perf_counter()
        blocks = [zarr_arr[sl] for sl in slices]
        read_ms = (time.perf_counter() - t0) * 1e3
        upload_ms = host_ms(lambda: ([torch.from_numpy(b).to(device) for b in blocks], sync()), 3)
        del blocks
        out["b"] = {"blocks": (n // c) ** 2, "block_MiB": c * c * 4 / 2**20, "loads": loads,
                    "multi_stat_launches": launches["multi_stat"], "multi_stat_route": route,
                    "max_abs_err_colsum_rowmean_std": errs,
                    "tolerance": STATS_TOLERANCE + " (std as the square root of var)",
                    "compute_device_ms": cd_ms, "chunk_reads_ms": read_ms, "upload_ms": upload_ms,
                    "upload_share": upload_ms / cd_ms, "read_share": read_ms / cd_ms,
                    "compute_ms": host_ms(lambda: da.compute(*stats), 3)}

        # -- (c) culling: a slice loads the one chunk file it touches
        _from_map.LOADS = 0
        v = float(da.from_zarr(url)[:c, :c].sum().compute())
        culled_loads = _from_map.LOADS
        check(culled_loads == 1, f"from_zarr(...)[:{c}, :{c}].sum(): {culled_loads} loads")
        want = float(xd[:c, :c].double().sum())
        atol = 4 * c * float(xd[:c, :c].abs().max()) * 2.0**-23
        check(abs(v - want) <= atol, f"culled sum {v} against {want}")
        out["c"] = {"loads": culled_loads, "sum_abs_err": abs(v - want), "atol": atol}
        del xd, ref, z, stats, got

        # -- (d) npy stacks: rechunk_relayout to a stack and back
        nl, cl = sizes["relayout"], sizes["relayout_chunk"]
        x8 = np.random.default_rng(30).random((nl, nl), dtype=np.float32)
        y = P.rechunk_relayout(x8, chunk=cl)
        tk.LAUNCHES = 0
        t0 = time.perf_counter()
        da.to_npy_stack(f"{tmp}/stack", y)
        stack_s = time.perf_counter() - t0
        launches["transpose"] = tk.LAUNCHES
        check(tk.LAUNCHES == 1, f"to_npy_stack of rechunk_relayout: transpose launches {tk.LAUNCHES}")
        back = da.from_npy_stack(f"{tmp}/stack", mmap_mode="r")
        t0 = time.perf_counter()
        got = back.compute()
        read_s = time.perf_counter() - t0
        check(got.tobytes() == np.ascontiguousarray(x8.T).tobytes(), "from_npy_stack: bytes differ from x.T")
        out["d"] = {"shape": [nl, nl], "files": len(back.chunks[0]), "to_npy_stack_s": stack_s,
                    "from_npy_stack_compute_s": read_s, "transpose_launches": launches["transpose"],
                    "equal_bytes": True}
        del x8, y, got, back

        # -- (e) the rest of the IO surface, each against numpy byte for byte
        m, cm = sizes["surface"], sizes["surface_chunk"]
        xe = np.random.default_rng(31).random((m, m), dtype=np.float32)
        src = da.from_array(xe, chunks=cm)
        surface = {}
        target = np.lib.format.open_memmap(f"{tmp}/target.npy", mode="w+", dtype=np.float32, shape=(2 * m, m))
        handle = da.store([src, src * 2], [target, target], regions=[(slice(0, m), slice(None)),
                                                                      (slice(m, 2 * m), slice(None))], compute=False)
        check(not target.any(), "store(compute=False) wrote before compute()")
        t0 = time.perf_counter()
        handle.compute()
        surface["store_regions_compute_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        target.flush()  # the memmap's pages to the file: the disk's time, not the port's
        surface["memmap_flush_s"] = time.perf_counter() - t0
        check(target[:m].tobytes() == xe.tobytes() and target[m:].tobytes() == (xe * 2).tobytes(),
              "store with regions: bytes differ")
        second = np.lib.format.open_memmap(f"{tmp}/second.npy", mode="w+", dtype=np.float32, shape=(m, m))
        stored = da.store(src + 1, second, return_stored=True)
        check(stored.compute().tobytes() == (xe + 1).tobytes() == np.asarray(second).tobytes(),
              "store(return_stored=True): bytes differ")
        paths = []
        for i in range(m // cm):
            paths.append(f"{tmp}/part{i}.npy")
            np.save(paths[-1], xe[i * cm:(i + 1) * cm])
        fm = da.from_map(np.load, paths, chunks=((cm,) * (m // cm), (m,)), shape=(m, m), dtype=np.float32)
        _from_map.LOADS = 0
        t0 = time.perf_counter()
        check(fm.compute().tobytes() == xe.tobytes(), "from_map of np.load: bytes differ")
        surface["from_map_np_load_s"] = time.perf_counter() - t0
        surface["from_map_loads"] = _from_map.LOADS
        check(_from_map.LOADS == m // cm, f"from_map: {_from_map.LOADS} loads")
        fd = da.concatenate([da.from_delayed(delayed(np.load)(p), shape=(cm, m), dtype=np.float32) for p in paths])
        check(fd.compute().tobytes() == xe.tobytes(), "from_delayed: bytes differ")
        fb = da.from_blocks({(i, 0): xe[i * cm:(i + 1) * cm] for i in range(m // cm)}, chunks=((cm,) * (m // cm), (m,)))
        check(fb.compute().tobytes() == xe.tobytes(), "from_blocks: bytes differ")
        bar = da.barrier(src * 2)[cm:3 * cm]
        check(bar.compute().tobytes() == (xe[cm:3 * cm] * 2).tobytes(), "barrier: bytes differ")
        surface["equal_bytes"] = ["store regions compute=False", "store return_stored", "from_map np.load",
                                  "from_delayed", "from_blocks", "barrier"]
        out["e"] = surface
        del target, second

        # -- (f) the xarray chunk manager at (surface,)^2, numpy callables in the host lane
        mgr = make_manager_class()()
        d = mgr.from_array(xe, (cm, cm))
        nb = (m // cm) ** 2
        lanes = {}

        def hosted(name, lazy, want, expect_calls, exact=True):
            _host.HOST_CALLS = 0
            t0 = time.perf_counter()
            got = np.asarray(mgr.compute(lazy)[0])
            ms = (time.perf_counter() - t0) * 1e3
            if exact:
                check(got.tobytes() == np.asarray(want).tobytes(), f"manager {name}: bytes differ from numpy")
                err = 0.0
            else:
                err = float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())
                check(err <= 1e-5, f"manager {name}: relative error {err}")
            check(_host.HOST_CALLS == expect_calls, f"manager {name}: {_host.HOST_CALLS} host calls, "
                  f"expected {expect_calls}")
            lanes[name] = {"host_calls": _host.HOST_CALLS, "compute_ms": ms, "max_rel_err": err}

        r = mgr.rechunk(d, (2 * cm, m))
        hosted("rechunk", r, xe, 0)
        rows = [np.nansum(np.concatenate([np.nansum(xe[i:i + cm, j:j + cm], axis=(1,), keepdims=True, dtype=np.float32)
                                          for j in range(0, m, cm)], axis=1), axis=(1,), dtype=np.float32)
                for i in range(0, m, cm)]
        hosted("reduction_nansum", mgr.reduction(d, np.nansum, aggregate_func=np.nansum, axis=(1,), dtype="f4"),
               np.concatenate(rows), nb + m // cm)
        hosted("scan_cumsum", mgr.scan(np.cumsum, np.add, 0, d, axis=1, dtype="f4"),
               np.cumsum(xe.astype(np.float64), axis=1), 0, exact=False)

        def root_abs(b):
            return np.sqrt(np.abs(b) + np.float32(1))

        hosted("map_blocks_numpy", mgr.map_blocks(root_abs, d, dtype="f4"), root_abs(xe), nb)
        hosted("apply_gufunc_numpy", mgr.apply_gufunc(lambda a: np.mean(a, axis=-1), "(i)->()", r,
                                                      output_dtypes=["f4"]),
               np.concatenate([np.mean(xe[i:i + 2 * cm], axis=-1) for i in range(0, m, 2 * cm)]), m // (2 * cm))
        hosted("map_blocks_torch", mgr.map_blocks(torch.sqrt, d, dtype="f4"), np.sqrt(xe), 0, exact=False)
        hosted("reduction_torch", mgr.reduction(d, torch.sum, aggregate_func=torch.sum, axis=(1,), dtype="f4"),
               xe.astype(np.float64).sum(1), 0, exact=False)
        target = np.lib.format.open_memmap(f"{tmp}/manager.npy", mode="w+", dtype=np.float32, shape=(m, m))
        mgr.store([d], [target])
        check(np.asarray(target).tobytes() == xe.tobytes(), "manager store: bytes differ")
        lanes["store"] = {"equal_bytes": True}
        out["f"] = lanes
        del target, xe, src

        # -- (g) plankit: optimize() of a plan whose axes hold > 256 chunks
        check(native.available(), "plankit did not build or load")
        nbk = sizes["plan_blocks"]
        rows_a, rows_b = (7,) * nbk, (5, 9) * (nbk // 2)
        total = sum(rows_a)
        rows_b = rows_b[:-1] + (total - sum(rows_b[:-1]),) if sum(rows_b) != total else rows_b

        def plan(seed):
            base = np.full((total, 4), seed, dtype=np.float32)
            a = da.from_array(base, chunks=(rows_a, 4))
            b = da.from_array(base + 1, chunks=(rows_b, 4))
            return ((a + b)[3:total - 5:2] * 2).sum(0)

        def optimize_ms(reps):
            times = []
            for rep in range(reps):
                p = plan(rep + 1)
                t0 = time.perf_counter()
                p.expr.optimize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        def helper_ms(fn, reps=20):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps

        helpers = {"sliced_blockdim": lambda: sliced_blockdim(rows_a, slice(3, total - 5, 2)),
                   "common_blockdim": lambda: common_blockdim([rows_a, rows_b]),
                   "unify_blockdims_coarse": lambda: unify_blockdims([(rows_a, 1.0), (rows_b, 1.0)], policy="coarse")}
        native_ms = {k: helper_ms(f) for k, f in helpers.items()}
        native_opt = optimize_ms(5)
        loader = native._load
        native._load = lambda: None  # the Python paths, as where a call declines
        try:
            python_ms = {k: helper_ms(f) for k, f in helpers.items()}
            python_opt = optimize_ms(5)
        finally:
            native._load = loader
        out["g"] = {"available": True, "library": native.library_path().name, "blocks_per_axis": [len(rows_a),
                    len(rows_b)], "optimize_ms_native": native_opt, "optimize_ms_python": python_opt,
                    "helpers_ms_native": native_ms, "helpers_ms_python": python_ms}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launches


# phase 30: the out-of-core lane on the card.  "square" is case (a)/(b)'s
# side (32768^2 float32, 4 GiB each way), "rows" x "cols" case (c)'s input
# (2^20 x 2048 float32, 8 GiB), "mm_cols" case (d)'s A width (2^20 x 1024,
# 4 GiB); "panel" the chunk height; budgets per case.  Sizes halve when the
# host's MemAvailable is short (each cut printed).
STREAM_SIZES = {"square": 32768, "square_chunk": 4096, "rows": 1 << 20, "cols": 2048, "mm_cols": 1024,
                "panel": 1 << 16, "budget_ab": "3 GiB", "budget_cd": "2 GiB", "budget_e": "1 GiB",
                "budget_f": "512 MiB", "budget_g": "2 GiB", "host_gib_needed": 28}


# how far the "auto" budget may move across phase 30's in-core runs: they
# hold nothing on the card afterwards, so only small allocations that stay
# (kernel tables, library workspaces) may change it
AUTO_BUDGET_DRIFT_GIB = 1.0


def stream_sizes():
    """STREAM_SIZES, halved until the host's MemAvailable covers the phase's
    peak (about 16 GiB at full size); returns (sizes, cuts)."""
    sizes = dict(STREAM_SIZES)
    cuts = []
    try:
        with open("/proc/meminfo") as f:
            avail = next(int(line.split()[1]) * 1024 for line in f if line.startswith("MemAvailable:"))
    except (OSError, StopIteration):
        return sizes, ["MemAvailable unreadable: full sizes"]
    need = sizes["host_gib_needed"] << 30
    while avail < need and sizes["square"] > 4096:
        sizes["square"] //= 2
        sizes["rows"] //= 2
        need //= 2
        cuts.append(f"MemAvailable {avail / 2**30:.1f} GiB: square {sizes['square']}, rows {sizes['rows']}")
    return sizes, cuts


def streaming_paths(da, torch, sizes):
    """The out-of-core lane on the card (phase 30).  Each case streams under
    an explicit "memory-budget" (config "out-of-core": "auto") and is held
    against the in-core compute() of the same program ("out-of-core":
    "off") in this process: (a) stencil2d's roll form on a host 32768^2
    float32 (K1 once a panel), (b) tanh(laplace) through map_overlap
    (Overlap -> halo kernel -> map_blocks -> trim, the halo kernel once a
    panel), (c) sum(axis=0), mean() and nanmax() of 2^20 x 2048 float32
    (reduce-stream), (d) A @ W of 2^20 x 1024 by a numpy 1024^2 (W pinned
    once).  Then the "auto" budget (checked to stay within
    AUTO_BUDGET_DRIFT_GIB across the in-core runs), that "auto" stays off
    for a 1 GiB program, and that an xla_profile trace of case (a) names
    K1's kernel.  Returns (numbers, launches)."""
    import gc
    import glob
    import os
    import tempfile

    import numpy as np

    from dask_array_tpu_torch import _hostcopy, _streaming, config
    from dask_array_tpu_torch.kernels import halo, stencil
    from dask_array_tpu_torch.models.pipelines import laplace_roll

    st = _streaming.STREAMED
    n, c = sizes["square"], sizes["square_chunk"]
    rng = np.random.default_rng(30)
    def auto_budget_gib():
        # the "auto" budget after a collection: the readings compare what
        # the caching allocator holds, not when Python's cyclic collector
        # last ran (tests/test_torch_no_cycles.py holds the port to leaving
        # no tensor in a cycle)
        gc.collect()
        with config.set({"memory-budget": "auto"}):
            return _streaming._budget() / 2**30

    # the auto budget before any in-core run: the runs leave their blocks
    # in the caching allocator, which the budget must count as free
    out = {"auto_budget_GiB_first": auto_budget_gib()}
    launches = {"band_stencil": 0, "halo": 0}

    def fill(rows, cols):
        # cheap: one broadcast pass (rows differ, columns random)
        x = np.empty((rows, cols), np.float32)
        np.add(np.arange(rows, dtype=np.float32)[:, None] * np.float32(1e-6),
               rng.random(cols, dtype=np.float32)[None, :], out=x)
        return x

    def run(arr, budget):
        """(streamed, in-core, numbers) of ``arr`` (a dask array)."""
        with config.set({"out-of-core": "off"}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            in_core = arr.compute()
            in_core_ms = (time.perf_counter() - t0) * 1e3
        before = dict(st)
        cbefore = dict(_hostcopy.COPIES)
        halo.LAUNCHES = stencil.LAUNCHES = 0
        with config.set({"out-of-core": "auto", "memory-budget": budget}):
            t0 = time.perf_counter()
            streamed = arr.compute()
            ms = (time.perf_counter() - t0) * 1e3
        d = {k: st[k] - before[k] for k in st}
        up, down = d["h2d_bytes"], d["d2h_bytes"]
        num = {"budget": budget, "panels": d["panels"], "pinned": d["pinned"], "count": d["count"],
               "band_stencil_launches": stencil.LAUNCHES, "halo_launches": halo.LAUNCHES,
               "h2d_GB": up / 1e9, "d2h_GB": down / 1e9,
               "ring_h2d_GB": (_hostcopy.COPIES["h2d_bytes"] - cbefore["h2d_bytes"]) / 1e9,
               "ring_d2h_GB": (_hostcopy.COPIES["d2h_bytes"] - cbefore["d2h_bytes"]) / 1e9,
               "streamed_ms": ms, "in_core_ms": in_core_ms, "GBps": (up + down) / ms / 1e6}
        launches["band_stencil"] += stencil.LAUNCHES
        launches["halo"] += halo.LAUNCHES
        check(d["count"] == 1 and d["panels"] >= 2, f"phase 30: streamed {d}")
        return streamed, in_core, num

    def same_bits(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint32), b.view(np.uint32))

    # (a) stencil2d's roll form: K1 once per panel, equal bytes
    x = fill(n, n)
    xa = da.from_array(x, chunks=c)
    sa = da.map_overlap(laplace_roll, xa, depth=1, boundary="reflect", dtype="float32")
    streamed, in_core, num = run(sa, sizes["budget_ab"])
    check(num["band_stencil_launches"] == num["panels"], f"phase 30 (a): K1 launches {num}")
    check(same_bits(streamed, in_core), "phase 30 (a): streamed stencil differs from in-core")
    num["equal_bytes"] = True
    out["a"] = num
    del streamed, in_core

    # (b) tanh(laplace): the Overlap route, the halo kernel once per panel
    sb = da.map_overlap(lambda b: torch.tanh(laplace_roll(b)), xa, depth=1, boundary="reflect", dtype="float32")
    streamed, in_core, num = run(sb, sizes["budget_ab"])
    check(num["halo_launches"] == num["panels"] and num["band_stencil_launches"] == 0,
          f"phase 30 (b): launches {num}")
    check(same_bits(streamed, in_core), "phase 30 (b): streamed tanh(laplace) differs from in-core")
    num["equal_bytes"] = True
    out["b"] = num
    del streamed, in_core

    # the auto budget, and auto off for a 1 GiB program
    out["auto_budget_GiB"] = auto_budget_gib()
    with config.set({"memory-budget": "auto"}):
        check(abs(out["auto_budget_GiB"] - out["auto_budget_GiB_first"]) <= AUTO_BUDGET_DRIFT_GIB,
              f"phase 30: the auto budget moved from {out['auto_budget_GiB_first']} to {out['auto_budget_GiB']} GiB "
              "across the in-core runs")
        small = da.from_array(x[: (1 << 28) // n], chunks=c)  # 1 GiB of rows
        before = st["count"]
        with config.set({"out-of-core": "auto"}):
            (small + 1).compute()
        out["auto_off_for_GiB"] = small.nbytes / 2**30
        out["auto_stays_off"] = st["count"] == before
    check(out["auto_stays_off"], "phase 30: auto streamed a 1 GiB program")

    # xla_profile of case (a): does the trace name K1's kernel?
    logdir = tempfile.mkdtemp(prefix="phase30-profile-", dir=os.path.join(os.path.dirname(__file__), "build"))
    try:
        with config.set({"out-of-core": "auto", "memory-budget": sizes["budget_ab"]}):
            with da.xla_profile(logdir):
                sa.compute()
        text = "".join(open(p).read() for p in glob.glob(os.path.join(logdir, "*.json")))
        out["profile_names_k1"] = "band_stencil_" in text
        out["profile_trace_MB"] = len(text) / 1e6
    finally:
        import shutil

        shutil.rmtree(logdir, ignore_errors=True)
    check(out["profile_names_k1"], "phase 30: the xla_profile trace of case (a) does not name K1's kernel")
    del x, xa, sa, sb, small

    # (c) reduce-stream of sum(axis=0), mean() and nanmax()
    rows, cols, panel = sizes["rows"], sizes["cols"], sizes["panel"]
    y = fill(rows, cols)
    ya = da.from_array(y, chunks=(panel, cols))
    # float64 references by plain torch on the card (numpy's float64 passes
    # over 8 GiB take seconds each)
    y64 = torch.from_numpy(y).to(config.get("device", "cuda")).double()
    ref = {"sum0": y64.sum(0).cpu().numpy(), "mean": float(y64.mean()), "nanmax": float(y64.max())}
    del y64
    torch.cuda.empty_cache()
    out["c"] = {}
    for name, arr in (("sum0", ya.sum(axis=0)), ("mean", ya.mean()), ("nanmax", da.nanmax(ya))):
        streamed, in_core, num = run(arr, sizes["budget_cd"])
        streamed, in_core = np.asarray(streamed), np.asarray(in_core)
        err = float(np.max(np.abs(streamed.astype(np.float64) - ref[name]) / np.maximum(np.abs(ref[name]), 1e-30)))
        check(err <= 1e-4, f"phase 30 (c) {name}: rel err {err} against float64")
        if name == "nanmax":
            check(streamed == in_core, "phase 30 (c) nanmax: streamed differs from in-core")
        else:
            np.testing.assert_allclose(streamed, in_core, rtol=1e-4)
        num.update(rel_err_vs_f64=err, tolerance="rtol 1e-4 vs plain torch in float64 and vs in-core (nanmax equal)")
        out["c"][name] = num
    del y, ya

    # (d) A @ W, row panels of A, W pinned once
    a = fill(rows, sizes["mm_cols"])
    w = rng.standard_normal((sizes["mm_cols"], sizes["mm_cols"])).astype(np.float32) / np.float32(32)
    prod = da.from_array(a, chunks=(panel, sizes["mm_cols"])) @ w
    streamed, in_core, num = run(prod, sizes["budget_cd"])
    check(num["pinned"] == 1, f"phase 30 (d): pinned {num}")
    np.testing.assert_allclose(streamed, in_core, rtol=1e-5, atol=1e-5)
    rows_checked = np.r_[0:256, rows - 256:rows]
    ref_rows = a[rows_checked].astype(np.float64) @ w.astype(np.float64)
    err = float(np.max(np.abs(streamed[rows_checked] - ref_rows)))
    check(err <= 1e-3, f"phase 30 (d): abs err {err} against float64 numpy")
    num.update(max_abs_err_vs_f64_rows=err, equal_bytes_to_in_core=bool(same_bits(streamed, in_core)),
               tolerance="rtol 1e-5, atol 1e-5 vs in-core; atol 1e-3 vs float64 numpy on 512 rows")
    out["d"] = num
    del a, w, prod, streamed, in_core
    out.update(streaming_dtype_paths(da, torch, sizes, run, fill))
    out["ring_pinned_MiB"] = _hostcopy.ring_bytes() / 2**20
    out["auto_budget_GiB_last"] = auto_budget_gib()
    check(abs(out["auto_budget_GiB_last"] - out["auto_budget_GiB_first"]) <= AUTO_BUDGET_DRIFT_GIB,
          f"phase 30: the auto budget moved from {out['auto_budget_GiB_first']} to {out['auto_budget_GiB_last']} GiB "
          "across the in-core runs")
    return out, launches


def steps_apart(got, want, dtype):
    """How many representable values of the 1-byte float ``dtype`` lie
    between ``got`` and ``want`` (numpy arrays of it), at most: the
    distance of their ranks among the type's finite values."""
    import numpy as np

    vals = np.unique(np.arange(256, dtype=np.uint8).view(dtype).astype(np.float64))
    vals = vals[np.isfinite(vals)]
    g, w = got.astype(np.float64).ravel(), want.astype(np.float64).ravel()
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    if same.all():
        return 0
    return int(np.abs(np.searchsorted(vals, g[~same]) - np.searchsorted(vals, w[~same])).max())


def streaming_dtype_paths(da, torch, sizes, run, fill):
    """Phase 30's cases of datetime, bfloat16 and float8 data, each
    streamed and held against its in-core compute() by ``run``: (e) a
    bfloat16 host array of square^2 (2 GiB at full size) under 1 GiB,
    stencil2d's roll form (K1's 2-byte build once a panel, equal bytes);
    (f) float8_e4m3fn of rows x cols (2 GiB) summed along axis 0 under 512
    MiB (float32 partials, one rounding: equal to in-core, or at most one
    step of the type apart, counted; and against the float64 sum rounded
    once); (g) datetime64[ns] of rows x cols / 4 (4 GiB, 64 NaT) min and
    max along axis 0 under 2 GiB (equal to in-core and to numpy)."""
    import ml_dtypes
    import numpy as np

    from dask_array_tpu_torch._chunks import array_of
    from dask_array_tpu_torch.models.pipelines import laplace_roll

    out = {}
    n, c = sizes["square"], sizes["square_chunk"]
    xb = array_of(torch.from_numpy(fill(n, n)).to(torch.bfloat16))
    sb = da.map_overlap(laplace_roll, da.from_array(xb, chunks=c), depth=1, boundary="reflect", dtype=xb.dtype)
    streamed, in_core, num = run(sb, sizes["budget_e"])
    check(num["band_stencil_launches"] == num["panels"], f"phase 30 (e): K1 launches {num}")
    check(streamed.dtype == in_core.dtype == np.dtype(ml_dtypes.bfloat16)
          and np.array_equal(streamed.view(np.uint16), in_core.view(np.uint16)),
          "phase 30 (e): streamed bfloat16 stencil differs from in-core")
    num.update(equal_bytes=True, dtype="bfloat16", shape=[n, n])
    out["e"] = num
    del xb, sb, streamed, in_core

    rows, cols, panel = sizes["rows"], sizes["cols"], sizes["panel"]
    g = torch.Generator(device="cuda").manual_seed(301)
    f8 = (torch.randn((rows, cols), generator=g, device="cuda") * 0.01).to(torch.float8_e4m3fn)
    exact = f8.float().sum(0, dtype=torch.float64).float().to(torch.float8_e4m3fn).cpu()
    host = array_of(f8.cpu())
    del f8
    torch.cuda.empty_cache()
    streamed, in_core, num = run(da.from_array(host, chunks=(panel, cols)).sum(axis=0), sizes["budget_f"])
    dt8 = np.dtype(ml_dtypes.float8_e4m3fn)
    check(streamed.dtype == in_core.dtype == dt8, f"phase 30 (f): dtypes {streamed.dtype} {in_core.dtype}")
    num.update(dtype="float8_e4m3fn", shape=[rows, cols],
               unequal_to_in_core=int((streamed.view(np.uint8) != in_core.view(np.uint8)).sum()),
               steps_from_in_core=steps_apart(streamed, in_core, dt8),
               steps_from_float64=steps_apart(streamed, array_of(exact), dt8),
               tolerance="equal to in-core or one step of float8_e4m3fn (float32 partials summed in another "
                         "order); at most one step from the float64 sum rounded once")
    check(num["steps_from_in_core"] <= 1 and num["steps_from_float64"] <= 1, f"phase 30 (f): {num}")
    out["f"] = num
    del host, streamed, in_core

    dcols = cols // 4
    ticks = torch.randint(0, 10**15, (rows, dcols), generator=g, device="cuda") + 1_577_836_800 * 10**9
    ticks[torch.randint(0, rows, (64,), generator=g, device="cuda"), torch.arange(64, device="cuda") * 7] = -(2**63)
    host = ticks.cpu().numpy().view("M8[ns]")
    del ticks
    torch.cuda.empty_cache()
    for name in ("min", "max"):
        arr = getattr(da.from_array(host, chunks=(panel, dcols)), name)(axis=0)
        streamed, in_core, num = run(arr, sizes["budget_g"])
        want = getattr(np, name)(host, axis=0)
        check(streamed.dtype == want.dtype and np.array_equal(streamed, in_core, equal_nan=True)
              and np.array_equal(streamed, want, equal_nan=True), f"phase 30 (g) {name}: differs")
        num.update(dtype="datetime64[ns]", shape=[rows, dcols], nat=64, equal_to_in_core_and_numpy=True)
        out[f"g_{name}"] = num
    del host
    return out


def k2_cases(torch, hk, flat, seed=27):
    """K2's timing cases on ``flat`` values made on the card from ``seed``:
    float32 normals into 256 uniform bins of (-4, 4) (float64 edges), the
    same with float64 weights, into 65536 bins, and into 65536 bins with
    every value in one bin; a 65536-bin bincount of int64 values, and the
    same with float64 weights.  Each: (name, kernel, plain version,
    (library call's name, call), the bytes the function must move (each
    input read once, the counts written once), rtol against numpy (0:
    equal), numpy's result from the host copies ``(x, w, ints)``).
    ``scripts/time_histogram.py`` times the same cases."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(flat, generator=g, device="cuda")
    w = torch.rand(flat, generator=g, device="cuda", dtype=torch.float64)
    ints = torch.randint(0, 65536, (flat,), generator=g, device="cuda")
    skew = torch.full((flat,), 0.3, device="cuda")
    e256, e65536 = (torch.from_numpy(np.histogram_bin_edges(np.empty(0, np.float32), nb, (-4, 4))).cuda()
                    for nb in (256, 65536))

    def hist(nb):
        return lambda h: np.histogram(h[0], bins=nb, range=(-4, 4))[0]

    return (x, w, ints), [
        ("histogram_256", lambda: hk.histogram_counts_cuda(x, e256), lambda: hk.histogram_counts_plain(x, e256),
         ("torch.histc", lambda: torch.histc(x, 256, -4, 4)), flat * 4 + 256 * 8, 0.0, hist(256)),
        ("histogram_256_weighted", lambda: hk.histogram_counts_cuda(x, e256, w),
         lambda: hk.histogram_counts_plain(x, e256, w),
         ("torch.bucketize + torch.bincount(weights)", lambda: torch.bincount(torch.bucketize(x, e256), w, minlength=258)),
         flat * 12 + 256 * 8, 1e-12, lambda h: np.histogram(h[0], bins=256, range=(-4, 4), weights=h[1])[0]),
        ("histogram_65536", lambda: hk.histogram_counts_cuda(x, e65536), lambda: hk.histogram_counts_plain(x, e65536),
         ("torch.histc", lambda: torch.histc(x, 65536, -4, 4)), flat * 4 + 65536 * 8, 0.0, hist(65536)),
        ("histogram_65536_one_bin", lambda: hk.histogram_counts_cuda(skew, e65536),
         lambda: hk.histogram_counts_plain(skew, e65536), ("torch.histc", lambda: torch.histc(skew, 65536, -4, 4)),
         flat * 4 + 65536 * 8, 0.0,
         lambda h: np.histogram(np.full(1, 0.3, np.float32), bins=65536, range=(-4, 4))[0] * flat),
        ("bincount_65536", lambda: hk.bincount_cuda(ints, 65536), lambda: hk.bincount_plain(ints, 65536),
         ("torch.bincount", lambda: torch.bincount(ints, minlength=65536)), flat * 8 + 65536 * 8, 0.0,
         lambda h: np.bincount(h[2], minlength=65536)),
        ("bincount_65536_weighted", lambda: hk.bincount_cuda(ints, 65536, w), lambda: hk.bincount_plain(ints, 65536, w),
         ("torch.bincount(weights)", lambda: torch.bincount(ints, w, minlength=65536)), flat * 16 + 65536 * 8, 1e-12,
         lambda h: np.bincount(h[2], weights=h[1], minlength=65536)),
    ]


def k2_two_byte_cases(torch, hk, flat, seed=31):
    """K2's 2-byte timing cases on ``flat`` values made on the card from
    ``seed``: bfloat16 and float16 normals into 256 and 65536 uniform bins
    of (-4, 4) (float64 edges), and bfloat16 with every value in one of
    65536 bins, in the tuples of ``k2_cases`` (no numpy result); the
    library call is ``torch.histc`` of the float32 cast (it refuses
    bfloat16).  ``scripts/time_histogram.py`` times them."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(seed)
    normal = torch.randn(flat, generator=g, device="cuda")
    out = []
    for tag, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        x = normal.to(dt)
        for nb in (256, 65536):
            e = torch.from_numpy(np.histogram_bin_edges(np.empty(0, np.float32), nb, (-4, 4))).cuda()
            out.append((f"histogram_{tag}_{nb}", functools.partial(hk.histogram_counts_cuda, x, e),
                        functools.partial(hk.histogram_counts_plain, x, e),
                        ("torch.histc of the float32 cast", functools.partial(lambda v, b: torch.histc(v.float(), b, -4, 4), x, nb)),
                        flat * 2 + nb * 8, 0.0, None))
    one = torch.full((flat,), 0.3, device="cuda", dtype=torch.bfloat16)
    e = torch.from_numpy(np.histogram_bin_edges(np.empty(0, np.float32), 65536, (-4, 4))).cuda()
    out.append(("histogram_bf16_65536_one_bin", functools.partial(hk.histogram_counts_cuda, one, e),
                functools.partial(hk.histogram_counts_plain, one, e),
                ("torch.histc of the float32 cast", lambda: torch.histc(one.float(), 65536, -4, 4)),
                flat * 2 + 65536 * 8, 0.0, None))
    return out


def k2_timing(torch, flat, timer, device_timer, seed=27):
    """K2, the histogram kernel (``kernels/histogram.py``), on the cases of
    ``k2_cases``.  Each case: the kernel against numpy (equal counts;
    weighted sums to rtol 1e-12) and its plain version (searchsorted +
    bincount), per call in the order plain, kernel, kernel, plain, and on
    the device alone, beside the nearest PyTorch call, with the bound (each
    input read once, the counts written once, at 3.35 TB/s; four float32
    operations a value) and the kernel's share of it.  Weighted sums in
    one block's shared memory (256 bins) must repeat their bits on three
    runs."""
    import numpy as np

    from dask_array_tpu_torch.kernels import histogram as hk

    inputs, cases = k2_cases(torch, hk, flat, seed)
    host = [t.cpu().numpy() for t in inputs]
    out = {}
    for name, kernel, plain, lib, nbytes, rtol, numpy_of in cases:
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        g64, r64 = got.cpu().numpy().astype(np.float64), ref.cpu().numpy().astype(np.float64)
        want = numpy_of(host).astype(np.float64)
        if rtol:
            check(np.allclose(g64, want, rtol=rtol, atol=0), f"K2 {name}: differs from numpy")
        else:
            check(np.array_equal(g64, want), f"K2 {name}: differs from numpy")
        k_ms, p_ms, k_runs, p_runs = paired_ms(plain, kernel, reps=20)
        b_ms, b_by = bound(nbytes, 4 * flat)
        dev = device_timer(kernel)
        out[name] = {"vs_numpy": "equal" if not rtol else f"rtol {rtol}",
                     "max_abs_err_vs_plain": float(np.abs(g64 - r64).max()),
                     "kernel_ms": k_ms, "kernel_device_ms": dev, "kernel_runs_ms": k_runs,
                     "plain_ms": p_ms, "plain_runs_ms": p_runs, "library": lib[0],
                     "library_ms": timer(lib[1]), "library_device_ms": device_timer(lib[1]),
                     "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by, "of_bound": b_ms / dev}
    weighted = next(c for c in cases if c[0] == "histogram_256_weighted")[1]
    runs = [weighted() for _ in range(3)]
    check(all(torch.equal(r, runs[0]) for r in runs), "K2: weighted sums in one block's shared memory changed their bits")
    out["weighted_repeats_bits"] = True
    del inputs, cases, host, runs
    torch.cuda.empty_cache()
    return out


STATS_TOLERANCE = ("colsum/rowmean rtol 1e-5, atol 4*sqrt(terms)*max|x|*2^-23 (rowmean /N); "
                   "std rtol 1e-4")


# phase 31 (S9): sizes of its cases
S9_SIZES = {"k1": (4096, 16384), "k2_flat": 1 << 26, "k2_bins": (256, 65536), "matmul": 8192, "matmul_chunk": 1024,
            "stencil": 4096, "stencil_chunk": 1024, "datetime": 1 << 24, "datetime_chunk": 1 << 22,
            "masked": 4096, "masked_chunk": 1024, "records": 1 << 20, "records_chunk": 1 << 18}


def close16(got, want, scale):
    """Whether two 2-byte stencil results agree: at most 1 step of the type
    (2^-7 of the value in bfloat16, 2^-10 in float16), plus 4 float32
    steps of ``scale`` (sum |w| * max |x|).  The kernel and the plain
    version each add the taps in float32 and round once, in other orders:
    a sum next to a tie of the type rounds to either side (1 step), and
    where the taps cancel their float32 sums differ by a few steps of the
    largest term."""
    import torch

    step = 2.0**-7 if want.dtype == torch.bfloat16 else 2.0**-10
    return bool(((got.float() - want.float()).abs() <= step * want.float().abs() + 2.0**-21 * scale).all())


class _Wrapped:
    """A minimal NEP-13/NEP-18 duck array over a numpy buffer (the shape of
    dask's ``EncapsulateNDArray``), for phase 31's registered chunk type."""

    __array_priority__ = 20.0

    def __init__(self, arr):
        import numpy as np

        self.arr = np.asarray(arr)

    shape = property(lambda self: self.arr.shape)
    dtype = property(lambda self: self.arr.dtype)
    ndim = property(lambda self: self.arr.ndim)

    def __getitem__(self, idx):
        return _rewrap(self.arr[idx])

    def astype(self, dtype, **kwargs):
        return _Wrapped(self.arr.astype(dtype, **kwargs))

    def reshape(self, *shape):
        return _Wrapped(self.arr.reshape(*shape))

    def __array__(self, dtype=None, copy=None):
        return self.arr if dtype is None else self.arr.astype(dtype)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if kwargs.get("out") is not None:
            return NotImplemented
        return _rewrap(getattr(ufunc, method)(*(_unwrap(i) for i in inputs), **kwargs))

    def __array_function__(self, func, types, args, kwargs):
        return _rewrap(func(*_unwrap(args), **_unwrap(kwargs)))


def _unwrap(x):
    if isinstance(x, _Wrapped):
        return x.arr
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


def _rewrap(x):
    import numpy as np

    if isinstance(x, (list, tuple)):
        return type(x)(_rewrap(v) for v in x)
    return _Wrapped(x) if isinstance(x, np.ndarray) and x.ndim > 0 else x


def s9_paths(da, torch, sizes, smi):
    """Phase 31 (S9): (a) K1 and K2 in bfloat16 on tensors against their
    plain versions and library calls; (b) bfloat16 through the public API
    (only where ml_dtypes imports: numpy knows bfloat16 through it);
    (c) datetime64[ns] with NaTs on the card; (d) the host lanes (masked,
    records, a registered duck type), each equal to numpy.  Returns
    ({case: numbers}, the K1/K2 bf16 entries of the kernels line)."""
    import numpy as np

    from dask_array_tpu_torch import _hostcopy
    from dask_array_tpu_torch._dispatch import _HANDLED_CHUNK_TYPES, _refresh_duck_types, register_chunk_type
    from dask_array_tpu_torch.kernels import histogram as hk
    from dask_array_tpu_torch.kernels import stencil
    from dask_array_tpu_torch.models.pipelines import blocked_matmul, laplace_roll, stencil2d

    out, entries = {}, {}
    bnd = ("reflect", "reflect")
    taps = stencil.capture_taps(laplace_roll, (1, 1))
    g = torch.Generator(device="cuda").manual_seed(31)
    two_byte = {"bf16": torch.bfloat16, "f16": torch.float16}
    # (a) K1 in bfloat16 and float16: the plain version computes the taps in
    # float32 and rounds once, as the kernel does (float16's own plain
    # version rounds each step, so its reference is the float32 one rounded;
    # tolerance: ``close16``)
    wsum = sum(abs(w) for _, _, w in taps)
    for tag, dt in two_byte.items():
        lap_w = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], device="cuda", dtype=dt)[None, None]
        for n in sizes["k1"]:
            x = torch.randn((n, n), generator=g, device="cuda").to(dt)
            got = stencil.band_stencil_cuda(x, taps, (1, 1), bnd)
            ref = stencil.band_stencil_plain(x.float(), laplace_roll, (1, 1), bnd).to(dt)
            scale = wsum * float(x.float().abs().max())
            check(close16(got, ref, scale), f"phase 31 K1 {tag} {n}: differs from its plain version")
            k_ms, p_ms, k_runs, p_runs = paired_ms(lambda: stencil.band_stencil_plain(x, laplace_roll, (1, 1), bnd),
                                                   lambda: stencil.band_stencil_cuda(x, taps, (1, 1), bnd))
            padded = stencil.pad_axis(stencil.pad_axis(x, 0, 1, 1, "reflect"), 1, 1, 1, "reflect")[None, None]
            conv_ms = cuda_ms(lambda: torch.nn.functional.conv2d(padded, lap_w))
            dev = device_ms(lambda: stencil.band_stencil_cuda(x, taps, (1, 1), bnd))
            b_ms, b_by = bound(2 * n * n * 2, 2 * len(taps) * n * n)
            step = "2^-7" if tag == "bf16" else "2^-10"
            out[f"k1-{tag}-{n}"] = {"max_abs_err": float((got.float() - ref.float()).abs().max()),
                                    "tolerance": f"{step} |plain| + 2^-21 * {scale} (sum|w| max|x|)",
                                    "kernel_ms": k_ms, "kernel_runs_ms": k_runs,
                                    "plain_ms": p_ms, "plain_runs_ms": p_runs, "kernel_device_ms": dev,
                                    f"conv2d_{tag}_ms": conv_ms, "bound_ms": b_ms, "bound_by": b_by,
                                    "kernel_of_bound": b_ms / k_ms}
            del x, got, ref, padded
    # (a) K2 with bfloat16 and float16 data (the pattern route): every
    # 2-byte value is exact in float32, so the counts equal the plain
    # version's
    flat = sizes["k2_flat"]
    for tag, dt in two_byte.items():
        x = torch.randn(flat, generator=g, device="cuda").to(dt)
        for nb in sizes["k2_bins"]:
            e = torch.from_numpy(np.histogram_bin_edges(np.empty(0, np.float32), nb, (-4, 4))).cuda()
            got, ref = hk.histogram_counts_cuda(x, e), hk.histogram_counts_plain(x, e)
            check(torch.equal(got, ref), f"phase 31 K2 {tag} {nb}: counts differ from the plain version")
            try:
                torch.histc(x, nb, -4, 4)
                lib_name, lib = "torch.histc", (lambda: torch.histc(x, nb, -4, 4))
            except RuntimeError:
                lib_name, lib = "torch.histc of the float32 cast", (lambda: torch.histc(x.float(), nb, -4, 4))
            k_ms, p_ms, k_runs, p_runs = paired_ms(lambda: hk.histogram_counts_plain(x, e),
                                                   lambda: hk.histogram_counts_cuda(x, e), reps=30)
            dev = device_ms(lambda: hk.histogram_counts_cuda(x, e))
            b_ms, b_by = bound(flat * 2 + nb * 8, 4 * flat)
            out[f"k2-{tag}-{nb}"] = {"max_abs_err": float((got - ref).abs().max()), "kernel_ms": k_ms,
                                     "kernel_runs_ms": k_runs, "plain_ms": p_ms, "plain_runs_ms": p_runs,
                                     "kernel_device_ms": dev, "library": lib_name, "library_ms": cuda_ms(lib),
                                     "bound_ms": b_ms, "bound_by": b_by, "of_bound": b_ms / dev}
        del x
    torch.cuda.empty_cache()
    # (b) bfloat16 through the public API
    try:
        import ml_dtypes
    except ImportError as exc:
        out["public-bf16"] = {"ran": False, "why": f"ml_dtypes does not import here ({exc}): numpy has no bfloat16"}
        ml_dtypes = None
    launches = {"band_stencil": 0, "histogram": 0}
    if ml_dtypes is not None:
        bf16 = ml_dtypes.bfloat16
        rng = np.random.default_rng(31)
        n, c = sizes["matmul"], sizes["matmul_chunk"]
        a_np = rng.standard_normal((n, n), dtype=np.float32).astype(bf16)
        b_np = rng.standard_normal((n, n), dtype=np.float32).astype(bf16)
        mm = blocked_matmul(a_np, b_np, chunk=c)
        check(np.dtype(mm.dtype) == np.dtype(bf16), f"phase 31: blocked_matmul bf16 gives {mm.dtype}")
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # float32 accumulation
        got = mm.compute_device()
        check(got.dtype == torch.bfloat16 and tuple(got.shape) == (n, n), "phase 31: blocked_matmul bf16 shape/dtype")
        ad, bd = torch.from_numpy(a_np.view(np.uint16)).cuda().view(torch.bfloat16), \
            torch.from_numpy(b_np.view(np.uint16)).cuda().view(torch.bfloat16)
        want = ad.float() @ bd.float()
        err = float((got.float() - want).abs().max())
        scale = float(want.abs().max())
        check(torch.allclose(got.float(), want, rtol=2.0**-7, atol=2.0**-16 * scale),
              f"phase 31: blocked_matmul bf16 error {err} against float32")
        dev_ms = host_ms(lambda: (mm.compute_device(), torch.cuda.synchronize()), 3)
        mm_ms = cuda_ms(lambda: ad @ bd, reps=10)
        out["blocked_matmul-bf16"] = {"size": n, "chunks": [c, c // 2], "max_abs_err_vs_f32": err,
                                      "tolerance": f"rtol 2^-7, atol 2^-16*max|ab| = {2.0**-16 * scale}",
                                      "compute_device_ms": dev_ms, "TFLOPs": 2 * n**3 / dev_ms / 1e9,
                                      "torch_matmul_ms": mm_ms, "torch_matmul_TFLOPs": 2 * n**3 / mm_ms / 1e9}
        del got, want, ad, bd, mm, a_np, b_np
        torch.cuda.empty_cache()
        n, c = sizes["stencil"], sizes["stencil_chunk"]
        x_np = rng.standard_normal((n, n), dtype=np.float32).astype(bf16)
        st = stencil2d(x_np, chunk=c, form="roll")
        h, _ = da.histogram(da.from_array(x_np, chunks=c), bins=256, range=(-4, 4))
        stencil.LAUNCHES = hk.LAUNCHES = 0
        got_st, got_h = st.compute(), h.compute()
        launches = {"band_stencil": stencil.LAUNCHES, "histogram": hk.LAUNCHES}
        check(launches["band_stencil"] >= 1 and launches["histogram"] >= 1, f"phase 31 (b): launches {launches}")
        xt = torch.from_numpy(x_np.view(np.uint16)).view(torch.bfloat16)
        ref_st = stencil.band_stencil_plain(xt, laplace_roll, (1, 1), bnd)
        got_t = torch.from_numpy(got_st.view(np.uint16)).view(torch.bfloat16)
        st_err = float((got_t.float() - ref_st.float()).abs().max())
        check(np.dtype(got_st.dtype) == np.dtype(bf16) and close16(got_t, ref_st, wsum * float(xt.float().abs().max())),
              f"phase 31 stencil2d bf16: differs from the plain version on the CPU ({st_err})")
        want_h = np.histogram(x_np.astype(np.float32), bins=256, range=(-4, 4))[0]
        check(np.array_equal(got_h, want_h), "phase 31: histogram of bf16 differs from numpy's of its float32 cast")
        out["stencil2d-bf16"] = {"size": n, "chunks": c, "max_abs_err_vs_plain_cpu": st_err,
                                 "compute_ms": host_ms(st.compute, 3), "launches": launches}
        del x_np, st, h, got_st, got_h, xt, ref_st, got_t
    # (c) datetime64[ns] with NaTs: int64 ticks on the card
    n, c = sizes["datetime"], sizes["datetime_chunk"]
    rng = np.random.default_rng(32)
    ticks = rng.integers(-(10**18), 10**18, n)
    ticks[rng.random(n) < 0.01] = np.iinfo(np.int64).min
    t = ticks.view("M8[ns]")
    d = da.from_array(t, chunks=c)
    pivot = t[n // 2] if not np.isnat(t[n // 2]) else np.datetime64(0, "ns")
    cases = {"diff": (da.diff(d), np.diff(t)), "min": (d.min(), t.min()), "max": (d.max(), t.max()),
             "where": (da.where(d > pivot, d, d[0]), np.where(t > pivot, t, t[0])),
             "astype_s": (d.astype("M8[s]"), t.astype("M8[s]"))}
    dt_out = {}
    for name, (arr, want) in cases.items():
        _hostcopy.COPIES.update({k: 0 for k in _hostcopy.COPIES})
        dev = arr.compute_device()
        check(isinstance(dev, torch.Tensor) and dev.is_cuda and dev.dtype == torch.int64,
              f"phase 31 datetime {name}: the result is not int64 ticks on the card")
        up = _hostcopy.COPIES["h2d_bytes"]
        got = arr.compute()
        check(np.asarray(got).dtype == np.asarray(want).dtype and
              np.array_equal(np.asarray(got).view("i8"), np.asarray(want).view("i8")),
              f"phase 31 datetime {name}: differs from numpy")
        dt_out[name] = {"compute_device_ms": host_ms(lambda: (arr.compute_device(), torch.cuda.synchronize()), 3),
                        "uploaded_bytes": up, "result_bytes_on_card": dev.numel() * 8}
    out["datetime-ns"] = {"values": n, "chunks": c, "nat_share": float(np.isnat(t).mean()), "equal_to_numpy": True,
                          **dt_out}
    del d, cases, t, ticks
    # (d) the host lanes, each equal to numpy (host lanes by design, as in
    # the JAX package: numpy.ma and records have no device form)
    n, c = sizes["masked"], sizes["masked_chunk"]
    rng = np.random.default_rng(33)
    m = np.ma.masked_array(rng.standard_normal((n, n)), mask=rng.random((n, n)) < 0.1)
    x = da.from_array(m, chunks=c)
    ma_out = {}
    for name, lazy, ref in (("sum", lambda: x.sum(), lambda: m.sum()), ("mean", lambda: x.mean(), lambda: m.mean()),
                            ("var", lambda: x.var(), lambda: m.var()), ("argmax", lambda: x.argmax(),
                                                                        lambda: m.argmax()),
                            ("cumsum", lambda: x.cumsum(axis=1), lambda: np.ma.cumsum(m, axis=1)),
                            ("sqrt", lambda: da.sqrt(x), lambda: np.ma.sqrt(m))):
        arr = lazy()
        got, want = arr.compute(), ref()
        if name in ("cumsum", "sqrt"):
            check(isinstance(got, np.ma.MaskedArray) and np.array_equal(np.ma.getmaskarray(got),
                                                                        np.ma.getmaskarray(want)),
                  f"phase 31 masked {name}: the mask differs")
            close = np.allclose(got.filled(0), want.filled(0), rtol=1e-12, atol=1e-9)
        else:
            close = np.allclose(float(got), float(want), rtol=1e-10, atol=0)
        check(close, f"phase 31 masked {name}: differs from numpy.ma")
        ma_out[name] = {"ms": host_ms(arr.compute, 1), "numpy_ma_ms": host_ms(ref, 1)}
    out["masked-4096"] = {"size": n, "chunks": c, "masked_share": float(m.mask.mean()), "lane": "host (numpy.ma)",
                          **ma_out}
    del m, x
    n, c = sizes["records"], sizes["records_chunk"]
    rec = np.empty(n, dtype=[("a", "f8"), ("b", "i4"), ("c", "f4")])
    rec["a"], rec["b"], rec["c"] = rng.standard_normal(n), rng.integers(0, 100, n), 2.0
    r = da.from_array(rec, chunks=c)
    arith = r["a"] * 2 + r["b"]
    dev = arith.compute_device()
    check(dev.is_cuda, "phase 31 records: the field's arithmetic did not run on the card")
    check(np.allclose(arith.compute(), rec["a"] * 2 + rec["b"], rtol=1e-15), "phase 31 records: differs from numpy")
    check(np.array_equal(r[["b", "a"]][1000:2000].compute(), rec[["b", "a"]][1000:2000]),
          "phase 31 records: a field list differs")
    out["records"] = {"records": n, "chunks": c, "lane": "host records, fields on the card",
                      "field_arith_ms": host_ms(arith.compute, 3), "numpy_ms": host_ms(lambda: rec["a"] * 2 + rec["b"], 3)}
    del rec, r, arith, dev
    saved = list(_HANDLED_CHUNK_TYPES)
    register_chunk_type(_Wrapped)
    try:
        buf = rng.standard_normal((1000, 800))
        w = da.from_array(_Wrapped(buf), chunks=(250, 200))
        got = ((w + 1) * 2).sum(axis=0).compute()
        check(isinstance(got, _Wrapped) and np.allclose(got.arr, ((buf + 1) * 2).sum(axis=0), rtol=1e-12),
              "phase 31 duck: the type or the values were lost")
        got_t = w.T[:10].compute()
        check(isinstance(got_t, _Wrapped) and np.array_equal(got_t.arr, buf.T[:10]), "phase 31 duck: transpose")
        out["duck"] = {"shape": [1000, 800], "lane": "host (the registered type's NEP-18 dispatch)", "type_kept": True}
    finally:
        _HANDLED_CHUNK_TYPES[:] = saved
        _refresh_duck_types()
    entries["band_stencil"] = {"launches_bf16": launches["band_stencil"]}
    entries["histogram"] = {"launches_bf16": launches["histogram"]}
    for tag in two_byte:
        k1, k2 = out[f"k1-{tag}-{sizes['k1'][0]}"], out[f"k2-{tag}-{sizes['k2_bins'][0]}"]
        entries["band_stencil"].update({f"max_abs_err_{tag}": k1["max_abs_err"], f"ms_{tag}": k1["kernel_ms"],
                                        f"plain_ms_{tag}": k1["plain_ms"], f"bound_ms_{tag}": k1["bound_ms"],
                                        f"library_ms_{tag}": k1[f"conv2d_{tag}_ms"]})
        entries["histogram"].update({f"max_abs_err_{tag}": k2["max_abs_err"], f"ms_{tag}": k2["kernel_ms"],
                                     f"plain_ms_{tag}": k2["plain_ms"], f"bound_ms_{tag}": k2["bound_ms"],
                                     f"library_ms_{tag}": k2["library_ms"]})
    return out, entries


# phase 34: ml_dtypes' narrow types at full width.  "n" is each type's side
# (16384^2, a 256 MiB uint8 carrier) in chunks of "chunk"; "check" the
# columns the port's CPU run of the same programs covers; "mm" the
# contractions' side (8192^2, chunks "mm_chunk"), "mm_check" the rows the
# CPU checks; "flat" the histograms' values (2^26) into "bins" bins
NARROW_SIZES = {"n": 16384, "chunk": 4096, "check": 512, "mm": 8192, "mm_chunk": 2048, "mm_check": 128,
                "flat": 1 << 26, "bins": 256}
NARROW_TYPES = ("int2", "uint2", "int4", "uint4", "float4_e2m1fn", "float8_e3m4", "float8_e4m3", "float8_e4m3b11fnuz",
                "float8_e8m0fnu")


def narrow_data(torch, name, shape, seed):
    """A host array of the narrow type ``name`` made on the card from
    ``seed``: normals times 2 (integer types rounded, their low bits kept;
    e8m0 powers of two from 2^-6 to 2^6) encoded by the port's codec."""
    import ml_dtypes

    from dask_array_tpu_torch import _narrow

    fmt = _narrow.FORMATS[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn(shape, generator=g, device="cuda") * 2
    if name == "float8_e8m0fnu":
        v = torch.exp2(torch.round(v * 2).clamp(-6, 6))
    elif not fmt.is_float:
        v = v.round()
    return _narrow.encode(v, fmt).cpu().numpy().view(getattr(ml_dtypes, name))


def narrow_paths(da, torch, sizes, smi):
    """The nine narrow types on the card (phase 34).  (a) each type's
    n^2 array, persisted on the card, through astype(float32), x * 2 + 1,
    sum(axis=0), sum(), max(axis=0), max(), cumsum(axis=0) and where:
    each result held against the port's own CPU run of the same program
    (the CPU tests hold that to the JAX package and numpy), bit for bit on
    ``check`` columns (sum() and max() whole), except that a float sum may
    lie one step of the type apart (float32 partials summed in another
    order on the two devices; counted); compute() times.  (b) matmul of
    8192^2 float8_e4m3 (a float32 product) and int4 (int8, exact) operands
    in chunks of 2048, against the CPU's rows.  (c) histograms of 2^26
    float8_e4m3fn, float8_e5m2 and int4 values into 256 bins through
    da.histogram (the byte route, one launch each; float8 raised on the
    parent), equal to the plain version, then the kernel per call and on
    the device beside its plain version and torch.histc of the float32
    values, with the bound.  Returns (numbers, byte-route launches of the
    API run, the kernel's timing entry)."""
    import ml_dtypes
    import numpy as np

    from dask_array_tpu_torch import _narrow, config
    from dask_array_tpu_torch.kernels import histogram as hk

    n, c, cols = sizes["n"], sizes["chunk"], sizes["check"]
    out = {}
    progs = {
        "astype_float32": lambda x: x.astype(np.float32),
        "mul_add": lambda x: x * 2 + 1,
        "sum_axis0": lambda x: x.sum(axis=0),
        "max_axis0": lambda x: x.max(axis=0),
        "cumsum_axis0": lambda x: x.cumsum(axis=0),
        "where": lambda x: da.where(x.astype(np.float32) > 0, x, x[::-1]),
    }
    for seed, name in enumerate(NARROW_TYPES, 340):
        dt = np.dtype(getattr(ml_dtypes, name))
        fmt = _narrow.FORMATS[name]
        a = narrow_data(torch, name, (n, n), seed)
        x = da.from_array(a, chunks=c).persist()
        num = {"ms": {}, "steps": {}}
        whole = {}
        for pname, prog in progs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = prog(x).compute()
            num["ms"][pname] = (time.perf_counter() - t0) * 1e3
            got = got[..., :cols]
            with config.set({"device": "cpu"}):
                want = prog(da.from_array(a[:, :cols], chunks=c)).compute()
            check(got.dtype == want.dtype and got.shape == want.shape, f"phase 34 {name} {pname}: dtype/shape")
            if pname == "sum_axis0" and fmt.is_float:
                num["steps"][pname] = steps_apart(got, want, dt)
                check(num["steps"][pname] <= 1, f"phase 34 {name} {pname}: {num['steps'][pname]} steps from the CPU")
            else:
                check(np.array_equal(got.view(np.uint8), want.view(np.uint8)), f"phase 34 {name} {pname}: differs "
                                                                                 "from the port's CPU run")
        for pname in ("sum", "max"):
            got = getattr(x, pname)().compute()
            with config.set({"device": "cpu"}):
                want = getattr(da.from_array(a, chunks=c), pname)().compute()
            check(got.dtype == want.dtype, f"phase 34 {name} {pname}: dtype")
            if pname == "sum" and fmt.is_float:
                num["steps"][pname] = steps_apart(got, want, dt)
                check(num["steps"][pname] <= 1, f"phase 34 {name} sum: {num['steps'][pname]} steps from the CPU")
            else:
                check(np.array_equal(np.asarray(got).view(np.uint8), np.asarray(want).view(np.uint8)),
                      f"phase 34 {name} {pname}: differs from the port's CPU run")
            whole[pname] = float(np.asarray(got).astype(np.float64))
        num.update(whole)
        out[name] = num
        del a, x
        torch.cuda.empty_cache()

    # (b) contractions: numpy's matmul dtypes (float32, int8)
    m, mc, rows = sizes["mm"], sizes["mm_chunk"], sizes["mm_check"]
    for seed, name in enumerate(("float8_e4m3", "int4"), 360):
        a = narrow_data(torch, name, (m, m), seed)
        b = narrow_data(torch, name, (m, m), seed + 10)
        prod = da.from_array(a, chunks=mc) @ da.from_array(b, chunks=mc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = prod.compute_device()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = got[:rows].cpu().numpy()
        with config.set({"device": "cpu"}):
            want = (da.from_array(a[:rows], chunks=mc) @ da.from_array(b, chunks=mc)).compute()
        check(got.dtype == want.dtype, f"phase 34 matmul {name}: {got.dtype} vs {want.dtype}")
        if name == "int4":
            check(np.array_equal(got, want), "phase 34 matmul int4: differs from the CPU's exact product")
            err = 0.0
        else:
            mag = np.abs(a[:rows].astype(np.float32)) @ np.abs(b.astype(np.float32))
            err = float(np.max(np.abs(got - want) / np.maximum(mag, 1e-30)))
            check(err <= 1e-5, f"phase 34 matmul {name}: {err} of sum |a||b| from the CPU")
        out[f"matmul_{name}"] = {"shape": [m, m], "chunks": mc, "dtype": str(got.dtype), "compute_device_ms": ms,
                                 "TFLOPs": 2 * m**3 / ms / 1e9, "err_of_abs_product": err, "rows_checked": rows}
        del a, b, prod
        torch.cuda.empty_cache()

    # (c) histograms: the byte route through the API, then its timing
    flat, nb = sizes["flat"], sizes["bins"]
    edges = np.linspace(-4, 4, nb + 1)
    e = torch.from_numpy(edges).cuda()
    g = torch.Generator(device="cuda").manual_seed(370)
    normal = torch.randn(flat, generator=g, device="cuda") * 2
    data = {"float8_e4m3fn": (normal.to(torch.float8_e4m3fn), None),
            "float8_e5m2": (normal.to(torch.float8_e5m2), None),
            "int4": (_narrow.encode(normal.round(), _narrow.FORMATS["int4"]), np.dtype(ml_dtypes.int4))}
    del normal
    hk.LAUNCHES = 0
    for name, (t, ndt) in data.items():
        host = t.cpu().numpy().view(ndt) if ndt is not None else t.view(torch.uint8).cpu().numpy().view(
            getattr(ml_dtypes, name))
        h, _ = da.histogram(da.from_array(host, chunks=1 << 24), bins=edges)
        got = h.compute()
        ref = hk.histogram_counts_plain(t, e, None, ndt).cpu().numpy()
        check(np.array_equal(got, ref) and int(got.sum()) > 0, f"phase 34 histogram {name}: differs from the plain "
                                                              "version")
    api_launches = hk.LAUNCHES
    check(api_launches == len(data), f"phase 34: the byte route launched {api_launches} times for {len(data)} "
                                     "histograms")
    timing = {}
    for name, (t, ndt) in data.items():
        kind = ndt if ndt is not None else t.dtype
        values = hk.byte_values(kind).to(t.device)[t.view(torch.uint8).to(torch.int64)]

        def kernel(t=t, ndt=ndt):
            return hk.histogram_counts_cuda(t, e, dtype=ndt)

        def plain(t=t, ndt=ndt):
            return hk.histogram_counts_plain(t, e, None, ndt)

        def library(t=t, values=values):
            # torch.histc refuses float8 and has no int4: the float32 cast
            # of a float8 tensor inside the call, the int4 values before it
            return torch.histc((t if t.dtype != torch.uint8 else values).float(), nb, -4, 4)

        got, ref, pat = kernel(), plain(), hk.histogram_bytes_plain(t, e, kind)
        check(torch.equal(got, ref) and torch.equal(got, pat), f"phase 34 K2 bytes {name}: counts differ")
        k_ms, p_ms, k_runs, p_runs = paired_ms(plain, kernel, reps=20)
        b_ms, b_by = bound(flat + nb * 8, flat)
        dev = device_ms(kernel)
        timing[name] = {"kernel_ms": k_ms, "kernel_device_ms": dev, "kernel_runs_ms": k_runs, "plain_ms": p_ms,
                        "plain_runs_ms": p_runs, "library": "torch.histc of the float32 values",
                        "library_ms": cuda_ms(library), "library_device_ms": device_ms(library),
                        "bytes": flat + nb * 8, "bound_ms": b_ms, "bound_by": b_by, "of_bound": b_ms / dev,
                        "max_abs_err_vs_plain": float((got - ref).abs().max())}
        del values
    out["histograms"] = {"values": flat, "bins": nb, "api_launches": api_launches, "timing": timing}
    del data
    torch.cuda.empty_cache()
    return out, api_launches, timing


# phase 32: the mesh on the card.  "n" is the flagship's a (n x n float32,
# 1 GiB; b is n/2 x n), "rows" x "cols" the shard lane's irregular grid in
# the 11 row blocks of "heights" (the JAX package's grid, scaled)
MESH_SIZES = {"n": 16384, "rows": 1_000_000, "cols": 128, "heights": (23, 7, 15, 31, 9, 12, 4, 11, 8, 10, 7)}


def flagship(a, b):
    """``__graft_entry__._pipeline``: feature-normalise, contract, row-reduce."""
    centered = a - a.mean(axis=0)
    scaled = centered / (a.std(axis=0) + 1e-6)
    y = scaled @ b.T
    return (y * y).sum(axis=1)


def mesh_paths(da, torch, sizes, device="cuda"):
    """Phase 32: the JAX package's multichip dry run at full width on the
    card, over 4 slots (2 x 2 ``("x", "y")``, or a ring ``("r",)``) on
    ``cuda:0``, or on 4 distinct cards where there are 4.  Every part runs
    with and without the mesh in this process; the values must agree.
    ``device="cpu"`` runs the same parts on 4 CPU slots (a quick check of
    the script at small ``sizes``).  Returns ({part: numbers}, the kernel
    launches under the mesh)."""
    import contextlib

    import numpy as np

    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import halo, mstat, stencil
    from dask_array_tpu_torch.kernels import scale as sk
    from dask_array_tpu_torch.kernels import transpose as tk
    from dask_array_tpu_torch.models.pipelines import laplace_roll
    from dask_array_tpu_torch.parallel import Mesh, auto_mesh, use_mesh
    from dask_array_tpu_torch.parallel._sharded import COLLECTIVES
    from dask_array_tpu_torch.parallel.shardlane import ENGAGED

    on_card = device == "cuda"  # the CPU runs the kernels' plain versions: no launch to count
    cards = torch.cuda.device_count() if on_card else 0
    slots = [f"cuda:{i}" for i in range(4)] if cards >= 4 else ["cuda:0" if on_card else device] * 4
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    grid = Mesh(np.array(slots, dtype=object).reshape(2, 2), ("x", "y"))
    ring = Mesh(np.array(slots, dtype=object), ("r",))
    kernels = {"band_stencil": stencil, "halo": halo, "multi_stat": mstat, "transpose": tk, "scale": sk}
    total = {k: 0 for k in kernels}
    out = {}

    def run(e, mesh):
        """compute_device() of ``e`` (twice; the second timed), under
        ``mesh`` or none: (tensor, ms, launches, collectives, lane
        programs) of the timed run."""
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            e.compute_device()
            for m in kernels.values():
                m.LAUNCHES = 0
            coll, eng, nb = COLLECTIVES.snapshot(), ENGAGED["count"], dict(COLLECTIVES.nbytes)
            sync()
            t0 = time.perf_counter()
            got = e.compute_device()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        launched = {k: m.LAUNCHES for k, m in kernels.items()}
        if mesh is not None:
            for k, v in launched.items():
                total[k] += v
        moved = {k: (n, COLLECTIVES.nbytes[k] - nb[k]) for k, n in COLLECTIVES.delta(coll).items()}
        return got, ms, {k: v for k, v in launched.items() if v}, moved, ENGAGED["count"] - eng

    def part(name, e, mesh, rtol, expect=None):
        want, plain_ms, plain_launches, _, _ = run(e, None)
        got, mesh_ms, launched, moved_bytes, engaged = run(e, mesh)
        moved = {k: n for k, (n, _) in moved_bytes.items()}
        check(got.shape == want.shape and got.dtype == want.dtype, f"phase 32 {name}: shape/dtype")
        scale = float(want.double().abs().max()) if want.is_floating_point() else 1.0
        err = float((got.double() - want.double()).abs().max())
        check(err <= rtol * max(scale, 1.0), f"phase 32 {name}: {err} from the no-mesh answer (scale {scale})")
        if expect is not None:
            expect(launched, moved, engaged)
        out[name] = {"mesh": dict(mesh.shape), "slots": [str(d) for d in mesh.slots], "max_abs_err": err,
                     "rtol": rtol, "no_mesh_ms": plain_ms, "mesh_ms": mesh_ms, "launches": launched,
                     "no_mesh_launches": plain_launches, "collectives": moved,
                     "collective_bytes": {k: b for k, (_, b) in moved_bytes.items()}, "lane_programs": engaged}
        return got

    n = sizes["n"]
    g = torch.Generator(device=device).manual_seed(32)
    # drawn on the card, entered from numpy and persisted there: (a)-(c)
    # time the device work, not the upload
    a = da.from_array(torch.randn((n, n), generator=g, device=device).cpu().numpy(), chunks=(n // 2, n // 2)).persist()
    b = da.from_array(torch.randn((n // 2, n), generator=g, device=device).cpu().numpy(),
                      chunks=(n // 2, n // 2)).persist()

    # (a) the flagship step, with an explicit rechunk boundary (on the 2 x 2
    # mesh the solver swaps b's two mesh axes: one whole-shard permute)
    def swap_once(launched, moved, engaged):
        check(moved.get("ppermute") == 1 and "all_gather" not in moved, f"phase 32 flagship: {moved}")

    part("flagship", flagship(a, b.freeze_chunks().rechunk((n // 4, n))), grid, 1e-4, expect=swap_once)

    # (b) the stencil under overlap-method "shard": the band-stencil kernel
    # once a slot, two permutes a sharded axis (both axes: four)
    def k1_per_slot(launched, moved, engaged):
        check(launched.get("band_stencil") == 4 or not on_card, f"phase 32 stencil: K1 launches {launched}")
        check(moved == {"ppermute": 4, "gather": 1}, f"phase 32 stencil: {moved}")

    with config.set({"overlap-method": "shard"}):
        st = da.map_overlap(laplace_roll, a, depth=1, boundary="reflect")
    check(type(st.expr).__name__ == "BandStencil", "phase 32: the stencil is no BandStencil")
    part("stencil", st, grid, 1e-5, expect=k1_per_slot)

    # (b) a func K1 does not take, through ShardStencil on the ring: rows
    # exchanged, the whole column axis padded by the halo kernel once a slot
    def halo_per_slot(launched, moved, engaged):
        check(launched.get("halo") == 4 or not on_card, f"phase 32 tanh: halo launches {launched}")
        check(not launched.get("band_stencil"), f"phase 32 tanh: {launched}")
        check(moved == {"ppermute": 2, "gather": 1}, f"phase 32 tanh: {moved}")

    with config.set({"overlap-method": "shard"}):  # routed when the graph is built
        tanh_laplace = da.map_overlap(lambda blk: torch.tanh(laplace_roll(blk)), a, depth=1, boundary="nearest",
                                      dtype="float32")
    check(type(tanh_laplace.expr).__name__ == "ShardStencil", "phase 32: tanh(laplace) is no ShardStencil")
    part("tanh-laplace", tanh_laplace, ring, 1e-5, expect=halo_per_slot)

    # (c) the relayout: a scan, a rechunk that moves a mesh axis, a sum.  The
    # partitioned walk holds a's rows and columns sharded: a scan along a
    # sharded axis adds one all_gather of its totals, no more
    def relayout(kind):
        def expect(launched, moved, engaged):
            check(moved.get(kind) and moved.get("all_gather", 0) <= 1, f"phase 32 relayout: {moved}")

        return expect

    part("relayout-grid", a.cumsum(axis=1).rechunk((n, n // 2)).sum(axis=0), grid, 1e-4,
         expect=relayout("ppermute"))
    part("relayout-ring", a.cumsum(axis=1).rechunk((n, n // 4)).sum(axis=0), ring, 1e-4,
         expect=relayout("all_to_all"))
    del a, b

    # (d) the shard lane on an irregular grid of 11 row blocks
    rows, cols = sizes["rows"], sizes["cols"]
    hs = [int(h * rows / sum(sizes["heights"])) for h in sizes["heights"]]
    hs[-1] += rows - sum(hs)
    # the lane takes from_array leaves of host data: each slot uploads its rows
    x = da.from_array(torch.randn((rows, cols), generator=g, device=device).cpu().numpy(), chunks=(tuple(hs), cols))
    w = da.from_array(torch.randn((cols, cols), generator=g, device=device).cpu().numpy(), chunks=(cols, cols))

    def lane(combines):
        def expect(launched, moved, engaged):
            check(engaged == 1, f"phase 32 lane: {engaged} lane programs")
            got = {k: v for k, v in moved.items() if k != "gather"}
            check(got == combines, f"phase 32 lane: collectives {moved}, want {combines}")

        return expect

    part("lane-sum", (x * 2 + 1).sum(axis=0), grid, 1e-5, expect=lane({"psum": 1}))
    part("lane-mean", x.mean(axis=0), grid, 1e-5, expect=lane({"psum": 1}))
    part("lane-var", x.var(axis=0), grid, 1e-5, expect=lane({"psum": 2}))
    # a float32 scan of 1e6 rows: the carry is added once a slot where the
    # single scan runs on, so the two round apart by up to 1e-4 of the top
    part("lane-cumsum", da.cumsum(x, axis=0), grid, 1e-4, expect=lane({"all_gather": 1}))
    part("lane-matmul", x @ w, grid, 1e-5, expect=lane({}))
    # the vote: the extremum (pmax), NaN presence (pmax), the first index (pmin)
    part("lane-argmax", x.argmax(axis=0), grid, 0.0, expect=lane({"pmax": 2, "pmin": 1}))

    # (e) auto_mesh over the cards present
    am = auto_mesh() if device == "cuda" else auto_mesh(devices=[device])
    part("auto-mesh-sum", (x * 2 + 1).sum(axis=0), am, 1e-5, expect=lane({"psum": 1}))
    del x, w
    if device == "cuda":
        torch.cuda.empty_cache()
    return out, total


# phase 33: the partitioned walk on the card.  "n" is the flagship's a (as
# in phase 32), "tree" reduction_tree's side, "relayout" rechunk_relayout's
# and "matmul" blocked_matmul's, "rows" x "cols" the tall-skinny array (the
# column weighting and tall_skinny_svd), "hist" the histogram's values and
# "scan" the cumsum -> rechunk pipeline's side
PARTITIONED_SIZES = {"n": 16384, "tree": 10000, "relayout": 8192, "matmul": 8192, "rows": 1_000_000, "cols": 128,
                     "hist": 1 << 26, "bins": 256, "scan": 8192}


def partitioned_paths(da, torch, sizes, device="cuda"):
    """Phase 33: the partitioned walk at full width over 4 slots (a 2 x 2
    ``("x", "y")`` grid and a ring ``("r",)``) on ``cuda:0``, or on 4
    distinct cards where there are 4.  Each workload runs under
    ``"execution-lane"`` "gspmd" and "auto" and without a mesh in this
    process; the values must agree (bit for bit where the walk keeps the
    order of every addition, else to the stated tolerance).
    ``device="cpu"`` runs the same parts on 4 CPU slots (a quick check at
    small ``sizes``; the kernels' plain versions launch nothing).  Returns
    ({part: numbers}, the kernels' launches under a mesh)."""
    import contextlib

    import numpy as np

    from dask_array_tpu_torch import config
    from dask_array_tpu_torch.kernels import histogram as hk
    from dask_array_tpu_torch.kernels import mstat
    from dask_array_tpu_torch.kernels import scale as sk
    from dask_array_tpu_torch.kernels import transpose as tk
    from dask_array_tpu_torch.models.pipelines import rechunk_relayout
    from dask_array_tpu_torch.parallel import Mesh, use_mesh
    from dask_array_tpu_torch.parallel._sharded import COLLECTIVES
    from dask_array_tpu_torch.parallel.partition import PARTITIONED

    on_card = device == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    slots = [f"cuda:{i}" for i in range(4)] if cards >= 4 else ["cuda:0" if on_card else device] * 4
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    meshes = {"grid": Mesh(np.array(slots, dtype=object).reshape(2, 2), ("x", "y")),
              "ring": Mesh(np.array(slots, dtype=object), ("r",))}
    kernels = {"transpose": tk, "scale": sk, "multi_stat": mstat, "histogram": hk}
    total = {k: 0 for k in kernels}
    out = {}
    g = torch.Generator(device=device).manual_seed(33)

    def leaf(shape, chunks):
        # drawn on the card, entered from numpy and persisted there without
        # a mesh: each run times the device work, and under a mesh the walk
        # binds the persisted tensor's slot parts as views
        return da.from_array(torch.randn(shape, generator=g, device=device).cpu().numpy(), chunks=chunks).persist()

    def run(arrays, mesh, lane):
        """compute_device() of ``arrays`` together (twice; the second timed)
        under ``mesh`` and ``lane``, or none: (tensors, ms, launches,
        collectives with bytes, PARTITIONED delta) of the timed run."""
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext(), config.set({"execution-lane": lane}):
            from dask_array_tpu_torch._materialize import compute_exprs

            compute_exprs([a.expr for a in arrays])
            for m in kernels.values():
                m.LAUNCHES = 0
            coll, nb, parts = COLLECTIVES.snapshot(), dict(COLLECTIVES.nbytes), PARTITIONED.snapshot()
            sync()
            t0 = time.perf_counter()
            got = compute_exprs([a.expr for a in arrays])
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        launched = {k: m.LAUNCHES for k, m in kernels.items()}
        moved = {k: [n, COLLECTIVES.nbytes[k] - nb[k]] for k, n in COLLECTIVES.delta(coll).items()}
        return got, ms, launched, moved, PARTITIONED.delta(parts)

    def part(name, arrays, rtol, expect=None):
        want, plain_ms, plain_launches, _, _ = run(arrays, None, "auto")
        for mname, mesh in meshes.items():
            for lane in ("gspmd", "auto"):
                got, ms, launched, moved, parted = run(arrays, mesh, lane)
                errs = []
                for gv, wv in zip(got, want):
                    check(gv.shape == wv.shape and gv.dtype == wv.dtype, f"phase 33 {name} {mname} {lane}: shape")
                    scale = float(wv.double().abs().max()) if wv.numel() and wv.is_floating_point() else 1.0
                    err = float((gv.double() - wv.double()).abs().max()) if wv.numel() else 0.0
                    check(err <= rtol * max(scale, 1.0), f"phase 33 {name} {mname} {lane}: {err} from the no-mesh "
                          f"answer (scale {scale})")
                    errs.append(err)
                if lane == "gspmd" and expect is not None:
                    expect(mname, launched, moved, parted)
                for k, v in launched.items():
                    total[k] += v
                out[f"{name}-{mname}-{lane}"] = {
                    "mesh": dict(mesh.shape), "slots": [str(d) for d in mesh.slots], "max_abs_err": max(errs),
                    "rtol": rtol, "no_mesh_ms": plain_ms, "mesh_ms": ms, "launches": launched,
                    "no_mesh_launches": plain_launches, "collectives": moved, "partitioned": parted}
        if on_card:
            torch.cuda.empty_cache()

    def per_slot(kernel):
        def expect(mname, launched, moved, parted):
            check(launched[kernel] >= 4 or not on_card, f"phase 33 {kernel}: {launched[kernel]} launches on 4 slots")
        return expect

    # (a) the flagship: no node gathers a, only the output comes back
    n = sizes["n"]
    a = leaf((n, n), (n // 2, n // 2))
    b = leaf((n // 2, n), (n // 2, n // 2))

    def flagship_expect(mname, launched, moved, parted):
        check("gathered" not in parted, f"phase 33 flagship {mname}: gathered {parted.get('gathered')}")
        check(moved["gather"][0] == 1 and moved["gather"][1] <= n * 4, f"phase 33 flagship {mname}: {moved}")

    part("flagship", [flagship(a, b)], 1e-4, flagship_expect)
    del a, b

    # (b) reduction_tree's three statistics (its formula, persisted input):
    # the multi-statistic kernel once a slot, one psum
    nt = sizes["tree"]
    x = leaf((nt, nt), 1000)
    part("reduction_tree", [x.sum(axis=0, split_every=4), x.mean(axis=1, split_every=4), x.std(split_every=4)], 1e-5,
         per_slot("multi_stat"))
    # (c) rechunk_relayout (persisted): the transpose kernel once a slot
    part("rechunk_relayout", [rechunk_relayout(n=sizes["relayout"], persist=True)], 0.0, per_slot("transpose"))
    # (d) blocked_matmul, chunks 1024 against 512
    nm = sizes["matmul"]
    part("blocked_matmul", [leaf((nm, nm), 1024) @ leaf((nm, nm), 512)], 1e-5)
    # (e) a column weighting: the scale kernel once a slot
    rows, cols = sizes["rows"], sizes["cols"]
    xt = leaf((rows, cols), (rows // 10, cols))
    w = leaf((cols,), cols)
    part("column_weights", [(xt * w).sum(axis=0)], 1e-5, per_slot("scale"))
    # (f) tall_skinny_svd's formula: TSQR has no rule and reads its operand
    # dense (the persisted leaf: no copy); svd_flip's multiplies follow dense
    part("tall_skinny_svd", list(da.linalg.svd(xt)), 1e-4)
    del x, xt, w
    # (g) the histogram kernel once a slot, one psum of the counts
    hv = leaf((sizes["hist"],), sizes["hist"] // 8)
    part("histogram", [da.histogram(hv, bins=np.linspace(-4, 4, sizes["bins"] + 1))[0]], 0.0, per_slot("histogram"))
    del hv
    # (h) the JAX package's test_mesh_battery.py multi-stage pipeline
    ns = sizes["scan"]
    d = leaf((ns, ns), (ns // 8, ns))
    part("scan_rechunk", [(d.cumsum(axis=1).rechunk((ns, ns // 8)) * 2).sum(axis=0) + 1], 1e-4)
    del d
    return out, total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import numpy as np

    import dask_array_tpu_torch as da
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch._materialize import compute_exprs
    from dask_array_tpu_torch.kernels import _build, halo, mstat, stencil
    from dask_array_tpu_torch.kernels import scale as sk
    from dask_array_tpu_torch.kernels import transpose as tk
    from dask_array_tpu_torch.models.pipelines import (
        blocked_matmul,
        laplace_roll,
        normalize_contract,
        readme_example,
        rechunk_relayout,
        reduction_tree,
        stencil2d,
        tall_skinny_svd,
    )
    from dask_array_tpu_torch.ops import linalg_decomp
    from dask_array_tpu_torch.ops._overlap import BandStencil
    from dask_array_tpu_torch.ops._sliding import move_mean, move_std

    # -- phase 1: setup ------------------------------------------------------
    config.set_global({"device": "cuda"})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    built = _build.build_all(["band_stencil", "mstat", "transpose", "halo", "scale", "histogram"])
    build_s = time.perf_counter() - t_start
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    for _, ptxas in built.values():
        print(ptxas.strip(), flush=True)
    phase(1, "setup", build_s=build_s, libraries=[p.name for p, _ in built.values()],
          torch=torch.__version__, cuda=torch.version.cuda, device=kind)
    print(smi, flush=True)

    # -- phase 2: the band-stencil kernel against its plain version ----------
    modes = ["reflect", "nearest", "periodic", 0.0, 2.5]
    cases = [((1000, 1003), (1, 1), (b0, b1), torch.float32) for b0 in modes for b1 in modes]
    for depth in [(2, 1), (1, 0), (8, 8)]:
        for bnd in [("reflect", "periodic"), (2.5, "nearest"), ("periodic", 0.0)]:
            cases.append(((1000, 1003), depth, bnd, torch.float32))
    for dt in (torch.float16, torch.float64):
        for depth in [(1, 1), (2, 1), (8, 8)]:
            for bnd in [("reflect", "reflect"), ("periodic", 2.5), (0.0, "nearest")]:
                cases.append(((1000, 1003), depth, bnd, dt))
    # the redesign's paths: 16-byte rows (N * itemsize a multiple of 16) in
    # each dtype and both kernels (the register window at depth (1,1), the
    # tap list at every other depth), interior and edge blocks of the
    # main path's 4096^2, and scalar rows from a tensor at storage offset 1
    for dt in (torch.float16, torch.float32, torch.float64):
        for depth in [(1, 1), (2, 2), (1, 0), (0, 1), (2, 1), (8, 8)]:
            for bnd in [("reflect", "periodic"), (2.5, "nearest")]:
                cases.append(((1024, 1024), depth, bnd, dt))
    cases += [((1000, 1003), depth, ("reflect", 2.5), torch.float32) for depth in [(2, 2), (0, 1)]]
    cases += [((4096, 4096), (1, 1), ("reflect", "reflect"), torch.float32),
              ((1000, 1003), (1, 1), ("periodic", 0.0), "offset1"),
              ((1000, 1024), (2, 1), ("nearest", "reflect"), "offset1")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    variants = set()
    for shape, depth, bnd, dt in cases:
        func = stencil_for(*depth)
        taps = stencil.capture_taps(func, depth)
        check(taps is not None, f"capture_taps declined the depth-{depth} test stencil")
        if dt == "offset1":  # a contiguous tensor one element into its storage: the scalar path
            dt = torch.float32
            x = torch.randn(shape[0] * shape[1] + 1, generator=gen, device="cuda")[1:].view(shape)
            check(x.storage_offset() == 1 and not stencil.vector_ok(x, torch.empty_like(x)), "offset 1: not scalar")
        else:
            x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dt)
        variants.add((stencil.kernel_variant(depth), stencil.vector_ok(x, torch.empty_like(x))))
        got = stencil.band_stencil_cuda(x, taps, depth, bnd)
        torch.cuda.synchronize()
        scale = sum(abs(w) for _, _, w in taps) * float(x.abs().max())
        if dt == torch.float16:
            # the kernel accumulates float16 in float32: its reference is the
            # plain version in float32 on the same inputs, rounded once
            want = stencil.band_stencil_plain(x.float(), func, depth, bnd).half()
            rtol, atol = 1e-3, scale * 2.0**-11
        elif dt == torch.float32:
            want = stencil.band_stencil_plain(x, func, depth, bnd)
            rtol, atol = 1e-5, scale * 2.0**-21
        else:
            want = stencil.band_stencil_plain(x, func, depth, bnd)
            rtol, atol = 1e-12, scale * 1e-12
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype, f"{shape} {dt}: shape/dtype")
        err = float((got.double() - want.double()).abs().max())
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        key = str(dt).replace("torch.", "")
        worst[key] = max(worst.get(key, 0.0), err)
    check(variants == {(v, vec) for v in range(2) for vec in (False, True)}, f"kernel paths run: {sorted(variants)}")
    # an inf in the input: the window kernel skips the 5-point stencil's
    # empty corners (0 * inf would be NaN), as the plain version never reads them
    lap_taps = stencil.capture_taps(laplace_roll, (1, 1))
    xi = torch.randn((1024, 1024), generator=gen, device="cuda")
    xi[100, 200] = float("inf")
    xi[300, 500] = -float("inf")
    got = stencil.band_stencil_cuda(xi, lap_taps, (1, 1), ("reflect", "reflect"))
    want = stencil.band_stencil_plain(xi, laplace_roll, (1, 1), ("reflect", "reflect"))
    torch.cuda.synchronize()
    check(not bool(want.isnan().any()) and not bool(got.isnan().any()), "inf input: a NaN appeared")
    check(int(got.isinf().sum()) == int(want.isinf().sum()) == 10, "inf input: the infs differ")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=8 * float(xi[xi.isfinite()].abs().max()) * 2.0**-21)
    phase(2, "kernel-vs-plain", cases=len(cases) + 1, shapes=[[1000, 1003], [1024, 1024], [4096, 4096],
                                                          [1000, 1024]],
          paths=sorted(variants), storage_offset_1=["(1000, 1003)", "(1000, 1024)"], inf_case="5-point, 1024^2",
          max_abs_err=worst, tolerance={"float32": "rtol 1e-5, atol sum|w|*max|x|*2^-21",
                                        "float64": "rtol 1e-12, atol sum|w|*max|x|*1e-12",
                                        "float16": "vs float32 plain: rtol 1e-3, atol sum|w|*max|x|*2^-11"})

    # -- phases 3-5: the stencil main path, counting kernel launches ----------
    stencil.LAUNCHES = 0

    tk.LAUNCHES = 0
    y = readme_example()
    plan = y.optimize().expr.tree_repr()
    check(plan.startswith("FusedBlockwise[3]"), f"README plan not fused:\n{plan}")
    check(plan.count("Ones(chunks_=((100,), (100,))") == 2, f"slice not pushed into leaves:\n{plan}")
    dev = y.compute_device()
    check(dev.is_cuda, f"README result on {dev.device}")
    yv = y.compute()
    check(yv.shape == (100, 100) and bool(np.all(yv == 2.0)), "README values are not 2.0")
    # x.T of the sliced leaf goes through the transpose kernel, once a run
    readme_launches = {"transpose": tk.LAUNCHES}
    check(tk.LAUNCHES == 2, f"README example launched the transpose {tk.LAUNCHES} times in two runs")
    phase(3, "readme", shape=list(yv.shape), value=float(yv[0, 0]), plan_nodes=plan.count("\n"),
          launches=readme_launches)

    rng = np.random.default_rng(0)
    x4 = rng.standard_normal((4096, 4096), dtype=np.float32)
    ref4 = numpy_laplace(x4)
    atol4 = 8 * float(np.abs(x4).max()) * 2.0**-21
    roll4 = stencil2d(x4, chunk=1024, form="roll")
    check(isinstance(roll4.expr, BandStencil), f"roll form is {type(roll4.expr).__name__}")
    before = stencil.LAUNCHES
    out4 = roll4.compute_device()
    check(out4.is_cuda, f"stencil2d result on {out4.device}")
    check(stencil.LAUNCHES > before, "stencil2d roll form did not launch the kernel")
    r4 = out4.cpu().numpy()
    slices4 = stencil2d(x4, chunk=1024, form="slices")
    check(not isinstance(slices4.expr, BandStencil), "slices form routed to BandStencil")
    s4 = slices4.compute()
    for name, res in (("roll", r4), ("slices", s4)):
        check(res.shape == (4096, 4096) and res.dtype == np.float32, f"{name}: shape/dtype")
        check(bool(np.isfinite(res).all()), f"{name}: non-finite values")
        np.testing.assert_allclose(res, ref4, rtol=1e-5, atol=atol4)
    phase(4, "stencil2d-4096", roll_err=float(np.abs(r4 - ref4).max()),
          slices_err=float(np.abs(s4 - ref4).max()), atol=atol4)

    x16 = rng.standard_normal((16384, 16384), dtype=np.float32)
    roll16 = stencil2d(x16, chunk=4096, form="roll")
    check(isinstance(roll16.expr, BandStencil), "16384 roll form is not BandStencil")
    res16 = roll16.compute()
    check(res16.shape == (16384, 16384) and res16.dtype == np.float32, "16384: shape/dtype")
    check(bool(np.isfinite(res16).all()), "16384: non-finite values")
    x16d = torch.from_numpy(x16).cuda()
    want16 = stencil.band_stencil_plain(x16d, laplace_roll, (1, 1), ("reflect", "reflect"))
    got16 = torch.from_numpy(res16).cuda()
    torch.cuda.synchronize()
    atol16 = 8 * float(x16d.abs().max()) * 2.0**-21
    torch.testing.assert_close(got16, want16, rtol=1e-5, atol=atol16)
    err16 = float((got16 - want16).abs().max())
    del res16, got16, want16, x16d
    phase(5, "stencil2d-16384", max_abs_err=err16, atol=atol16)

    stencil_launches = stencil.LAUNCHES
    check(stencil_launches > 0, "the stencil path launched the band-stencil kernel no time")

    # -- phase 6: stencil timing ---------------------------------------------
    bnd = ("reflect", "reflect")
    taps = stencil.capture_taps(laplace_roll, (1, 1))
    lap_w = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], device="cuda")[None, None]
    st_timings = {}
    for n, x_np, arr, reps in ((4096, x4, roll4, 5), (16384, x16, roll16, 3)):
        xd = torch.from_numpy(x_np).cuda()
        nbytes = 2 * n * n * xd.element_size()
        kernel_ms, plain_ms, k_runs, p_runs = paired_ms(
            lambda: stencil.band_stencil_plain(xd, laplace_roll, (1, 1), bnd),
            lambda: stencil.band_stencil_cuda(xd, taps, (1, 1), bnd),
        )
        # the same bytes read and written by a plain device copy: the
        # card's copy-stream reference for a memory-bound kernel
        copy_ms = cuda_ms(lambda: xd.clone())
        # the nearest single library call: a 3x3 convolution of the padded
        # array (padding outside the timed window; cuDNN TF32 off)
        padded = stencil.pad_axis(stencil.pad_axis(xd, 0, 1, 1, "reflect"), 1, 1, 1, "reflect")[None, None]
        conv_ms = cuda_ms(lambda: torch.nn.functional.conv2d(padded, lap_w))
        conv_err = float((torch.nn.functional.conv2d(padded, lap_w)[0, 0]
                          - stencil.band_stencil_cuda(xd, taps, (1, 1), bnd)).abs().max())
        # the device alone (the host's launch hidden behind a spin), for the
        # kernel, the library call and the copy
        kernel_dev = device_ms(lambda: stencil.band_stencil_cuda(xd, taps, (1, 1), bnd))
        conv_dev = device_ms(lambda: torch.nn.functional.conv2d(padded, lap_w))
        copy_dev = device_ms(lambda: xd.clone())
        del padded
        dev_ms = host_ms(lambda: (arr.compute_device(), torch.cuda.synchronize()), reps)
        compute_ms = host_ms(arr.compute, reps)
        err = float((stencil.band_stencil_cuda(xd, taps, (1, 1), bnd)
                     - stencil.band_stencil_plain(xd, laplace_roll, (1, 1), bnd)).abs().max())
        bound_ms, bound_by = bound(nbytes, 2 * len(taps) * n * n)
        st_timings[n] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                             kernel_runs_ms=k_runs, plain_runs_ms=p_runs,
                             kernel_GBps=nbytes / kernel_ms / 1e6, plain_GBps=nbytes / plain_ms / 1e6,
                             bound_ms=bound_ms, bound_by=bound_by, kernel_of_bound=bound_ms / kernel_ms,
                             kernel_device_ms=kernel_dev, kernel_of_bound_device=bound_ms / kernel_dev,
                             kernel_call_less_device_us=(kernel_ms - kernel_dev) * 1e3,
                             copy_ms=copy_ms, copy_GBps=nbytes / copy_ms / 1e6, copy_device_ms=copy_dev,
                             conv2d_ms=conv_ms, conv2d_device_ms=conv_dev, conv2d_vs_kernel_max_abs=conv_err,
                             compute_device_ms=dev_ms, compute_device_GBps=nbytes / dev_ms / 1e6,
                             compute_ms=compute_ms, compute_GBps=nbytes / compute_ms / 1e6,
                             max_abs_err=err)
        phase(6, f"timing-stencil-{n}", card=smi, **st_timings[n])
        del xd
    slices_ms = host_ms(slices4.compute, 5)
    phase(6, "timing-stencil-4096-slices-form", card=smi, compute_ms=slices_ms,
          compute_GBps=2 * 4096 * 4096 * 4 / slices_ms / 1e6)
    del x16, roll16, x4, roll4, slices4, ref4, r4, s4

    # -- phase 7: the multi-statistic kernel against its plain version -------
    gen = torch.Generator(device="cuda").manual_seed(7)
    ms_errs = {}
    ms_paths = {}
    for shape in [(10000, 10000), (1000, 1003), (1, 7), (4097, 33), (1_000_000, 128), (128, 1_000_000),
                  "offset1"]:
        if shape == "offset1":  # a contiguous tensor one element into its storage: scalar loads
            x = torch.randn(1000 * 1024 + 1, generator=gen, device="cuda")[1:].view(1000, 1024)
            check(x.is_contiguous() and x.storage_offset() == 1 and not mstat.vector_ok(x), "offset 1: not scalar")
            shape = (1000, 1024)
            key = "(1000, 1024) at storage offset 1"
        else:
            x = torch.randn(shape, generator=gen, device="cuda")
            key = str(shape)
        ms_paths[key] = "16-byte" if mstat.vector_ok(x) else "scalar"
        got = mstat.multi_stat_cuda(x)
        want = mstat.multi_stat_plain(x)
        torch.cuda.synchronize()
        check([tuple(g.shape) for g in got] == [(shape[1],), (shape[0],), ()], f"{shape}: shapes")
        ms_errs[key] = stats_errors(got, want, x)
        # a shift moves s and ss to the power sums of x - shift
        packed = mstat.multi_stat_packed_cuda(x, x[0, 0])
        d = (x - x[0, 0]).double()
        torch.testing.assert_close(packed[-2].double(), d.sum(), rtol=1e-4, atol=2.0**-20 * float(d.abs().sum()))
        torch.testing.assert_close(packed[-1].double(), (d * d).sum(), rtol=1e-4, atol=0.0)
        again = mstat.multi_stat_cuda(x)
        check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)), f"{key}: two runs differ")
        packed_again = mstat.multi_stat_packed_cuda(x, x[0, 0])
        check(bool(torch.equal(packed, packed_again)), f"{key}: two shifted runs differ")
        del x, d
    check(set(ms_paths.values()) == {"16-byte", "scalar"}, f"mstat load paths {ms_paths}")
    phase(7, "mstat-kernel-vs-plain", max_abs_err=ms_errs, tolerance=STATS_TOLERANCE,
          outputs="colsum, rowmean, std", loads=ms_paths, same_bits_on_two_runs=True)
    mstat_err = max(ms_errs[str((10000, 10000))])

    # -- phase 8: reduction_tree, the reductions path --------------------------
    x_np = np.random.default_rng(8).standard_normal((10000, 10000), dtype=np.float32)
    tree = reduction_tree(x_np, chunk=1000, split_every=4)
    mstat.LAUNCHES = 0
    s_out, m_out, sd_out = da.compute(*tree)
    mstat_launches = mstat.LAUNCHES
    check(mstat_launches > 0, "reduction_tree launched the multi-statistic kernel no time")
    check(s_out.shape == (10000,) and m_out.shape == (10000,) and np.ndim(sd_out) == 0, "tree: shapes")
    check(all(np.asarray(v).dtype == np.float32 for v in (s_out, m_out, sd_out)), "tree: dtypes")
    check(all(bool(np.isfinite(v).all()) for v in (s_out, m_out, sd_out)), "tree: non-finite")
    xd = torch.from_numpy(x_np).cuda()
    ref64 = [x_np.sum(0, dtype=np.float64), x_np.mean(1, dtype=np.float64), x_np.std(dtype=np.float64)]
    tree_err = stats_errors((s_out, m_out, sd_out), ref64, xd)
    # the kernel on the same device tensor against the reductions one at a
    # time (sum and mean as torch reduces, std through its two power sums)
    apart = [a.compute_device() for a in tree]
    kernel_vs_reductions = stats_errors(mstat.multi_stat_cuda(xd), apart, xd)
    phase(8, "reduction_tree", shape=[10000, 10000], chunks=1000, split_every=4, launches=mstat_launches,
          max_abs_err_vs_f64=tree_err, kernel_vs_reductions_max_abs=kernel_vs_reductions,
          tolerance=STATS_TOLERANCE)

    # -- phase 9: normalize_contract ---------------------------------------------
    rng9 = np.random.default_rng(9)
    a_np = (rng9.standard_normal((32768, 4096), dtype=np.float32) * 2 + 1)
    b_np = rng9.standard_normal((2048, 4096), dtype=np.float32)
    nc = normalize_contract(da.from_array(a_np, chunks=(4096, 4096)), da.from_array(b_np, chunks=1024))
    stencil.LAUNCHES = mstat.LAUNCHES = tk.LAUNCHES = 0
    nc_out = nc.compute()
    nc_launches = {"band_stencil": stencil.LAUNCHES, "multi_stat": mstat.LAUNCHES, "transpose": tk.LAUNCHES}
    check(tk.LAUNCHES >= 1, "normalize_contract's b.T did not go through the transpose kernel")
    check(nc_out.shape == (32768,) and nc_out.dtype == np.float32, "normalize_contract: shape/dtype")
    check(bool(np.isfinite(nc_out).all()), "normalize_contract: non-finite")
    mu = a_np.mean(axis=0, dtype=np.float64)
    sd = a_np.std(axis=0, dtype=np.float64)
    yy = ((a_np[:256].astype(np.float64) - mu) / (sd + 1e-6)) @ b_np.astype(np.float64).T
    want_nc = (yy * yy).sum(1)
    np.testing.assert_allclose(nc_out[:256], want_nc, rtol=1e-4)
    phase(9, "normalize_contract", a=[32768, 4096], b=[2048, 4096], a_chunks=[4096, 4096], b_chunks=1024,
          launches=nc_launches, max_rel_err_256_rows=float(np.abs(nc_out[:256] / want_nc - 1).max()),
          tolerance="rtol 1e-4 against float64 numpy")

    # -- phase 10: blocked_matmul ----------------------------------------------------
    rng10 = np.random.default_rng(10)
    ma = rng10.standard_normal((8192, 8192), dtype=np.float32)
    mb = rng10.standard_normal((8192, 8192), dtype=np.float32)
    bm = blocked_matmul(ma, mb, chunk=1024)
    check(bm.chunks == ((1024,) * 8, (512,) * 16), f"blocked_matmul chunks {bm.chunks}")
    bm_dev = bm.compute_device()
    check(bm_dev.dtype == torch.float32 and tuple(bm_dev.shape) == (8192, 8192), "blocked_matmul: shape/dtype")
    mad, mbd = torch.from_numpy(ma).cuda(), torch.from_numpy(mb).cuda()
    want_bm = mad.double() @ mbd.double()
    scale_bm = float((mad.abs() @ mbd.abs()).max())
    torch.testing.assert_close(bm_dev.double(), want_bm, rtol=1e-5, atol=2.0**-20 * scale_bm)
    bm_err = float((bm_dev.double() - want_bm).abs().max())
    del want_bm, bm_dev
    phase(10, "blocked_matmul", size=8192, chunks=[1024, 512], max_abs_err_vs_f64=bm_err,
          tolerance=f"rtol 1e-5, atol 2^-20*max(|a|@|b|) = {2.0**-20 * scale_bm}")

    # -- phase 11: timing of phases 7-10 ------------------------------------------
    # the multi-statistic kernel at the main path's 10000^2 and the two
    # skinny shapes: per call and on the device alone, beside its plain
    # version, torch's trio (the nearest library calls) and a device copy
    gen11 = torch.Generator(device="cuda").manual_seed(11)
    ms_timings = {}
    for M, N in ((10000, 10000), (1_000_000, 128), (128, 1_000_000)):
        xm = xd if (M, N) == tuple(xd.shape) else torch.randn((M, N), generator=gen11, device="cuda")
        kernel_ms, plain_ms, k_runs, p_runs = paired_ms(lambda: mstat.multi_stat_plain(xm),
                                                        lambda: mstat.multi_stat_cuda(xm))
        trio = lambda: (xm.sum(0), xm.sum(1) / N, xm.std(correction=0))  # noqa: E731
        nbytes = (M * N + N + M + 3) * 4
        bound_ms, bound_by = bound(nbytes, 6 * M * N)
        t = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, kernel_runs_ms=k_runs, plain_runs_ms=p_runs,
                 device_ms=device_ms(lambda: mstat.multi_stat_cuda(xm)), trio_ms=cuda_ms(trio),
                 trio_device_ms=device_ms(trio), copy_ms=cuda_ms(lambda: xm.clone()),
                 copy_device_ms=device_ms(lambda: xm.clone()), bound_ms=bound_ms, bound_by=bound_by)
        t.update(kernel_of_bound=bound_ms / kernel_ms, device_of_bound=bound_ms / t["device_ms"],
                 kernel_GBps=nbytes / kernel_ms / 1e6, trio_over_kernel=t["trio_ms"] / kernel_ms,
                 max_abs_err=max(stats_errors(mstat.multi_stat_cuda(xm), mstat.multi_stat_plain(xm), xm)))
        ms_timings[f"{M}x{N}"] = t
        phase(11, f"timing-mstat-{M}x{N}", card=smi, **t)
        del xm
    ms_main = ms_timings["10000x10000"]

    tree_exprs = [a.expr for a in tree]
    tree_dev_ms = host_ms(lambda: (compute_exprs(tree_exprs), torch.cuda.synchronize()), 3)
    tree_ms = host_ms(lambda: da.compute(*tree), 3)
    nc_dev_ms = host_ms(lambda: (nc.compute_device(), torch.cuda.synchronize()), 3)
    nc_ms = host_ms(nc.compute, 3)
    bm_dev_ms = host_ms(lambda: (bm.compute_device(), torch.cuda.synchronize()), 3)
    bm_ms = host_ms(bm.compute, 3)
    flops = 2 * 8192**3
    mm_ms = cuda_ms(lambda: torch.einsum("ij,jk->ik", mad, mbd), reps=10)
    phase(11, "timing-paths", card=smi,
          reduction_tree_compute_ms=tree_ms, reduction_tree_compute_device_ms=tree_dev_ms,
          normalize_contract_compute_ms=nc_ms, normalize_contract_compute_device_ms=nc_dev_ms,
          blocked_matmul_compute_ms=bm_ms, blocked_matmul_compute_device_ms=bm_dev_ms,
          matmul_einsum_ms=mm_ms, matmul_TFLOPs=flops / mm_ms / 1e9,
          blocked_matmul_compute_device_TFLOPs=flops / bm_dev_ms / 1e9)

    del xd, mad, mbd, ma, mb, a_np, b_np, x_np
    torch.cuda.empty_cache()

    # -- phase 12: the transpose kernel against its plain version -------------
    dtypes = [torch.bool, torch.int8, torch.float16, torch.float32, torch.float64, torch.int64,
              torch.complex64, torch.complex128, torch.uint16, torch.uint32, torch.uint64]
    shapes = [(8192, 8192), (16384, 16384), (32768, 4096), (1000, 1003), (1, 7), (4097, 33), (3, 513, 257)]
    checked = 0
    for seed, dt in enumerate(dtypes):
        for shape in shapes:
            x = random_bytes(shape, dt, seed)
            check_transpose(tk, x, f"{tuple(shape)} {dt}")
            checked += 1
            del x
        base = random_bytes((3000, 2048), dt, seed + 100)
        for name, view in (("row-sliced", base[500:2500]), ("column-sliced", base[:, 300:1700])):
            check_transpose(tk, view, f"{name} view {dt}")
            checked += 1
        del base
        torch.cuda.empty_cache()
    phase(12, "transpose-kernel-vs-plain", cases=checked, shapes=[list(sh) for sh in shapes],
          views=["x[500:2500] of (3000, 2048)", "x[:, 300:1700] of (3000, 2048)"],
          dtypes=[str(d).replace("torch.", "") for d in dtypes], tolerance="equal bytes")

    # -- phase 13: rechunk_relayout, the transpose main path -------------------
    x_np = np.random.default_rng(13).standard_normal((8192, 8192), dtype=np.float32)
    want_bits = x_np.view(np.uint32).T
    rel = rechunk_relayout(x_np, chunk=1024)
    check(rel.chunks == ((1024,) * 8, (8192,)), f"rechunk_relayout chunks {rel.chunks}")
    tk.LAUNCHES = 0
    rel_out = rel.compute()
    transpose_launches = tk.LAUNCHES
    check(transpose_launches >= 1, "rechunk_relayout launched the transpose kernel no time")
    check(rel_out.shape == (8192, 8192) and rel_out.dtype == np.float32, "relayout: shape/dtype")
    check(bool(np.array_equal(rel_out.view(np.uint32), want_bits)), "relayout: bytes differ from x.T")
    relp = rechunk_relayout(x_np, chunk=1024, persist=True)
    tk.LAUNCHES = 0
    relp_dev = relp.compute_device()
    persist_launches = tk.LAUNCHES
    check(persist_launches >= 1, "the persist form launched the transpose kernel no time")
    check(relp_dev.is_cuda and relp_dev.is_contiguous(), "persist form: not a contiguous tensor on the card")
    check(bool(np.array_equal(relp_dev.cpu().numpy().view(np.uint32), want_bits)),
          "persist form: bytes differ from x.T")
    del rel_out, relp_dev, want_bits
    phase(13, "rechunk_relayout", shape=[8192, 8192], chunks=1024, launches=transpose_launches,
          persist_launches=persist_launches, tolerance="equal bytes")

    # -- phase 14: the slice's other ops against numpy --------------------------
    x4_np = np.random.default_rng(14).standard_normal((4096, 4096), dtype=np.float32)
    d4 = da.from_array(x4_np, chunks=1024)
    q = 2048
    exact = {
        "reshape": (d4.reshape(2048, 8192), x4_np.reshape(2048, 8192)),
        "reshape_of_T": (d4.T.reshape(-1, 2048), x4_np.T.reshape(-1, 2048)),
        "ravel": (d4.ravel(), x4_np.ravel()),
        "concatenate": (da.concatenate([d4, d4[:1000]], axis=0), np.concatenate([x4_np, x4_np[:1000]])),
        "stack": (da.stack([d4, -d4], axis=1), np.stack([x4_np, -x4_np], axis=1)),
        "block": (da.block([[d4[q:, q:], d4[q:, :q]], [d4[:q, q:], d4[:q, :q]]]),
                  np.block([[x4_np[q:, q:], x4_np[q:, :q]], [x4_np[:q, q:], x4_np[:q, :q]]])),
        "roll": (da.roll(d4, (100, -37), axis=(0, 1)), np.roll(x4_np, (100, -37), axis=(0, 1))),
        "flip": (da.flip(d4), np.flip(x4_np)),
        "flipud": (da.flipud(d4), np.flipud(x4_np)),
        "fliplr": (da.fliplr(d4), np.fliplr(x4_np)),
        "rot90": (da.rot90(d4), np.rot90(x4_np)),
        "squeeze": (da.squeeze(da.expand_dims(d4, 0)), x4_np),
        "expand_dims": (da.expand_dims(d4, 1), np.expand_dims(x4_np, 1)),
        "broadcast_to": (da.broadcast_to(d4[:1], (4096, 4096)), np.broadcast_to(x4_np[:1], (4096, 4096))),
    }
    tk.LAUNCHES = 0
    for name, (arr, want) in exact.items():
        got = arr.compute()
        check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype")
        check(bool(np.array_equal(got, want)), f"{name}: values differ from numpy")
    ops_launches = {"transpose": tk.LAUNCHES}
    x4_64 = x4_np.astype(np.float64)
    vd = float(da.vdot(d4, d4).compute())
    vd_want = float(np.vdot(x4_64, x4_64))
    check(abs(vd - vd_want) <= 1e-5 * vd_want, f"vdot {vd} against {vd_want}")
    outer = da.outer(d4[0], d4[:, 1]).compute()
    outer_want = np.outer(x4_np[0], x4_np[:, 1])  # float32 products, one rounding each
    np.testing.assert_allclose(outer, outer_want, rtol=2.0**-22, atol=0)
    cs = da.cumsum(d4).compute()
    cs_want = np.cumsum(x4_64.ravel())
    cs_atol = 2.0**-20 * float(np.abs(x4_64).sum())
    check(cs.shape == (4096 * 4096,) and cs.dtype == np.float32, "cumsum: shape/dtype")
    np.testing.assert_allclose(cs, cs_want, rtol=0, atol=cs_atol)
    phase(14, "shape-ops-4096", exact=sorted(exact), launches=ops_launches,
          vdot_rel_err=abs(vd - vd_want) / vd_want, outer_max_abs_err=float(np.abs(outer - outer_want).max()),
          cumsum_max_abs_err=float(np.abs(cs - cs_want).max()), cumsum_atol=cs_atol,
          tolerance={"layout ops": "equal", "vdot": "rtol 1e-5 vs float64",
                     "outer": "rtol 2^-22 vs float32 numpy", "cumsum(axis=None)": "atol 2^-20*sum|x| vs float64"})
    del exact, outer, outer_want, cs, cs_want, x4_64

    # -- phase 15: transpose timing ----------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(15)
    tr_timings = {}
    for n in (8192, 16384):
        xt = torch.randn((n, n), generator=gen, device="cuda")
        nbytes = 2 * n * n * xt.element_size()
        kernel_ms, plain_ms, k_runs, p_runs = paired_ms(
            lambda: tk.transpose_last2_plain(xt), lambda: tk.transpose_last2_cuda(xt))
        lib_ms = cuda_ms(lambda: xt.mT.contiguous())
        copy_ms = cuda_ms(lambda: xt.clone())
        err = float((tk.transpose_last2_cuda(xt) - tk.transpose_last2_plain(xt)).abs().max())
        bound_ms, bound_by = bound(nbytes, 0)
        tr_timings[n] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, kernel_runs_ms=k_runs, plain_runs_ms=p_runs,
                             kernel_GBps=nbytes / kernel_ms / 1e6, plain_GBps=nbytes / plain_ms / 1e6,
                             mT_contiguous_ms=lib_ms, mT_contiguous_GBps=nbytes / lib_ms / 1e6,
                             copy_ms=copy_ms, copy_GBps=nbytes / copy_ms / 1e6,
                             bound_ms=bound_ms, bound_by=bound_by, kernel_of_bound=bound_ms / kernel_ms,
                             max_abs_err=err)
        phase(15, f"timing-transpose-{n}", card=smi, **tr_timings[n])
        del xt
    nbytes = 2 * 8192 * 8192 * 4
    rel_ms = host_ms(rel.compute, 3)
    rel_dev_ms = host_ms(lambda: (rel.compute_device(), torch.cuda.synchronize()), 3)
    relp_dev_ms = host_ms(lambda: (relp.compute_device(), torch.cuda.synchronize()), 10)
    phase(15, "timing-rechunk_relayout-8192", card=smi, compute_ms=rel_ms, compute_GBps=nbytes / rel_ms / 1e6,
          compute_device_ms=rel_dev_ms, persist_compute_device_ms=relp_dev_ms,
          persist_compute_device_GBps=nbytes / relp_dev_ms / 1e6)

    del rel, relp
    torch.cuda.empty_cache()

    # -- phase 16: the halo kernel against its plain version --------------------
    big = [((16384, 16384), ((1, 1), (1, 1)), (m, m)) for m in ("symmetric", "reflect", "edge", "wrap", 0.0)]
    big.append(((4096, 4096), ((8, 8), (8, 8)), ("symmetric", "symmetric")))
    small = [
        ((1000, 1003), ((3, 0), (0, 5)), ("symmetric", "wrap")),
        ((1 << 24,), ((5, 3),), ("reflect",)),
        ((64, 513, 257), ((1, 1), (2, 2), (3, 3)), ("edge", "symmetric", "wrap")),
        ((3, 40), ((7, 7), (0, 0)), ("wrap", "edge")),
        ((3, 40), ((7, 7), (1, 1)), ("symmetric", "edge")),
        ((40, 3), ((2, 2), (7, 7)), ("edge", "reflect")),
        ((300, 200), ((2, 3), (4, 1)), ((1.5, -2.0), "edge")),
        ((300, 200), ((2, 3), (4, 1)), ("wrap", (7.0, 3.0))),
        ((300, 200), ((2, 3), (4, 1)), ((1.0, -1.0), (7.0, 3.0))),
    ]
    halo_cases = 0
    for i, (shape, widths, modes) in enumerate(big):
        x = random_bytes(shape, torch.float32, 1600 + i)
        check_halo(halo, x, widths, modes, f"{shape} {modes}")
        halo_cases += 1
        del x
    for seed, dt in enumerate(dtypes):
        for i, (shape, widths, modes) in enumerate(small):
            x = random_bytes(shape, dt, 1700 + 10 * seed + i)
            check_halo(halo, x, widths, modes, f"{shape} {modes} {dt}")
            halo_cases += 1
            del x
        base = random_bytes((3000, 2048), dt, 1800 + seed)
        for name, view in (("row-sliced", base[500:2500]), ("column-sliced", base[:, 300:1700])):
            check_halo(halo, view, ((2, 1), (3, 3)), ("symmetric", (1.0, 2.0)), f"{name} view {dt}")
            halo_cases += 1
        del base
        torch.cuda.empty_cache()
    # the row kernel against the strided kernel on the same values: lo of 0-4
    # on the last axis in every mode and element size (1, 2, 4, 8, 16 bytes),
    # a contiguous input, its copy laid out column-major (last stride 257:
    # the strided kernel), and a view one element into its rows (the row
    # kernel realigning its source)
    kernel_paths = {}
    for seed, dt in enumerate(dtypes):
        base = random_bytes((257, 1001), dt, 1900 + seed)
        views = {"contiguous": base, "column_major": base.mT.contiguous().mT,
                 "offset_1": random_bytes((257, 1003), dt, 1950 + seed)[:, 1:1002]}
        for lo in range(5):
            for mode in ("symmetric", "reflect", "edge", "wrap", (0.5, -1.0)):
                widths, modes = ((1, 2), (lo, 3)), ("edge", mode)
                outs = {}
                for name, view in views.items():
                    kernel_paths.setdefault(name, set()).add(halo.kernel_for(view, widths, modes))
                    check_halo(halo, view, widths, modes, f"{name} lo={lo} {mode} {dt}")
                    outs[name] = halo.halo_pad_cuda(view, widths, modes)
                    halo_cases += 1
                check(bool(torch.equal(outs["contiguous"].view(torch.uint8), outs["column_major"].view(torch.uint8))),
                      f"row and strided kernels differ: lo={lo} {mode} {dt}")
        del base, views, outs
    check(kernel_paths == {"contiguous": {"rows"}, "column_major": {"strided"}, "offset_1": {"rows"}},
          f"halo kernel paths {kernel_paths}")
    phase(16, "halo-kernel-vs-plain", cases=halo_cases,
          float32_cases=[[list(sh), list(w), list(m)] for sh, w, m in big],
          every_dtype_cases=[[list(sh), list(w), list(m)] for sh, w, m in small],
          views=["x[500:2500] of (3000, 2048)", "x[:, 300:1700] of (3000, 2048)"],
          row_vs_strided="(257, 1001) widths ((1, 2), (lo, 3)), lo 0-4, five modes: contiguous and offset-1 views "
                         "(row kernel), column-major copy (strided kernel)",
          kernel_paths={k: sorted(v) for k, v in kernel_paths.items()},
          dtypes=[str(d).replace("torch.", "") for d in dtypes], tolerance="equal bytes")

    # -- phase 17: stencil2d's slices form, the general halo path ----------------
    gen_paths = {}
    halo_launches = None
    for n, chunk, seed in ((16384, 4096, 17), (4096, 1024, 18)):
        x_np = np.random.default_rng(seed).standard_normal((n, n), dtype=np.float32)
        arr = stencil2d(x_np, chunk=chunk, form="slices")
        check(not isinstance(arr.expr, BandStencil), "slices form routed to BandStencil")
        halo.LAUNCHES = stencil.LAUNCHES = 0
        res = arr.compute()
        launches = {"halo": halo.LAUNCHES, "band_stencil": stencil.LAUNCHES}
        check(launches == {"halo": 1, "band_stencil": 0}, f"slices form at {n}: launches {launches}")
        if n == 16384:
            halo_launches = halo.LAUNCHES
        check(res.shape == (n, n) and res.dtype == np.float32, f"slices {n}: shape/dtype")
        check(bool(np.isfinite(res).all()), f"slices {n}: non-finite values")
        ref = numpy_laplace(x_np)
        atol = 8 * float(np.abs(x_np).max()) * 2.0**-21
        np.testing.assert_allclose(res, ref, rtol=1e-5, atol=atol)
        gen_paths[f"slices_{n}"] = (arr, x_np, dict(launches=launches, max_abs_err=float(np.abs(res - ref).max()),
                                                    atol=atol))
        del res, ref
        phase(17, f"stencil2d-slices-{n}", chunks=chunk, **gen_paths[f"slices_{n}"][2])

    # -- phase 18: a func the band kernel cannot read ------------------------------
    x4_np = gen_paths["slices_4096"][1]
    nonlin = da.map_overlap(lambda b: torch.tanh(laplace_roll(b)), da.from_array(x4_np, chunks=1024),
                            depth=1, boundary="reflect")
    check(not isinstance(nonlin.expr, BandStencil), "tanh(laplace) routed to BandStencil")
    halo.LAUNCHES = stencil.LAUNCHES = 0
    res = nonlin.compute()
    nl_launches = {"halo": halo.LAUNCHES, "band_stencil": stencil.LAUNCHES}
    check(nl_launches == {"halo": 1, "band_stencil": 0}, f"tanh(laplace): launches {nl_launches}")
    ref = np.tanh(numpy_laplace(x4_np))
    np.testing.assert_allclose(res, ref, rtol=1e-5, atol=1e-6)
    phase(18, "map_overlap-tanh-laplace-4096", chunks=1024, launches=nl_launches,
          max_abs_err=float(np.abs(res - ref).max()), tolerance="rtol 1e-5, atol 1e-6 vs float64 numpy")
    del res, ref

    # -- phase 19: da.pad against np.pad -------------------------------------------
    d4 = da.from_array(x4_np, chunks=1024)
    pw = ((3, 5), (7, 2))
    halo.LAUNCHES = 0
    for mode in ("constant", "edge", "reflect", "symmetric", "wrap"):
        got = da.pad(d4, pw, mode=mode).compute()
        check(bool(np.array_equal(got, np.pad(x4_np, pw, mode=mode))), f"pad {mode}: values differ from np.pad")
    pad_launches = halo.LAUNCHES
    check(pad_launches == 5, f"pad launched the halo kernel {pad_launches} times in five modes")
    pad_errs = {}
    for mode, kw in (("linear_ramp", {"end_values": 2.0}), ("mean", {"stat_length": 16})):
        got = da.pad(d4, pw, mode=mode, **kw).compute()
        want = np.pad(x4_np, pw, mode=mode, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        pad_errs[mode] = float(np.abs(got - want).max())
    phase(19, "pad-4096", pad_width=[list(p) for p in pw], halo_launches=pad_launches, max_abs_err=pad_errs,
          tolerance={"index-map and constant modes": "equal", "linear_ramp, mean": "rtol 1e-5, atol 1e-6"})
    del got, want, d4

    # -- phase 20: sliding windows, move_* and push ----------------------------------
    rng20 = np.random.default_rng(20)
    v = rng20.standard_normal(1 << 24).astype(np.float32)
    v[rng20.random(1 << 24) < 0.002] = np.nan
    dv = da.from_array(v, chunks=1 << 22)
    w = 64
    win_sum = da.sliding_window_view(dv, w).sum(-1)
    check("SlidingWindowReduce" in win_sum.expr.simplify().tree_repr(), "window sum did not fuse")
    got = win_sum.compute()
    v64 = v.astype(np.float64)
    c = np.concatenate([[0.0], np.cumsum(np.nan_to_num(v64))])
    nan_c = np.concatenate([[0], np.cumsum(np.isnan(v))])
    want = np.where(nan_c[w:] - nan_c[:-w] > 0, np.nan, c[w:] - c[:-w])
    atol20 = w * float(np.nanmax(np.abs(v))) * 2.0**-22
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol20, equal_nan=True)
    errs20 = {"window_sum": float(np.nanmax(np.abs(got - want)))}
    mm = move_mean(dv, w, min_count=1).compute()
    ms = move_std(dv, w, min_count=2).compute()
    # references on every 4099th window (numpy in float64 over the trailing
    # windows, bottleneck's semantics)
    idx = np.arange(0, 1 << 24, 4099)
    wins = [v64[max(0, i - w + 1):i + 1] for i in idx]
    cnt = np.array([np.count_nonzero(~np.isnan(x)) for x in wins])
    with np.errstate(all="ignore"):
        want_m = np.array([np.nanmean(x) if k >= 1 else np.nan for x, k in zip(wins, cnt)])
        want_s = np.array([np.nanstd(x) if k >= 2 else np.nan for x, k in zip(wins, cnt)])
    np.testing.assert_allclose(mm[idx], want_m, rtol=1e-5, atol=atol20 / w, equal_nan=True)
    np.testing.assert_allclose(ms[idx], want_s, rtol=1e-4, equal_nan=True)
    errs20["move_mean"] = float(np.nanmax(np.abs(mm[idx] - want_m)))
    errs20["move_std"] = float(np.nanmax(np.abs(ms[idx] - want_s)))
    pushed = da.push(dv, 3).compute()
    last = np.maximum.accumulate(np.where(np.isnan(v), -1, np.arange(1 << 24)))
    pos = np.arange(1 << 24)
    want_p = np.where((last < 0) | (pos - last > 3), np.nan, v[np.maximum(last, 0)])
    check(bool(np.array_equal(pushed, want_p, equal_nan=True)), "push differs from numpy")
    phase(20, "sliding-move-push", size=1 << 24, window=w, nan_fraction=float(np.isnan(v).mean()),
          max_abs_err=errs20, tolerance={"window sum": f"rtol 1e-5, atol w*max|x|*2^-22 = {atol20}",
                                         "move_mean": "rtol 1e-5, atol max|x|*2^-22", "move_std": "rtol 1e-4",
                                         "push": "equal"})
    del v, v64, dv, got, want, mm, ms, pushed, c, nan_c, last, pos, want_p

    # -- phase 21: halo timing and the general halo path's compute() ----------------
    xh = torch.from_numpy(gen_paths["slices_16384"][1]).cuda()
    n = xh.shape[0]
    d1 = ((1, 1), (1, 1))
    sym = ("symmetric", "symmetric")
    halo_bytes = (n * n + (n + 2) * (n + 2)) * xh.element_size()
    kernel_ms, plain_ms, k_runs, p_runs = paired_ms(lambda: halo.halo_pad_plain(xh, d1, sym),
                                                    lambda: halo.halo_pad_cuda(xh, d1, sym))
    x4d = xh[None, None]
    F = torch.nn.functional
    beside = {}
    for mode, fmode, fkw in (("reflect", "reflect", {}), ("edge", "replicate", {}), ("wrap", "circular", {}),
                             (0.0, "constant", {"value": 0.0})):
        k_ms = cuda_ms(lambda: halo.halo_pad_cuda(xh, d1, (mode, mode)))
        f_ms = cuda_ms(lambda: F.pad(x4d, (1, 1, 1, 1), mode=fmode, **fkw))
        k_dev = device_ms(lambda: halo.halo_pad_cuda(xh, d1, (mode, mode)))
        f_dev = device_ms(lambda: F.pad(x4d, (1, 1, 1, 1), mode=fmode, **fkw))
        same = bool(torch.equal(halo.halo_pad_cuda(xh, d1, (mode, mode)), F.pad(x4d, (1, 1, 1, 1), mode=fmode, **fkw)[0, 0]))
        check(same, f"F.pad {fmode} is not the kernel's {mode}")
        beside[str(mode)] = {"kernel_ms": k_ms, f"F_pad_{fmode}_ms": f_ms, "kernel_device_ms": k_dev,
                             f"F_pad_{fmode}_device_ms": f_dev}
    # at depth 1, dask's "reflect" (numpy symmetric) repeats the edge element,
    # which is numpy's edge: F.pad's replicate computes the main path's function
    check(bool(torch.equal(halo.halo_pad_cuda(xh, d1, sym), F.pad(x4d, (1, 1, 1, 1), mode="replicate")[0, 0])),
          "F.pad replicate is not dask's reflect at depth 1")
    library_ms = cuda_ms(lambda: F.pad(x4d, (1, 1, 1, 1), mode="replicate"))
    library_dev = device_ms(lambda: F.pad(x4d, (1, 1, 1, 1), mode="replicate"))
    halo_dev = device_ms(lambda: halo.halo_pad_cuda(xh, d1, sym))
    copy_ms = cuda_ms(lambda: xh.clone())
    copy_dev = device_ms(lambda: xh.clone())
    halo_err = float((halo.halo_pad_cuda(xh, d1, sym) - halo.halo_pad_plain(xh, d1, sym)).abs().max())
    halo_bound_ms, halo_bound_by = bound(halo_bytes, 0)
    # the host's share of a call at 4096^2: per call less on the device
    x4h = torch.from_numpy(gen_paths["slices_4096"][1]).cuda()
    h4_ms = cuda_ms(lambda: halo.halo_pad_cuda(x4h, d1, sym))
    h4_dev = device_ms(lambda: halo.halo_pad_cuda(x4h, d1, sym))
    del x4h
    phase(21, "timing-halo-16384", card=smi, kernel_ms=kernel_ms, plain_ms=plain_ms, kernel_runs_ms=k_runs,
          plain_runs_ms=p_runs, kernel_GBps=halo_bytes / kernel_ms / 1e6, plain_GBps=halo_bytes / plain_ms / 1e6,
          bound_ms=halo_bound_ms, bound_by=halo_bound_by, kernel_of_bound=halo_bound_ms / kernel_ms,
          kernel_device_ms=halo_dev, kernel_of_bound_device=halo_bound_ms / halo_dev,
          copy_ms=copy_ms, copy_device_ms=copy_dev, copy_GBps=2 * n * n * 4 / copy_ms / 1e6, beside_F_pad=beside,
          max_abs_err=halo_err, library_ms=library_ms, library_device_ms=library_dev,
          library_note="F.pad replicate, equal to dask's reflect at depth 1; F.pad reflect is numpy's reflect",
          at_4096={"kernel_ms": h4_ms, "kernel_device_ms": h4_dev, "kernel_call_less_device_us": (h4_ms - h4_dev) * 1e3})
    del xh, x4d
    torch.cuda.empty_cache()
    path_ms = {}
    for key, reps in (("slices_16384", 3), ("slices_4096", 5)):
        arr = gen_paths[key][0]
        path_ms[f"{key}_compute_ms"] = host_ms(arr.compute, reps)
        path_ms[f"{key}_compute_device_ms"] = host_ms(lambda: (arr.compute_device(), torch.cuda.synchronize()), reps)
    path_ms["tanh_laplace_4096_compute_ms"] = host_ms(nonlin.compute, 5)
    path_ms["tanh_laplace_4096_compute_device_ms"] = host_ms(
        lambda: (nonlin.compute_device(), torch.cuda.synchronize()), 5)
    phase(21, "timing-general-halo-paths", card=smi, **path_ms)

    del gen_paths, nonlin
    torch.cuda.empty_cache()

    # -- phase 22: the scale kernel against its plain version ------------------------
    gen = torch.Generator(device="cuda").manual_seed(22)
    scale_dtypes = [torch.float16, torch.bfloat16, torch.float32, torch.float64]
    scale_cases = 0
    for dt in scale_dtypes:
        shapes22 = [(256, 256), (128, 128), (1000, 1003), (4097, 33), (1, 128)]
        if dt == torch.float32:
            shapes22.append((1_000_000, 128))
        for shape in shapes22:
            x = (torch.randn(shape, generator=gen, device="cuda") * 100).to(dt)
            x.view(-1)[::997] = float("nan")
            x.view(-1)[1::1009] = float("inf")
            rows, cols = shape
            for form, s in (("scalar", 2.0), ("scalar", torch.randn((), generator=gen, device="cuda").to(dt)),
                            ("row", torch.randn((1, cols), generator=gen, device="cuda").to(dt)),
                            ("column", torch.randn((rows, 1), generator=gen, device="cuda").to(dt))):
                check(same_values(sk.scale_cuda(x, s), sk.scale_plain(x, s)), f"scale {form} {shape} {dt}")
                scale_cases += 1
            del x
        base = torch.randn((100_000, 256), generator=gen, device="cuda").to(dt)
        view = base[:, :128]
        for s in (0.5, torch.randn((1, 128), generator=gen, device="cuda").to(dt),
                  torch.randn((100_000, 1), generator=gen, device="cuda").to(dt)):
            check(same_values(sk.scale_cuda(view, s), sk.scale_plain(view, s)), f"scale u[:, :128] view {dt}")
            scale_cases += 1
        del base, view
        # a 1-D array, its unaligned tail view, and narrow last axes
        flat = (torch.randn((1 << 24,), generator=gen, device="cuda") * 100).to(dt)
        for x, s in ((flat, 2.0), (flat, torch.randn((1 << 24,), generator=gen, device="cuda").to(dt)[:1]),
                     (flat[1:], 0.5)):
            check(same_values(sk.scale_cuda(x, s), sk.scale_plain(x, s)), f"scale 1-D {tuple(x.shape)} {dt}")
            scale_cases += 1
        del flat
        for cols in (1, 3):
            x = (torch.randn((10_000_000, cols), generator=gen, device="cuda") * 100).to(dt)
            for s in (2.0, torch.randn((1, cols), generator=gen, device="cuda").to(dt),
                      torch.randn((10_000_000, 1), generator=gen, device="cuda").to(dt)):
                check(same_values(sk.scale_cuda(x, s), sk.scale_plain(x, s)), f"scale (1e7, {cols}) {dt}")
                scale_cases += 1
            del x
    torch.cuda.synchronize()
    phase(22, "scale-kernel-vs-plain", cases=scale_cases, dtypes=[str(d).replace("torch.", "") for d in scale_dtypes],
          forms=["scalar", "row", "column"],
          shapes=[[256, 256], [128, 128], [1000, 1003], [4097, 33], [1, 128], [1000000, 128], [1 << 24],
                  [10_000_000, 1], [10_000_000, 3]],
          views=["x[:, :128] of (100000, 256)", "x[1:] of (1 << 24,)"], tolerance="equal bytes, a NaN matching any NaN")

    # -- phase 23: tall_skinny_svd and the other decompositions ------------------------
    m23, n23 = 1_000_000, 128
    x23 = np.random.default_rng(23).standard_normal((m23, n23), dtype=np.float32)
    ts = tall_skinny_svd(x23, chunk_rows=100_000)
    sk.LAUNCHES = 0
    factorizations = linalg_decomp.FACTORIZATIONS
    u23, s23, vh23 = da.compute(*ts)
    scale_launches = sk.LAUNCHES
    ts_factorizations = linalg_decomp.FACTORIZATIONS - factorizations
    check(scale_launches == 3, f"tall_skinny_svd launched the scale kernel {scale_launches} times, not 3")
    check(ts_factorizations == 1, f"tall_skinny_svd factored {ts_factorizations} times in one compute")
    check(u23.shape == (m23, n23) and s23.shape == (n23,) and vh23.shape == (n23, n23), "svd: shapes")
    check(all(a.dtype == np.float32 for a in (u23, s23, vh23)), "svd: dtypes")
    check(all(bool(np.isfinite(a).all()) for a in (u23, s23, vh23)), "svd: non-finite values")
    s64 = np.linalg.svd(x23.astype(np.float64), compute_uv=False)
    s_err = float(np.abs(s23 - s64).max() / s64.max())
    xd = torch.from_numpy(x23).cuda().double()
    ud = torch.from_numpy(u23).cuda().double()
    recon = float(torch.linalg.matrix_norm((ud * torch.from_numpy(s23).cuda().double())
                                           @ torch.from_numpy(vh23).cuda().double() - xd)
                  / torch.linalg.matrix_norm(xd))
    orth = float((ud.mT @ ud - torch.eye(n23, device="cuda", dtype=torch.float64)).abs().max())
    del ud
    svd_tol = 1e-4
    check(s_err < svd_tol, f"svd: s relative error {s_err}")
    check(recon < svd_tol, f"svd: reconstruction {recon}")
    check(orth < svd_tol, f"svd: orthogonality {orth}")
    check(bool((vh23.astype(np.float64).sum(axis=1) >= 0).all()), "svd: a row of vh sums below 0")
    phase(23, "tall_skinny_svd", shape=[m23, n23], chunk_rows=100_000, scale_launches=scale_launches,
          factorizations=ts_factorizations, s_max_rel_err=s_err, reconstruction_rel=recon, orthogonality_max=orth,
          tolerance=f"each < {svd_tol} (float32; s against float64 numpy, relative to s_max)")

    # qr (TSQR), lstsq and norm(ord=2) on 100000x128 float32
    xm = x23[:100_000]
    dm = da.from_array(xm, chunks=(10_000, n23))
    q, r = da.compute(*da.linalg.qr(dm))
    qd, rd = torch.from_numpy(q).cuda().double(), torch.from_numpy(r).cuda().double()
    xmd = xd[:100_000]
    qr_recon = float(torch.linalg.matrix_norm(qd @ rd - xmd) / torch.linalg.matrix_norm(xmd))
    qr_orth = float((qd.mT @ qd - torch.eye(n23, device="cuda", dtype=torch.float64)).abs().max())
    check(qr_recon < svd_tol and qr_orth < svd_tol and bool((np.tril(r, -1) == 0).all()),
          f"qr: reconstruction {qr_recon}, orthogonality {qr_orth}")
    del qd, rd, xd, xmd
    bm_np = np.random.default_rng(231).standard_normal(100_000).astype(np.float32)
    lx, lres, lrank, lsv = da.compute(*da.linalg.lstsq(dm, da.from_array(bm_np, chunks=10_000)))
    nx, nres, nrank, nsv = np.linalg.lstsq(xm, bm_np, rcond=None)
    check(int(lrank) == int(nrank) == n23, f"lstsq rank {lrank} against {nrank}")
    np.testing.assert_allclose(lx, nx, rtol=1e-5, atol=1e-5 * float(np.abs(nx).max()))
    np.testing.assert_allclose(lres, nres, rtol=1e-5)
    np.testing.assert_allclose(lsv, nsv, rtol=1e-5)
    nrm = float(da.linalg.norm(dm, ord=2).compute())
    nrm_want = float(nsv.max())
    check(abs(nrm - nrm_want) <= 1e-4 * nrm_want, f"norm(ord=2) {nrm} against {nrm_want}")
    # lu, solve, cholesky and inv of 4096^2 float64 in 1024^2 blocks
    rng23 = np.random.default_rng(232)
    a_np = rng23.standard_normal((4096, 4096))
    b_np = rng23.standard_normal(4096)
    da_ = da.from_array(a_np, chunks=1024)
    p_, l_, u_ = da.compute(*da.linalg.lu(da_))
    ad = torch.from_numpy(a_np).cuda()
    pd, ld_, udd = (torch.from_numpy(v).cuda() for v in (p_, l_, u_))
    lu_recon = float(torch.linalg.matrix_norm(pd @ ld_ @ udd - ad) / torch.linalg.matrix_norm(ad))
    blocks_ok = all(
        bool(((p_[i:i + 1024, j:j + 1024] != 0).sum() == (1024 if i == j else 0)))
        for i in range(0, 4096, 1024) for j in range(0, 4096, 1024)
    ) and bool(np.isin(p_, (0.0, 1.0)).all()) and bool((p_.sum(0) == 1).all() and (p_.sum(1) == 1).all())
    check(blocks_ok, "lu: P is not a block-diagonal permutation")
    check(lu_recon < 1e-10, f"lu: reconstruction {lu_recon}")
    del pd, ld_, udd
    xs = da.linalg.solve(da_, da.from_array(b_np, chunks=1024)).compute()
    solve_res = float(np.linalg.norm(a_np @ xs - b_np) / (np.linalg.norm(a_np) * np.linalg.norm(xs)))
    check(solve_res < 1e-12, f"solve: residual {solve_res}")
    spd_np = (ad @ ad.mT / 4096 + torch.eye(4096, device="cuda", dtype=torch.float64)).cpu().numpy()
    dspd = da.from_array(spd_np, chunks=1024)
    ch = da.linalg.cholesky(dspd, lower=True).compute()
    chd, sd_ = torch.from_numpy(ch).cuda(), torch.from_numpy(spd_np).cuda()
    chol_recon = float(torch.linalg.matrix_norm(chd @ chd.mT - sd_) / torch.linalg.matrix_norm(sd_))
    check(chol_recon < 1e-12 and bool((np.triu(ch, 1) == 0).all()), f"cholesky: reconstruction {chol_recon}")
    iv = torch.from_numpy(da.linalg.inv(dspd).compute()).cuda()
    inv_err = float((sd_ @ iv - torch.eye(4096, device="cuda", dtype=torch.float64)).abs().max())
    check(inv_err < 1e-10, f"inv: |A inv(A) - I| {inv_err}")
    del chd, sd_, iv, ad
    phase(23, "decompositions", qr_shape=[100_000, n23], qr_reconstruction_rel=qr_recon, qr_orthogonality_max=qr_orth,
          lstsq_rank=int(lrank), lstsq_x_max_abs_err=float(np.abs(lx - nx).max()),
          norm2_rel_err=abs(nrm - nrm_want) / nrm_want, lu_shape=[4096, 4096], lu_blocks=1024,
          lu_reconstruction_rel=lu_recon, solve_rel_residual=solve_res, cholesky_reconstruction_rel=chol_recon,
          inv_max_err=inv_err,
          tolerance={"qr (float32)": f"< {svd_tol}", "lstsq (float32 in, float64 inside)": "rtol 1e-5 vs numpy",
                     "norm(ord=2)": "rtol 1e-4", "lu": "1e-10, P block-diagonal", "solve": "|Ax-b|/(|A|_F |x|) < 1e-12",
                     "cholesky": "1e-12", "inv": "1e-10"})
    del a_np, spd_np, p_, l_, u_, ch, xm, dm, q, r
    torch.cuda.empty_cache()

    # -- phase 24: timing of the scale kernel and the decompositions ---------------
    xs_d = torch.from_numpy(x23).cuda()
    row = torch.randn((1, n23), generator=gen, device="cuda")
    kernel_ms24, plain_ms24, k_runs24, p_runs24 = paired_ms(lambda: sk.scale_plain(xs_d, row),
                                                            lambda: sk.scale_cuda(xs_d, row))
    mul_ms = cuda_ms(lambda: torch.mul(xs_d, row))
    kernel_dev24, mul_dev24 = device_ms(lambda: sk.scale_cuda(xs_d, row)), device_ms(lambda: torch.mul(xs_d, row))
    scale_err = float((sk.scale_cuda(xs_d, row) - sk.scale_plain(xs_d, row)).abs().max())
    scale_bytes = (2 * m23 * n23 + n23) * 4
    scale_bound_ms, scale_bound_by = bound(scale_bytes, m23 * n23)
    phase(24, "timing-scale-1e6x128", card=smi, kernel_ms=kernel_ms24, plain_ms=plain_ms24, kernel_runs_ms=k_runs24,
          plain_runs_ms=p_runs24, torch_mul_ms=mul_ms, kernel_GBps=scale_bytes / kernel_ms24 / 1e6,
          torch_mul_GBps=scale_bytes / mul_ms / 1e6, bound_ms=scale_bound_ms, bound_by=scale_bound_by,
          kernel_of_bound=scale_bound_ms / kernel_ms24, max_abs_err=scale_err, kernel_device_ms=kernel_dev24,
          torch_mul_device_ms=mul_dev24)
    del row
    # the shapes where a flat walk matters: a 1-D array and narrow last axes
    beside_mul = {}
    for label, shape, s in (("1d_16777216_by_2.0", (1 << 24,), 2.0),
                            ("10000000x1_by_scalar", (10_000_000, 1), 0.5),
                            ("10000000x3_by_scalar", (10_000_000, 3), 0.5),
                            ("10000000x3_by_row", (10_000_000, 3), torch.randn((1, 3), generator=gen, device="cuda"))):
        xn = torch.randn(shape, generator=gen, device="cuda")
        k_ms, p_ms, _, _ = paired_ms(lambda: sk.scale_plain(xn, s), lambda: sk.scale_cuda(xn, s))
        m_ms = cuda_ms(lambda: torch.mul(xn, s))
        # the device alone, the host's launch time hidden behind a spin
        k_dev, m_dev = device_ms(lambda: sk.scale_cuda(xn, s)), device_ms(lambda: torch.mul(xn, s))
        nb = 2 * xn.numel() * 4
        beside_mul[label] = {"kernel_ms": k_ms, "plain_ms": p_ms, "torch_mul_ms": m_ms,
                             "kernel_device_ms": k_dev, "torch_mul_device_ms": m_dev,
                             "bound_ms": bound(nb, xn.numel())[0], "kernel_over_torch_mul": k_ms / m_ms,
                             "kernel_over_torch_mul_device": k_dev / m_dev}
        del xn
    phase(24, "timing-scale-beside-torch-mul", card=smi, **beside_mul)
    svd_ms = {}
    arrays = tall_skinny_svd(x23, chunk_rows=100_000)
    exprs = [a.expr for a in arrays]
    compute_exprs(exprs)  # warm
    svd_ms["compute_device_ms"] = host_ms(lambda: (compute_exprs(exprs), torch.cuda.synchronize()), 3)
    svd_ms["compute_ms"] = host_ms(lambda: da.compute(*arrays), 3)
    # the device walk alone: the input persisted on the card first
    xp = da.from_array(x23, chunks=(100_000, n23)).persist()
    exprs = [a.expr for a in da.linalg.svd(xp)]
    compute_exprs(exprs)  # warm
    svd_ms["persist_compute_device_ms"] = host_ms(lambda: (compute_exprs(exprs), torch.cuda.synchronize()), 5)
    del xp
    lib_svd_ms = cuda_ms(lambda: torch.linalg.svd(xs_d, full_matrices=False), reps=2, warmup=1)
    phase(24, "timing-tall_skinny_svd-1e6x128", card=smi, **svd_ms, torch_linalg_svd_ms=lib_svd_ms,
          note="torch.linalg.svd of the whole array is a reference only")
    del xs_d, x23, u23
    torch.cuda.empty_cache()

    # -- phase 25: numpy's unsigned integers on the card ----------------------------
    n25 = 4096
    exact_cases, float_errs = unsigned_cases(da, n25)
    phase(25, "unsigned-4096", shape=[n25, n25], chunks=1024, dtypes=["uint16", "uint32", "uint64"],
          exact_cases=exact_cases, moments_max_rel_err=float_errs,
          tolerance={"arithmetic, comparisons, shifts, casts, sums, extrema, arg and scans": "equal to numpy",
                     "mean, std, var": "rtol 1e-12 against numpy"})

    # -- phase 26: the NumPy surface on the card -----------------------------------
    t26 = time.perf_counter()
    checked26, refused26, ulps26 = ufunc_surface(da, UFUNC_SWEEP)
    phase(26, f"ufuncs-{UFUNC_SWEEP}", shape=[UFUNC_SWEEP] * 2, chunks=UFUNC_SWEEP // 4, cases=checked26,
          numpy_refuses=refused26,
          max_ulps=ulps26, numpy=np.__version__,
          dtypes=["float16", "float32", "float64", "int8", "int32", "int64", "uint8", "uint64"],
          tolerance={"default": "equal to numpy, dtype and the sign of a zero included",
                     "ulps": SURFACE_ULPS, "i0 float16/32": "numpy's float64 i0 rounded"},
          seconds=time.perf_counter() - t26)
    surface = surface_paths(da, torch, 16384, smi)
    phase(26, "indexing-routines-16384", **surface)
    print(smi, flush=True)

    # -- phase 27: the second half of the routines, gufuncs, shuffle, quantiles -------
    t27 = time.perf_counter()
    routines = routine_paths(da, torch, ROUTINE_SIZES, lambda fn: cuda_ms(fn, reps=10), torch.cuda.synchronize)
    phase(27, "routines-gufuncs-shuffle-quantiles", card=smi, sizes=ROUTINE_SIZES, numpy=np.__version__,
          paths=len(routines), tolerance={"default": "equal to numpy, dtype and NaNs included",
                                          "max_err_of_max": "max |got - numpy| / max |numpy| under each path's rtol"},
          seconds=time.perf_counter() - t27)
    k2_launches = sum(v["histogram_launches"] for v in routines.values())
    k2 = k2_timing(torch, 1 << 26, cuda_ms, device_ms)
    phase(27, "timing-k2-histogram-2^26-f32", card=smi, launches=k2_launches, **k2)
    print(smi, flush=True)
    torch.cuda.empty_cache()

    # -- phase 28: da.random, the random-input pipelines, fft, svd_compressed, multi-output map_blocks
    t28 = time.perf_counter()
    rp, rp_launches = random_paths(da, torch, RANDOM_SIZES, cuda_ms, torch.cuda.synchronize, torch.device("cuda"))
    check(all(rp_launches[k] > 0 for k in ("band_stencil", "multi_stat", "transpose", "scale")),
          f"a kernel of the random-input pipelines launched no time: {rp_launches}")
    phase(28, "random-leaf", card=smi, **rp["a"])
    phase(28, "distributions", card=smi, values=RANDOM_SIZES["values"], nsample=RANDOM_SIZES["nsample"],
          tolerance="mean and variance within 6 standard errors of scipy.stats' (the Cauchy law: its median)",
          laws=rp["b"])
    phase(28, "random-input-pipelines", card=smi, launches=rp_launches, pipelines=rp["c"],
          tolerance="each random-input form equal byte for byte to its numpy form fed the same values; "
                    "against the plain result as phases 4, 8, 13 and 23 hold it")
    phase(28, "fft", card=smi, cases=rp["d"], small_shapes=[RANDOM_SIZES["check"], RANDOM_SIZES["check3"]])
    phase(28, "svd_compressed", card=smi, **rp["e"], tolerance="s within 1e-3 relative of svd(x)'s top k")
    phase(28, "map_blocks_multi_output", card=smi, **rp["f"], seconds=time.perf_counter() - t28)
    print(smi, flush=True)
    torch.cuda.empty_cache()

    # -- phase 29: IO and interop on the card (zarr, npy stacks, stores, the chunk manager, plankit)
    from pathlib import Path

    t29 = time.perf_counter()
    iop, io_launches = io_paths(da, torch, IO_SIZES, torch.cuda.synchronize, torch.device("cuda"),
                                Path(__file__).resolve().parent / "build")
    phase(29, "to_zarr-stencil2d", card=smi, **iop["a"])
    phase(29, "from_zarr-reductions", card=smi, **iop["b"])
    phase(29, "from_zarr-culled", card=smi, **iop["c"])
    phase(29, "npy-stack-rechunk_relayout", card=smi, **iop["d"])
    phase(29, "io-surface", card=smi, size=IO_SIZES["surface"], chunks=IO_SIZES["surface_chunk"], **iop["e"])
    phase(29, "xarray-chunk-manager", card=smi, size=IO_SIZES["surface"], chunks=IO_SIZES["surface_chunk"],
          host_calls={k: v.get("host_calls") for k, v in iop["f"].items()}, paths=iop["f"])
    phase(29, "plankit", card=smi, **iop["g"], launches=io_launches, seconds=time.perf_counter() - t29)
    print(smi, flush=True)

    # -- phase 30: the out-of-core lane on the card (map- and reduce-streams, pinned copies)
    torch.cuda.empty_cache()
    t30 = time.perf_counter()
    sizes30, cuts30 = stream_sizes()
    for cut in cuts30:
        print(f"phase 30 cut: {cut}", flush=True)
    sp, stream_launches = streaming_paths(da, torch, sizes30)
    phase(30, "stream-stencil2d-roll", card=smi, shape=[sizes30["square"]] * 2, chunks=sizes30["square_chunk"],
          **sp["a"])
    phase(30, "stream-tanh-laplace", card=smi, shape=[sizes30["square"]] * 2, chunks=sizes30["square_chunk"],
          **sp["b"])
    for name, num in sp["c"].items():
        phase(30, f"stream-reduce-{name}", card=smi, shape=[sizes30["rows"], sizes30["cols"]],
              chunk_rows=sizes30["panel"], **num)
    phase(30, "stream-matmul", card=smi, a=[sizes30["rows"], sizes30["mm_cols"]], w=[sizes30["mm_cols"]] * 2,
          chunk_rows=sizes30["panel"], **sp["d"])
    phase(30, "stream-stencil2d-roll-bf16", card=smi, chunks=sizes30["square_chunk"], **sp["e"])
    phase(30, "stream-reduce-float8-sum0", card=smi, chunk_rows=sizes30["panel"], **sp["f"])
    for name in ("min", "max"):
        phase(30, f"stream-reduce-datetime-{name}0", card=smi, chunk_rows=sizes30["panel"], **sp[f"g_{name}"])
    phase(30, "stream-engagement", card=smi, auto_budget_GiB=sp["auto_budget_GiB"],
          auto_budget_GiB_first=sp["auto_budget_GiB_first"], auto_budget_GiB_last=sp["auto_budget_GiB_last"],
          auto_stays_off=sp["auto_stays_off"], auto_off_for_GiB=sp["auto_off_for_GiB"],
          profile_names_k1=sp["profile_names_k1"], profile_trace_MB=sp["profile_trace_MB"],
          ring_pinned_MiB=sp["ring_pinned_MiB"], cuts=cuts30,
          launches=stream_launches, seconds=time.perf_counter() - t30)
    print(smi, flush=True)

    # -- phase 31: S9, bfloat16 kernels and public paths, datetime on the card, the host lanes
    t31 = time.perf_counter()
    s9, s9_entries = s9_paths(da, torch, S9_SIZES, smi)
    for name, num in s9.items():
        phase(31, name, card=smi, **num)
    phase(31, "seconds", seconds=time.perf_counter() - t31)
    print(smi, flush=True)

    # -- phase 32: the mesh on the card (S12): 4 slots, the flagship step,
    # the stencils, the relayout, the shard lane, auto_mesh
    t32 = time.perf_counter()
    mp, mesh_launches = mesh_paths(da, torch, MESH_SIZES)
    for name, num in mp.items():
        phase(32, name, card=smi, **num)
    phase(32, "seconds", launches=mesh_launches, cards=torch.cuda.device_count(),
          seconds=time.perf_counter() - t32)
    check(mesh_launches["band_stencil"] > 0 and mesh_launches["halo"] > 0,
          f"phase 32: a kernel of the mesh paths never launched: {mesh_launches}")
    print(smi, flush=True)

    # -- phase 33: the partitioned walk (the GSPMD lane's counterpart)
    t33 = time.perf_counter()
    pp, part_launches = partitioned_paths(da, torch, PARTITIONED_SIZES)
    for name, num in pp.items():
        phase(33, name, card=smi, **num)
    phase(33, "seconds", launches=part_launches, cards=torch.cuda.device_count(), seconds=time.perf_counter() - t33)
    check(all(v > 0 for v in part_launches.values()), f"phase 33: a kernel never launched: {part_launches}")
    print(smi, flush=True)

    # -- phase 34: ml_dtypes' narrow types at full width, K2's byte route
    t34 = time.perf_counter()
    npaths, byte_launches, byte_timing = narrow_paths(da, torch, NARROW_SIZES, smi)
    for name, num in npaths.items():
        phase(34, name, card=smi, **num)
    phase(34, "seconds", seconds=time.perf_counter() - t34)
    print(smi, flush=True)

    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(smi, flush=True)
    st = st_timings[4096]
    print(json.dumps({"kernels": [
        {
            "name": "band_stencil",
            "route": "cuda",
            "launches_random_input": rp_launches["band_stencil"],
            "launches_io": io_launches["band_stencil"],
            "launches_streamed": stream_launches["band_stencil"],
            "launches_mesh": mesh_launches["band_stencil"],
            "launches_partitioned": mesh_launches["band_stencil"],
            "source": "dask_array_tpu_torch/csrc/band_stencil.cu",
            "replaces": "dask_array_tpu/kernels/stencil.py:83",
            "launches": stencil_launches,
            "max_abs_err": st["max_abs_err"],
            "ms": st["kernel_ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"],
            "library_ms": st["conv2d_ms"],
            "device_ms": st["kernel_device_ms"],
            **s9_entries["band_stencil"],
        },
        {
            "name": "multi_stat",
            "route": "cuda",
            "launches_random_input": rp_launches["multi_stat"],
            "launches_io": io_launches["multi_stat"],
            "launches_partitioned": part_launches["multi_stat"],
            "source": "dask_array_tpu_torch/csrc/mstat.cu",
            "replaces": "bench/probe_reduction.py:72",
            "launches": mstat_launches,
            "max_abs_err": mstat_err,
            "ms": ms_main["kernel_ms"],
            "plain_ms": ms_main["plain_ms"],
            "bound_ms": ms_main["bound_ms"],
            "bound_by": ms_main["bound_by"],
            "library_ms": ms_main["trio_ms"],
            "device_ms": ms_main["device_ms"],
            "shapes": {k: {key: t[key] for key in ("kernel_ms", "device_ms", "plain_ms", "bound_ms", "trio_ms",
                                                    "trio_device_ms", "kernel_of_bound", "device_of_bound")}
                       for k, t in ms_timings.items()},
        },
        {
            "name": "transpose",
            "route": "cuda",
            "launches_random_input": rp_launches["transpose"],
            "launches_io": io_launches["transpose"],
            "launches_partitioned": part_launches["transpose"],
            "source": "dask_array_tpu_torch/csrc/transpose.cu",
            "replaces": "bench/probe_pallas_min.py:42",
            "launches": transpose_launches,
            "max_abs_err": tr_timings[8192]["max_abs_err"],
            "ms": tr_timings[8192]["kernel_ms"],
            "plain_ms": tr_timings[8192]["plain_ms"],
            "bound_ms": tr_timings[8192]["bound_ms"],
            "bound_by": tr_timings[8192]["bound_by"],
            "library_ms": tr_timings[8192]["mT_contiguous_ms"],
        },
        {
            "name": "halo",
            "route": "cuda",
            "launches_streamed": stream_launches["halo"],
            "launches_mesh": mesh_launches["halo"],
            "launches_partitioned": mesh_launches["halo"],
            "source": "dask_array_tpu_torch/csrc/halo.cu",
            "replaces": "bench/probe_band_bisect.py:32-122, bench/probe_band_bisect2.py:68",
            "launches": halo_launches,
            "max_abs_err": halo_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": halo_bound_ms,
            "bound_by": halo_bound_by,
            "library_ms": library_ms,
            "device_ms": halo_dev,
        },
        {
            "name": "scale",
            "route": "cuda",
            "launches_random_input": rp_launches["scale"],
            "launches_partitioned": part_launches["scale"],
            "source": "dask_array_tpu_torch/csrc/scale.cu",
            "replaces": "bench/probe_pallas_min.py:26",
            "launches": scale_launches,
            "max_abs_err": scale_err,
            "ms": kernel_ms24,
            "plain_ms": plain_ms24,
            "bound_ms": scale_bound_ms,
            "bound_by": scale_bound_by,
            "library_ms": mul_ms,
            "launches_svd_compressed": rp_launches["scale_svd_compressed"],
        },
        {
            "name": "histogram",
            "route": "cuda",
            "launches_partitioned": part_launches["histogram"],
            "source": "dask_array_tpu_torch/csrc/histogram.cu",
            "replaces": "dask_array_tpu/kernels/histogram.py:202",
            "launches": k2_launches,
            "max_abs_err": k2["histogram_256"]["max_abs_err_vs_plain"],
            "ms": k2["histogram_256"]["kernel_ms"],
            "plain_ms": k2["histogram_256"]["plain_ms"],
            "bound_ms": k2["histogram_256"]["bound_ms"],
            "bound_by": k2["histogram_256"]["bound_by"],
            "library_ms": k2["histogram_256"]["library_ms"],
            "device_ms": k2["histogram_256"]["kernel_device_ms"],
            "cases": {k: {key: v[key] for key in ("kernel_ms", "kernel_device_ms", "plain_ms", "library_ms",
                                                  "bound_ms", "of_bound")}
                      for k, v in k2.items() if isinstance(v, dict)},
            **s9_entries["histogram"],
        },
        {
            "name": "histogram_bytes",
            "route": "cuda",
            "source": "dask_array_tpu_torch/csrc/histogram.cu",
            "replaces": "dask_array_tpu/kernels/histogram.py:202",
            "launches": byte_launches,
            "max_abs_err": byte_timing["float8_e4m3fn"]["max_abs_err_vs_plain"],
            "ms": byte_timing["float8_e4m3fn"]["kernel_ms"],
            "plain_ms": byte_timing["float8_e4m3fn"]["plain_ms"],
            "bound_ms": byte_timing["float8_e4m3fn"]["bound_ms"],
            "bound_by": byte_timing["float8_e4m3fn"]["bound_by"],
            "library_ms": byte_timing["float8_e4m3fn"]["library_ms"],
            "device_ms": byte_timing["float8_e4m3fn"]["kernel_device_ms"],
            "cases": {k: {key: v[key] for key in ("kernel_ms", "kernel_device_ms", "plain_ms", "library_ms",
                                                  "bound_ms", "of_bound")}
                      for k, v in byte_timing.items()},
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""zarr IO through the port on the CPU, each case beside the JAX package.

Every case of the JAX package's ``tests/test_zarr.py`` runs through both
packages (the ``pkg`` fixture) on the vendored zarr-lite store
(``io/_zarr_lite.py``; zarr itself is not installed).  Then the
differential checks: ``to_zarr`` of the same array through both packages
writes the same files byte for byte (``.zarray`` or ``zarr.json`` and
every chunk file) over dtypes, grids, both formats and compressors, and a
slice of ``from_zarr`` loads the same chunk files through both
(``io._from_map.LOADS`` on the port).

Tolerance: exact everywhere (IO moves bytes); sums of float64 to rtol 1e-12.
"""

import hashlib
import importlib
import json
import os
import time

import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

ROOTS = {"port": "dask_array_tpu_torch", "jax": "dask_array_tpu"}


class Pkg:
    def __init__(self, which):
        self.which = which
        self.root = ROOTS[which]
        self.da = importlib.import_module(self.root)
        self.assert_eq = importlib.import_module(f"{self.root}._test_utils").assert_eq

    def mod(self, path):
        return importlib.import_module(f"{self.root}.{path}")


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture(params=sorted(ROOTS))
def pkg(request):
    return Pkg(request.param)


@pytest.fixture
def rng():
    return np.random.default_rng(29)


@pytest.mark.parametrize("zarr_format", [2, 3])
def test_roundtrip(pkg, tmp_path, rng, zarr_format):
    x = rng.standard_normal((20, 30))
    url = str(tmp_path / "a.zarr")
    pkg.da.to_zarr(pkg.da.from_array(x, chunks=(6, 10)), url, zarr_format=zarr_format)
    back = pkg.da.from_zarr(url)
    assert back.chunks == ((6, 6, 6, 2), (10, 10, 10))
    pkg.assert_eq(back, x)


@pytest.mark.parametrize("zarr_format", [2, 3])
def test_roundtrip_compressed(pkg, tmp_path, rng, zarr_format):
    x = (rng.standard_normal((16, 16)) * 0).astype("f4")
    url = str(tmp_path / "c.zarr")
    pkg.da.to_zarr(pkg.da.from_array(x, chunks=8), url, zarr_format=zarr_format, compressor="gzip")
    pkg.assert_eq(pkg.da.from_zarr(url), x)


def test_store_format_is_real_zarr_v2(pkg, tmp_path):
    x = np.arange(24, dtype="i4").reshape(4, 6)
    url = str(tmp_path / "fmt.zarr")
    pkg.da.to_zarr(pkg.da.from_array(x, chunks=(2, 3)), url, zarr_format=2)
    meta = json.load(open(os.path.join(url, ".zarray")))
    assert meta["zarr_format"] == 2 and meta["shape"] == [4, 6] and meta["chunks"] == [2, 3]
    assert np.dtype(meta["dtype"]) == np.dtype("i4")
    chunk = np.frombuffer(open(os.path.join(url, "1.1"), "rb").read(), dtype="i4")
    np.testing.assert_array_equal(chunk.reshape(2, 3), x[2:4, 3:6])


def test_store_format_is_real_zarr_v3(pkg, tmp_path):
    x = np.arange(12, dtype="f8").reshape(3, 4)
    url = str(tmp_path / "fmt3.zarr")
    pkg.da.to_zarr(pkg.da.from_array(x, chunks=(3, 2)), url, zarr_format=3)
    meta = json.load(open(os.path.join(url, "zarr.json")))
    assert meta["zarr_format"] == 3 and meta["node_type"] == "array" and meta["data_type"] == "float64"
    assert meta["chunk_grid"]["configuration"]["chunk_shape"] == [3, 2]
    chunk = np.frombuffer(open(os.path.join(url, "c", "0", "1"), "rb").read(), dtype="f8")
    np.testing.assert_array_equal(chunk.reshape(3, 2), x[:, 2:4])


def test_edge_chunks_padded(pkg, tmp_path, rng):
    x = rng.standard_normal((5,))
    pkg.da.to_zarr(pkg.da.from_array(x, chunks=3), str(tmp_path / "e.zarr"))
    raw = np.frombuffer(open(tmp_path / "e.zarr" / "1", "rb").read(), dtype="f8")
    assert raw.shape == (3,)
    np.testing.assert_array_equal(raw[:2], x[3:])
    pkg.assert_eq(pkg.da.from_zarr(str(tmp_path / "e.zarr")), x)


def test_from_zarr_rechunked_read(pkg, tmp_path, rng):
    x = rng.standard_normal((24, 24))
    pkg.da.to_zarr(pkg.da.from_array(x, chunks=6), str(tmp_path / "r.zarr"))
    back = pkg.da.from_zarr(str(tmp_path / "r.zarr"), chunks=(12, 24))
    assert back.chunks == ((12, 12), (24,))
    pkg.assert_eq(back, x)


def test_from_zarr_slice_reads_subset(pkg, tmp_path, rng):
    """Slicing a zarr-backed array reads only the chunk it touches."""
    lite = pkg.mod("io._zarr_lite")
    x = rng.standard_normal((40, 40))
    url = str(tmp_path / "s.zarr")
    pkg.da.to_zarr(pkg.da.from_array(x, chunks=10), url)
    reads = []
    orig = lite.ZarrLiteArray._read_chunk

    def spy(self, idx):
        reads.append(idx)
        return orig(self, idx)

    lite.ZarrLiteArray._read_chunk = spy
    try:
        pkg.assert_eq(pkg.da.from_zarr(url)[:10, :10], x[:10, :10])
    finally:
        lite.ZarrLiteArray._read_chunk = orig
    assert set(reads) == {(0, 0)}


def test_to_zarr_region_write(pkg, tmp_path, rng):
    url = str(tmp_path / "reg.zarr")
    pkg.da.to_zarr(pkg.da.from_array(np.zeros((8, 8)), chunks=4), url)
    patch = rng.standard_normal((4, 8))
    pkg.da.to_zarr(pkg.da.from_array(patch, chunks=(4, 4)), url, region=(slice(4, 8), slice(0, 8)))
    got = np.asarray(pkg.da.from_zarr(url).compute())
    np.testing.assert_array_equal(got[:4], 0)
    np.testing.assert_array_equal(got[4:], patch)


def test_to_zarr_irregular_chunks_warns_and_rechunks(pkg, tmp_path, rng):
    x = rng.standard_normal((10,))
    with pytest.warns(pkg.da.PerformanceWarning, match="irregular"):
        pkg.da.to_zarr(pkg.da.from_array(x, chunks=(3, 4, 3)), str(tmp_path / "bad.zarr"))
    np.testing.assert_array_equal(np.asarray(pkg.da.from_zarr(str(tmp_path / "bad.zarr")).compute()), x)


def test_to_zarr_unknown_chunks_raise(pkg, tmp_path, rng):
    x = rng.standard_normal((10,))
    d = pkg.da.from_array(x, chunks=5)
    masked = d[pkg.da.from_array(x > 0, chunks=5)]
    with pytest.raises(ValueError, match="unknown chunk sizes"):
        pkg.da.to_zarr(masked, str(tmp_path / "bad2.zarr"))


def test_missing_chunks_read_fill_value(pkg, tmp_path):
    z = pkg.mod("io._zarr_lite").open_array(str(tmp_path / "f.zarr"), mode="w", shape=(6,), dtype="f8",
                                            chunks=(3,), fill_value=1.5)
    z[0:3] = np.arange(3.0)
    np.testing.assert_array_equal(z[0:6], [0.0, 1.0, 2.0, 1.5, 1.5, 1.5])


def test_checkpoint_resume_cycle(pkg, tmp_path, rng):
    x = rng.standard_normal((32, 8))
    state = (pkg.da.from_array(x, chunks=(8, 8)) * 2).persist()
    pkg.da.to_zarr(state, str(tmp_path / "ckpt.zarr"))
    resumed = pkg.da.from_zarr(str(tmp_path / "ckpt.zarr"))
    pkg.assert_eq(resumed.sum(axis=0), (x * 2).sum(axis=0), rtol=1e-12)


def test_overwrite_wipes_previous_store(pkg, tmp_path, rng):
    url = str(tmp_path / "ow.zarr")
    pkg.da.to_zarr(pkg.da.from_array(rng.standard_normal((12,)), chunks=4), url, zarr_format=2)
    small = rng.standard_normal((6,))
    pkg.da.to_zarr(pkg.da.from_array(small, chunks=3), url, zarr_format=3, overwrite=True)
    back = pkg.da.from_zarr(url)
    assert back.shape == (6,)
    pkg.assert_eq(back, small)
    assert not os.path.exists(os.path.join(url, ".zarray"))
    assert not os.path.exists(os.path.join(url, "2"))


def test_w_minus_exclusive_create(pkg, tmp_path):
    open_array = pkg.mod("io._zarr_lite").open_array
    url = str(tmp_path / "x.zarr")
    open_array(url, mode="w-", shape=(4,), dtype="f8", chunks=(2,))
    with pytest.raises(FileExistsError):
        open_array(url, mode="w-", shape=(4,), dtype="f8", chunks=(2,))


def test_array_to_zarr_method(pkg, tmp_path, rng):
    x = rng.standard_normal((9, 4)).astype("f4")
    pkg.da.from_array(x, chunks=(3, 4)).to_zarr(str(tmp_path / "m.zarr"))
    pkg.assert_eq(pkg.da.from_zarr(str(tmp_path / "m.zarr")), x)


def test_from_array_of_a_zarr_lite_array_reads_lazily(pkg, tmp_path, rng):
    """from_array keeps a zarr-lite array as a store: its grid is the
    store's chunks, and a slice reads only the chunks it touches."""
    lite = pkg.mod("io._zarr_lite")
    x = rng.standard_normal((40, 40))
    url = str(tmp_path / "fa.zarr")
    pkg.da.to_zarr(pkg.da.from_array(x, chunks=10), url)
    z = lite.open_array(url, mode="r")
    reads = []
    orig = lite.ZarrLiteArray._read_chunk

    def spy(self, idx):
        reads.append(idx)
        return orig(self, idx)

    lite.ZarrLiteArray._read_chunk = spy
    try:
        d = pkg.da.from_array(z)
        assert not reads
        pkg.assert_eq(d[12:18, 31:39], x[12:18, 31:39])
    finally:
        lite.ZarrLiteArray._read_chunk = orig
    assert set(reads) == {(1, 3)}


# ---------------------------------------------------------------------------
# differential: the same files through both packages, the same chunk reads
# ---------------------------------------------------------------------------


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
                                   "bool", "complex64"])
@pytest.mark.parametrize("zarr_format", [2, 3])
def test_to_zarr_writes_the_same_files_as_the_jax_package(tmp_path, dtype, zarr_format):
    x = (np.random.default_rng(3).standard_normal((23, 17)) * 50).astype(dtype)
    written = {}
    for which in ROOTS:
        p = Pkg(which)
        url = tmp_path / f"{which}.zarr"
        p.da.to_zarr(p.da.from_array(x, chunks=(8, 5)), str(url), zarr_format=zarr_format)
        written[which] = _files(url)
    assert written["port"] == written["jax"]
    assert len(written["port"]) == 1 + 3 * 4


@pytest.mark.parametrize("case", ["gzip", "region", "ragged-rechunk", "1d", "3d"])
def test_to_zarr_cases_write_the_same_files_as_the_jax_package(tmp_path, monkeypatch, case):
    rng = np.random.default_rng(17)
    x = rng.standard_normal((12, 10)).astype("f4")
    if case == "gzip":
        # gzip writes time.time() into its header's MTIME field: pin the
        # clock for both writes, so a second boundary falling between them
        # cannot make the two stores differ
        monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    written = {}
    for which in ROOTS:
        p = Pkg(which)
        url = str(tmp_path / f"{which}.zarr")
        if case == "gzip":
            p.da.to_zarr(p.da.from_array(x, chunks=(4, 5)), url, compressor="gzip")
        elif case == "region":
            p.da.to_zarr(p.da.from_array(np.zeros_like(x), chunks=4), url)
            p.da.to_zarr(p.da.from_array(x[4:8], chunks=(4, 5)), url, region=(slice(4, 8), slice(0, 10)))
        elif case == "ragged-rechunk":
            with pytest.warns(p.da.PerformanceWarning):
                p.da.to_zarr(p.da.from_array(x, chunks=((3, 5, 4), (6, 4))), url)
        elif case == "1d":
            p.da.to_zarr(p.da.from_array(x.ravel(), chunks=7), url)
        else:
            p.da.to_zarr(p.da.from_array(x.reshape(3, 4, 10), chunks=(2, 3, 4)), url)
        written[which] = _files(url)
    assert written["port"] == written["jax"]


@pytest.mark.parametrize("index", [np.s_[:10, :10], np.s_[15:25, 5:35], np.s_[39], np.s_[:, 20:30], np.s_[:]])
def test_from_zarr_slices_load_the_chunks_the_jax_package_loads(tmp_path, index):
    from dask_array_tpu_torch.io import _from_map

    x = np.random.default_rng(4).standard_normal((40, 40))
    url = str(tmp_path / "s.zarr")
    Pkg("port").da.to_zarr(Pkg("port").da.from_array(x, chunks=10), url)
    reads, out = {}, {}
    for which in ROOTS:
        p = Pkg(which)
        lite = p.mod("io._zarr_lite")
        seen = reads.setdefault(which, [])
        orig = lite.ZarrLiteArray._read_chunk

        def spy(self, idx, orig=orig, seen=seen):
            seen.append(idx)
            return orig(self, idx)

        lite.ZarrLiteArray._read_chunk = spy
        try:
            d = p.da.from_zarr(url)
            _from_map.LOADS = 0
            out[which] = np.asarray(d[index].compute())
        finally:
            lite.ZarrLiteArray._read_chunk = orig
        if which == "port":
            # one loader call per block the slice keeps (one chunk file each)
            assert _from_map.LOADS == len(seen)
    assert sorted(reads["port"]) == sorted(reads["jax"])
    np.testing.assert_array_equal(out["port"], x[index])
    np.testing.assert_array_equal(out["jax"], x[index])

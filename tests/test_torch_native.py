"""The native data plane (``native/fastdata.cpp`` through ctypes), against
the reference.

Both packages load the same ``native/libfastdata.so``, so every function is
held BITWISE equal to the reference's on the same inputs (tolerance 0), and
to numpy's result where the reference's test compares with numpy. The
malformed-CSV and extra-field errors are the reference's. ``Dataset.from_csv``
of the shipped ``higgs_sample.csv`` (the native parse) is equal in both
packages, and within one float32 ulp of the port's numpy parse (the same
text read by ``float()`` and by the C parser).
"""

import os

import numpy as np
import pytest

from distkeras_tpu.data import native as ref_native
from distkeras_tpu.data.dataset import Dataset as RefDataset
from distkeras_tpu_torch.data import native
from distkeras_tpu_torch.data.dataset import Dataset

CSV = os.path.join(os.path.dirname(__file__), "..", "examples", "data", "higgs_sample.csv")
NAMES = [f"f{i}" for i in range(28)]


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def test_available_after_build():
    assert native.available() and ref_native.available()
    assert native._LIB._name == ref_native._LIB._name  # one library, one path


def test_parse_csv():
    data = b"1.5,2,3\n4,5.25,6\n7,8,9.125\n-1e-3,2.5e2,0.1\n"
    out = native.parse_csv(data, rows=4, cols=3)
    _equal(out, ref_native.parse_csv(data, rows=4, cols=3))
    np.testing.assert_array_equal(out[:3], [[1.5, 2, 3], [4, 5.25, 6], [7, 8, 9.125]])
    short = native.parse_csv(data, rows=6, cols=3)  # fewer rows than asked: trimmed
    _equal(short, ref_native.parse_csv(data, rows=6, cols=3))


@pytest.mark.parametrize("data,rows,cols", [(b"1,xx,3\n", 1, 3), (b"1,2,3,4\n5,6,7\n", 2, 3)],
                         ids=["malformed", "extra_field"])
def test_parse_csv_errors(data, rows, cols):
    for mod in (native, ref_native):
        with pytest.raises(ValueError, match="malformed CSV"):
            mod.parse_csv(data, rows=rows, cols=cols)


def test_gather_rows():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(100, 17)).astype(np.float32)
    idx = rng.integers(0, 100, size=64)
    out = native.gather_rows(src, idx)
    _equal(out, ref_native.gather_rows(src, idx))
    np.testing.assert_array_equal(out, src[idx])
    cube = rng.normal(size=(10, 3, 4)).astype(np.float32)
    _equal(native.gather_rows(cube, [9, 0]), ref_native.gather_rows(cube, [9, 0]))
    for bad in ([100], [-1]):
        with pytest.raises(IndexError, match="out of range"):
            native.gather_rows(src, np.array(bad))


@pytest.mark.parametrize("scale,shift", [(1.0, 0.0), (2.0, 1.0), (1 / 255, -0.5)],
                         ids=["plain", "fused", "normalize"])
def test_pack_batch(scale, shift):
    src = np.random.default_rng(1).normal(size=(10, 4)).astype(np.float32)
    out = native.pack_batch(src, start=2, batch=5, scale=scale, shift=shift)
    _equal(out, ref_native.pack_batch(src, start=2, batch=5, scale=scale, shift=shift))
    np.testing.assert_allclose(out, src[2:7] * np.float32(scale) + np.float32(shift),
                               rtol=1e-6)
    with pytest.raises(IndexError, match="outside"):
        native.pack_batch(src, start=8, batch=3)


def test_permutation():
    p1 = native.permutation(1000, seed=42)
    _equal(p1, ref_native.permutation(1000, seed=42))
    np.testing.assert_array_equal(p1, native.permutation(1000, seed=42))
    assert not np.array_equal(p1, native.permutation(1000, seed=43))
    np.testing.assert_array_equal(np.sort(p1), np.arange(1000))


def test_column_minmax():
    x = np.array([[3.0, -1.5], [10.0, 0.0]], np.float32)
    assert native.column_minmax(x) == (-1.5, 10.0) == ref_native.column_minmax(x)
    y = np.random.default_rng(2).normal(size=(33, 7)).astype(np.float32)
    assert native.column_minmax(y) == ref_native.column_minmax(y)
    assert native.column_minmax(y) == (float(y.min()), float(y.max()))


def test_from_csv_matches_reference_and_numpy_parse():
    ds = Dataset.from_csv(CSV, features=NAMES, label="label")
    ref = RefDataset.from_csv(CSV, features=NAMES, label="label")
    assert ds.columns == ref.columns and ds.num_rows == ref.num_rows == 600
    for name in ds.columns:
        _equal(ds[name], ref[name])
    # the port's numpy path (the csv module and float()) on the same text
    native._LIB, native._LOAD_TRIED = None, True
    try:
        plain = Dataset.from_csv(CSV, features=NAMES, label="label")
    finally:
        native._LIB, native._LOAD_TRIED = None, False
        assert native.available()
    a, b = ds["features"], plain["features"]
    assert np.all(np.abs(a - b) <= np.spacing(np.abs(b))), float(np.abs(a - b).max())
    np.testing.assert_array_equal(ds["label"], plain["label"])


def test_dataset_gather_goes_native_for_float32():
    rng = np.random.default_rng(3)
    cols = {"x": rng.normal(size=(50, 6)).astype(np.float32),
            "tok": rng.integers(0, 9, size=(50, 4)).astype(np.int32)}
    idx = rng.permutation(50)[:20]
    got, want = Dataset(cols).gather(idx), RefDataset(cols).gather(idx)
    for k in cols:
        _equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], cols[k][idx])

"""Sparse columns and the sparse paths of ``Dataset``, against the reference.

The reference's ``tests/test_sparse.py`` cases run on both packages'
``SparseColumn``/``Dataset``/``DenseTransformer`` from the same seeded numpy
inputs, and each result is held equal to the other package's element for
element (tolerance 0: the same numpy operations on the same arrays). npz
files cross both ways. Sparse features then go through ``DenseTransformer``
and each package's ``SingleTrainer`` from the same (bridged) weights: the
losses of the first steps agree to 1e-5 relative (float32 products in
another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.data.dataset import Dataset as RefDataset
from distkeras_tpu.data.sparse import SparseColumn as RefSparseColumn
from distkeras_tpu.data.transformers import DenseTransformer as RefDenseTransformer
from distkeras_tpu_torch.data import DenseTransformer, SparseColumn
from distkeras_tpu_torch.data import Dataset as PortDataset

PKGS = {
    "ref": (RefDataset, RefSparseColumn, RefDenseTransformer),
    "port": (PortDataset, SparseColumn, DenseTransformer),
}
LOSS_RTOL = 1e-5


def _dense(n=40, dim=16, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, dim)).astype(np.float32)
    dense[rng.random(size=dense.shape) > density] = 0.0
    return dense


def _csr(col):
    return col.indptr, col.indices, col.values, col.dim


def _assert_same_csr(a, b):
    for x, y in zip(_csr(a), _csr(b)):
        np.testing.assert_array_equal(x, y)
        assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("pkg", PKGS)
def test_dense_roundtrip(pkg):
    _, Sparse, _ = PKGS[pkg]
    dense = _dense()
    sp = Sparse.from_dense(dense)
    assert sp.shape == dense.shape
    assert sp.nnz == int((dense != 0).sum())
    np.testing.assert_array_equal(sp.to_dense(), dense)
    np.testing.assert_array_equal(np.asarray(sp), dense)
    _assert_same_csr(sp, RefSparseColumn.from_dense(dense))
    assert sp.nbytes == RefSparseColumn.from_dense(dense).nbytes
    half = sp.astype(np.float16)
    assert half.dtype == np.float16 and isinstance(half, Sparse)


@pytest.mark.parametrize("pkg", PKGS)
def test_from_rows_reference_sparsevector_form(pkg):
    _, Sparse, _ = PKGS[pkg]
    rows = [([0, 3], [1.0, 2.0]), ([], []), ([5], [7.0])]
    sp = Sparse.from_rows(rows, dim=6)
    want = np.zeros((3, 6), np.float32)
    want[0, 0], want[0, 3], want[2, 5] = 1.0, 2.0, 7.0
    np.testing.assert_array_equal(sp.to_dense(), want)
    _assert_same_csr(sp, RefSparseColumn.from_rows(rows, dim=6))
    with pytest.raises(ValueError, match="row 0"):
        Sparse.from_rows([([0, 1], [1.0])], dim=4)


@pytest.mark.parametrize("key", [np.array([5, 2, 2, 31]), slice(3, 11), slice(None, None, -3),
                                 np.array([-1, 0]), np.arange(40) % 3 == 0, np.array([], int)],
                         ids=["ints", "slice", "reverse", "negative", "mask", "empty"])
def test_row_selection_stays_sparse_and_matches(key):
    dense = _dense()
    got = SparseColumn.from_dense(dense)[key]
    want = RefSparseColumn.from_dense(dense)[key]
    assert isinstance(got, SparseColumn)
    _assert_same_csr(got, want)
    np.testing.assert_array_equal(got.to_dense(), dense[key])


@pytest.mark.parametrize("pkg", PKGS)
def test_scalar_rows_and_errors(pkg):
    _, Sparse, _ = PKGS[pkg]
    dense = _dense(n=6, dim=4, seed=8)
    sp = Sparse.from_dense(dense)
    for i in (0, 3, -1, -2):
        np.testing.assert_array_equal(sp[i], dense[i])
    for i in (6, -7):
        with pytest.raises(IndexError):
            sp[i]
    with pytest.raises(IndexError):
        sp[np.array([99])]
    with pytest.raises(IndexError, match="boolean mask"):
        sp[np.array([True, False])]
    with pytest.raises(TypeError, match="1-D"):
        sp[np.zeros((2, 2), int)]
    with pytest.raises(ValueError, match="indptr"):
        Sparse(np.array([1, 2]), np.array([0]), np.array([1.0]), 4)
    with pytest.raises(ValueError, match="out of range"):
        Sparse(np.array([0, 1]), np.array([9]), np.array([1.0]), 4)
    with pytest.raises(ValueError, match="mismatch"):
        Sparse(np.array([0, 2]), np.array([0, 1]), np.array([1.0]), 4)
    with pytest.raises(ValueError, match="dim mismatch"):
        Sparse.concat_all([sp, Sparse.from_dense(np.zeros((2, 5), np.float32))])


def test_concat_all_matches_reference():
    parts = [_dense(n=n, dim=8, seed=s) for n, s in ((5, 1), (0, 2), (9, 3))]
    got = SparseColumn.concat_all([SparseColumn.from_dense(p) for p in parts])
    want = RefSparseColumn.concat_all([RefSparseColumn.from_dense(p) for p in parts])
    _assert_same_csr(got, want)
    pair = SparseColumn.from_dense(parts[0]).concat(SparseColumn.from_dense(parts[2]))
    np.testing.assert_array_equal(np.asarray(pair), np.concatenate([parts[0], parts[2]]))


def _dataset_ops(pkg):
    Dataset, Sparse, _ = PKGS[pkg]
    dense = _dense()
    label = (dense.sum(axis=1) > 0).astype(np.float32)
    ds = Dataset.from_arrays(features=Sparse.from_dense(dense), label=label)
    shuffled = ds.shuffle(seed=3)
    parts = ds.shuffle(seed=1).partitions(3)
    cat = parts[0].concat(parts[1]).concat(parts[2])
    train, test = ds.split(0.75, seed=2)
    return {"shuffled": shuffled, "cat": cat, "repeat": ds.repeat(2), "train": train,
            "test": test, "gather": ds.gather(np.array([7, 1, 1, 39])),
            "take": ds.take(5), "slice": ds.slice(4, 9)}


def test_dataset_ops_keep_sparse_and_match_reference():
    got, want = _dataset_ops("port"), _dataset_ops("ref")
    for name in want:
        assert isinstance(got[name]["features"], SparseColumn), name
        _assert_same_csr(got[name]["features"], want[name]["features"])
        np.testing.assert_array_equal(got[name]["label"], want[name]["label"])
    assert got["repeat"].num_rows == 80


@pytest.mark.parametrize("pkg", PKGS)
def test_dense_transformer_densifies(pkg):
    Dataset, Sparse, Dense = PKGS[pkg]
    dense = _dense()
    out = Dense("features", "features_dense").transform(
        Dataset.from_arrays(features=Sparse.from_dense(dense)))
    got = out["features_dense"]
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, dense)
    passthrough = Dense("features", "f").transform(
        Dataset.from_arrays(features=dense.astype(np.float64)[:, ::2]))["f"]
    assert passthrough.dtype == np.float32 and passthrough.flags["C_CONTIGUOUS"]


def test_dataset_surface_matches_reference():
    """rows(), describe() (CSR-direct, zeros included), with_column keeping
    sparsity, mixed sparse/dense concat (sparse wins, both orders)."""
    dense = _dense(n=12, dim=6, seed=4)
    label = np.arange(12, dtype=np.float32)
    out = {}
    for pkg, (Dataset, Sparse, _) in PKGS.items():
        sp = Sparse.from_dense(dense)
        ds = Dataset.from_arrays(features=sp, label=label)
        dd = Dataset.from_arrays(features=dense, label=label)
        out[pkg] = {
            "rows": np.stack([r["features"] for r in ds.rows()]),
            "describe": ds.describe(),
            "with_column": ds.with_column("features2", sp)["features2"],
            "cat": [a.concat(b)["features"] for a, b in ((ds, dd), (dd, ds))],
        }
    got, want = out["port"], out["ref"]
    np.testing.assert_array_equal(got["rows"], dense)
    assert got["describe"] == want["describe"]
    st = got["describe"]["features"]
    assert st["mean"] == pytest.approx(float(dense.mean()), abs=1e-6)
    assert st["std"] == pytest.approx(float(dense.std()), abs=1e-6)
    assert (st["min"], st["max"]) == (float(dense.min()), float(dense.max()))
    assert isinstance(got["with_column"], SparseColumn)
    for g, w in zip(got["cat"], want["cat"]):
        assert isinstance(g, SparseColumn)
        _assert_same_csr(g, w)
        np.testing.assert_array_equal(np.asarray(g), np.concatenate([dense, dense]))


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"), ("port", "port")])
@pytest.mark.parametrize("name", ["features", "a__csr_b"])
def test_npz_crosses_packages(tmp_path, writer, reader, name):
    """An npz written by either package loads in the other: CSR components
    under ``name__csr_*`` (even for a name that holds ``__csr_``), dense
    columns as they are, and the same bytes for every member."""
    dense = _dense(n=9, dim=5, seed=2)
    label = np.arange(9, dtype=np.float32)
    W, R = PKGS[writer][0], PKGS[reader][0]
    path = str(tmp_path / "ds.npz")
    W.from_arrays(**{name: PKGS[writer][1].from_dense(dense), "label": label}).to_npz(path)
    back = R.from_npz(path)
    assert isinstance(back[name], PKGS[reader][1])
    np.testing.assert_array_equal(np.asarray(back[name]), dense)
    np.testing.assert_array_equal(back["label"], label)
    other = str(tmp_path / "other.npz")
    PKGS["ref" if writer == "port" else "port"][0].from_arrays(
        **{name: PKGS["ref" if writer == "port" else "port"][1].from_dense(dense),
           "label": label}).to_npz(other)
    with np.load(path) as a, np.load(other) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("pkg", PKGS)
def test_npz_collision_guard(tmp_path, pkg):
    Dataset = PKGS[pkg][0]
    with pytest.raises(ValueError, match="__csr_"):
        Dataset.from_arrays(x__csr_mask=_dense(n=3, dim=2)).to_npz(str(tmp_path / "bad.npz"))
    # a plain column whose name merely holds "__csr_" (no full quadruple)
    # written by numpy loads as a plain column in both packages
    path = str(tmp_path / "plain.npz")
    np.savez(path, **{"x__csr_values": np.ones(3)})
    back = Dataset.from_npz(path)
    assert isinstance(back["x__csr_values"], np.ndarray)


def test_minibatches_densify_sparse_features():
    """The port's feed densifies a still-sparse column (``np.asarray``), as
    the reference's does: the same batches in the same order."""
    from distkeras_tpu.data.feed import minibatches as ref_minibatches
    from distkeras_tpu_torch.data import minibatches

    dense = _dense(n=20, dim=6, seed=5)
    label = np.arange(20, dtype=np.float32)
    got = list(minibatches(PortDataset.from_arrays(
        features=SparseColumn.from_dense(dense), label=label), 8, seed=1))
    want = list(ref_minibatches(RefDataset.from_arrays(
        features=RefSparseColumn.from_dense(dense), label=label), 8, seed=1))
    assert len(got) == len(want) == 2  # the remainder is dropped
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["features"], w["features"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_sparse_features_train_like_the_reference():
    """Sparse features -> DenseTransformer -> SingleTrainer in both packages
    from the same weights: every step's loss within 1e-5 relative (the
    reference workflow: a SparseVector column densified before training)."""
    from distkeras_tpu.models.core import Model as RefModel
    from distkeras_tpu.models.mlp import MLP as RefMLP
    from distkeras_tpu.training.trainers import SingleTrainer as RefSingleTrainer
    from distkeras_tpu_torch.models.core import Model
    from distkeras_tpu_torch.models.mlp import MLP
    from distkeras_tpu_torch.training.trainers import SingleTrainer
    from distkeras_tpu_torch.utils.bridge import params_from_jax

    rng = np.random.default_rng(0)
    dense = rng.normal(size=(128, 16)).astype(np.float32)
    dense[rng.random(size=dense.shape) > 0.3] = 0.0
    label = (dense @ rng.normal(size=(16,)) > 0).astype(np.float32)
    kw = dict(worker_optimizer="adam", learning_rate=0.02, batch_size=32, num_epoch=2, seed=0)

    ref = RefModel.from_flax(RefMLP(features=(16,), num_classes=2, compute_dtype=jnp.float32),
                             input_shape=(16,))
    params = ref.init(jax.random.split(jax.random.PRNGKey(0))[0])["params"]
    ref_ds = RefDenseTransformer("features", "features").transform(
        RefDataset.from_arrays(features=RefSparseColumn.from_dense(dense), label=label))
    ref_tr = RefSingleTrainer(ref, **kw)
    ref_tr.train(ref_ds, shuffle=True)

    weights = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    port = Model(lambda: MLP(16, (16,), 2, compute_dtype=torch.float32), input_shape=(16,))
    port.init = lambda seed=0, device=None: {k: v.clone() for k, v in weights.items()}
    ds = DenseTransformer("features", "features").transform(
        PortDataset.from_arrays(features=SparseColumn.from_dense(dense), label=label))
    tr = SingleTrainer(port, device="cpu", **kw)
    tr.train(ds, shuffle=True)

    got = [h["loss"] for h in tr.get_history()]
    want = [h["loss"] for h in ref_tr.get_history()]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got[:4], want[:4], rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_module_file_is_numpy_only():
    path = os.path.join(os.path.dirname(__file__), "..", "distkeras_tpu_torch", "data",
                        "sparse.py")
    imports = [line.split()[1] for line in open(path) if line.startswith(("import ", "from "))]
    assert set(imports) <= {"__future__", "collections.abc", "numpy"}, imports

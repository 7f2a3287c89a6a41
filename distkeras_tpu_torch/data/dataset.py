"""Columnar in-memory dataset: a dict of named columns on the host.

Counterpart of ``distkeras_tpu/data/dataset.py`` ``Dataset``. The port keeps
its own copy (numpy and the standard library only) so that it never imports
the reference package. A column is an ndarray or a
:class:`~distkeras_tpu_torch.data.sparse.SparseColumn`, which row slicing,
gathering and concat keep sparse, and which ``to_npz`` writes as its CSR
components under the reference's ``name__csr_*`` names: an npz written by
either package loads in the other. Where the native data plane
(:mod:`~distkeras_tpu_torch.data.native`, ``native/fastdata.cpp``) is built,
``from_csv`` parses all-numeric tables with it and ``gather`` moves float32
rows with it; numpy does the rest.
"""

from __future__ import annotations

import csv as _csv
from collections.abc import Iterator, Mapping, Sequence

import numpy as np

__all__ = ["Dataset"]


class Dataset:
    """An immutable named-column table backed by numpy arrays.

    Columns share a leading row dimension; a column may be any rank
    (e.g. ``features`` of shape ``[N, 784]`` or images ``[N, 28, 28, 1]``).
    """

    def __init__(self, columns: Mapping[str, np.ndarray]):
        from distkeras_tpu_torch.data.sparse import SparseColumn

        if not columns:
            raise ValueError("Dataset requires at least one column")
        # SparseColumn stays sparse (row ops keep CSR form; np.asarray
        # densifies on demand) — everything else materializes as ndarray.
        self._columns: dict[str, np.ndarray] = {
            k: (v if isinstance(v, SparseColumn) else np.asarray(v))
            for k, v in columns.items()
        }
        lengths = {k: v.shape[0] for k, v in self._columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"Column length mismatch: {lengths}")
        self._num_rows = next(iter(lengths.values()))

    # -- construction -------------------------------------------------------

    @classmethod
    def from_arrays(cls, **columns: np.ndarray) -> "Dataset":
        return cls(columns)

    @classmethod
    def from_csv(
        cls,
        path: str,
        features: Sequence[str] | None = None,
        label: str | None = None,
        features_col: str = "features",
        label_col: str = "label",
        dtype=np.float32,
    ) -> "Dataset":
        """Read a headered CSV.

        If ``features`` is given, those columns are stacked into a single
        vector column ``features_col`` (mirroring Spark's VectorAssembler
        stage that dist-keras notebooks used before the trainers).
        """
        from distkeras_tpu_torch.data import native

        with open(path, "rb") as fb:
            raw = fb.read()
        if not raw.strip():
            raise ValueError(f"empty CSV file: {path}")
        nl = raw.find(b"\n")
        if nl == -1:  # header-only file without trailing newline
            nl = len(raw)
        header = raw[:nl].decode().strip().split(",")
        body = raw[nl + 1 :]
        table: dict[str, np.ndarray] = {}
        if native.available():
            # Native columnar parse for all-numeric tables (the common case:
            # the reference's ATLAS-Higgs CSV is numeric throughout).
            nrows = body.count(b"\n") + (0 if body.endswith(b"\n") or not body else 1)
            try:
                mat = native.parse_csv(body, rows=nrows, cols=len(header))
                table = {name: mat[:, i] for i, name in enumerate(header)}
            except ValueError:
                table = {}
        if not table:
            reader = _csv.reader(body.decode().splitlines())
            rows = [r for r in reader if r]
            table = {
                name: np.array([row[i] for row in rows])
                for i, name in enumerate(header)
            }
        out: dict[str, np.ndarray] = {}
        if features is not None:
            out[features_col] = np.stack(
                [table[c].astype(dtype) for c in features], axis=1
            )
            if label is not None:
                out[label_col] = table[label].astype(dtype)
            for name, col in table.items():
                if name not in features and name != label:
                    out[name] = _maybe_numeric(col, dtype)
        else:
            out = {name: _maybe_numeric(col, dtype) for name, col in table.items()}
        return cls(out)

    @classmethod
    def from_npz(cls, path: str) -> "Dataset":
        """Load a dataset saved with :meth:`to_npz` (or any npz whose arrays
        share a leading row dimension). Sparse columns round-trip in CSR
        form (saved as ``name__csr_*`` component arrays)."""
        from distkeras_tpu_torch.data.sparse import SparseColumn

        with np.load(path) as d:
            # A base is CSR only when its full component quadruple exists;
            # anything else (including names that merely contain
            # "__csr_") loads as a plain column. Bases are derived by
            # stripping the FINAL "__csr_<component>" suffix, so a column
            # whose own name contains "__csr_" still round-trips.
            comp = ("indptr", "indices", "values", "dim")

            def strip(k):
                for c in comp:
                    suf = f"__csr_{c}"
                    if k.endswith(suf):
                        return k[: -len(suf)]
                return None

            bases = {
                b
                for b in (strip(k) for k in d.files)
                if b is not None
                and all(f"{b}__csr_{c}" in d.files for c in comp)
            }
            cols: dict = {}
            for k in d.files:
                base = strip(k)
                if base in bases:
                    if k.endswith("__csr_indptr"):
                        cols[base] = SparseColumn(
                            d[f"{base}__csr_indptr"],
                            d[f"{base}__csr_indices"],
                            d[f"{base}__csr_values"],
                            int(d[f"{base}__csr_dim"]),
                        )
                else:
                    cols[k] = d[k]
            return cls(cols)

    def to_npz(self, path: str, compressed: bool = False) -> None:
        from distkeras_tpu_torch.data.sparse import SparseColumn

        save = np.savez_compressed if compressed else np.savez
        arrays: dict = {}
        for k, v in self._columns.items():
            if "__csr_" in k and not isinstance(v, SparseColumn):
                raise ValueError(
                    f"column name {k!r} collides with the reserved "
                    "'__csr_' suffix scheme used for sparse persistence"
                )
            if isinstance(v, SparseColumn):
                # Persist CSR components — never the densified matrix
                # (densifying on save would defeat the type's purpose).
                arrays[f"{k}__csr_indptr"] = v.indptr
                arrays[f"{k}__csr_indices"] = v.indices
                arrays[f"{k}__csr_values"] = v.values
                arrays[f"{k}__csr_dim"] = np.int64(v.dim)
            else:
                arrays[k] = v
        save(path, **arrays)

    # -- basic accessors ----------------------------------------------------

    @property
    def columns(self) -> list[str]:
        return list(self._columns)

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def column(self, name: str) -> np.ndarray:
        return self[name]

    def __getitem__(self, name: str) -> np.ndarray:
        try:
            return self._columns[name]
        except KeyError:
            raise KeyError(
                f"no column {name!r}; available: {sorted(self._columns)}"
            ) from None

    # -- functional updates -------------------------------------------------

    def with_column(self, name: str, values: np.ndarray) -> "Dataset":
        """Return a new Dataset with ``name`` added/replaced (the analogue of
        Spark's ``withColumn`` used throughout the reference transformers).
        Sparse columns are preserved (the constructor's coercion rule)."""
        cols = dict(self._columns)
        cols[name] = values
        return Dataset(cols)

    def select(self, *names: str) -> "Dataset":
        return Dataset({n: self._columns[n] for n in names})

    def drop(self, *names: str) -> "Dataset":
        return Dataset({k: v for k, v in self._columns.items() if k not in names})

    def take(self, n: int) -> "Dataset":
        return Dataset({k: v[:n] for k, v in self._columns.items()})

    def slice(self, start: int, stop: int) -> "Dataset":
        return Dataset({k: v[start:stop] for k, v in self._columns.items()})

    def gather(self, indices: np.ndarray) -> "Dataset":
        from distkeras_tpu_torch.data import native

        def _one(v: np.ndarray) -> np.ndarray:
            # Native memcpy gather for the float32 hot path; numpy (and
            # the CSR row-gather for sparse columns) otherwise.
            if (
                native.available()
                and isinstance(v, np.ndarray)
                and v.dtype == np.float32
                and v.flags["C_CONTIGUOUS"]
            ):
                return native.gather_rows(v, indices)
            return v[indices]

        return Dataset({k: _one(v) for k, v in self._columns.items()})

    def shuffle(self, seed: int = 0) -> "Dataset":
        """Row shuffle (reference ``distkeras/utils.py`` § ``shuffle``)."""
        perm = np.random.default_rng(seed).permutation(self._num_rows)
        return self.gather(perm)

    @staticmethod
    def _cat(parts):
        from distkeras_tpu_torch.data.sparse import SparseColumn

        if any(isinstance(p, SparseColumn) for p in parts):
            # Mixed sparse/dense concat: sparse wins (sparsifying the
            # dense minority costs O(nnz); densifying the sparse majority
            # could OOM) — order-independent, single pass (no O(n²) fold).
            return SparseColumn.concat_all([
                p if isinstance(p, SparseColumn)
                else SparseColumn.from_dense(np.asarray(p))
                for p in parts
            ])
        return np.concatenate(parts)

    def repeat(self, n: int) -> "Dataset":
        return Dataset({k: self._cat([v] * n) for k, v in self._columns.items()})

    def concat(self, other: "Dataset") -> "Dataset":
        return Dataset(
            {
                k: self._cat([v, other._columns[k]])
                for k, v in self._columns.items()
            }
        )

    # -- partitioning (replaces Spark repartition/mapPartitions) ------------

    def partitions(self, num_partitions: int) -> list["Dataset"]:
        """Split rows into ``num_partitions`` near-equal contiguous shards —
        the index-space analogue of ``df.repartition(n)`` +
        ``mapPartitionsWithIndex`` in the reference trainers."""
        bounds = np.linspace(0, self._num_rows, num_partitions + 1, dtype=np.int64)
        return [self.slice(int(bounds[i]), int(bounds[i + 1])) for i in range(num_partitions)]

    def split(self, fraction: float, seed: int = 0) -> tuple["Dataset", "Dataset"]:
        """Random train/test split (replaces ``df.randomSplit``)."""
        perm = np.random.default_rng(seed).permutation(self._num_rows)
        cut = int(self._num_rows * fraction)
        return self.gather(perm[:cut]), self.gather(perm[cut:])

    def rows(self) -> Iterator[dict[str, np.ndarray]]:
        for i in range(self._num_rows):
            yield {k: v[i] for k, v in self._columns.items()}

    def head(self, n: int = 5) -> "Dataset":
        return self.take(min(n, self._num_rows))

    def describe(self) -> dict[str, dict[str, float]]:
        """Per-column summary stats for numeric columns (notebook aid)."""
        out: dict[str, dict[str, float]] = {}
        from distkeras_tpu_torch.data.sparse import SparseColumn

        for name, col in self._columns.items():
            if not np.issubdtype(col.dtype, np.number):
                continue
            if isinstance(col, SparseColumn):
                # Stats straight from CSR (the implicit zeros included) —
                # no densification.
                n_total = col.shape[0] * col.dim
                v = col.values.astype(np.float64)
                total = float(v.sum())
                mean = total / n_total
                var = (float((v * v).sum()) - n_total * mean * mean) / n_total
                has_zero = col.nnz < n_total
                vmin = float(v.min()) if col.nnz else 0.0
                vmax = float(v.max()) if col.nnz else 0.0
                out[name] = {
                    "min": min(0.0, vmin) if has_zero else vmin,
                    "max": max(0.0, vmax) if has_zero else vmax,
                    "mean": mean,
                    "std": float(np.sqrt(max(0.0, var))),
                }
                continue
            c = col.astype(np.float64)
            out[name] = {
                "min": float(c.min()),
                "max": float(c.max()),
                "mean": float(c.mean()),
                "std": float(c.std()),
            }
        return out

    def __repr__(self) -> str:
        spec = ", ".join(
            f"{k}: {v.dtype}{list(v.shape[1:])}" for k, v in self._columns.items()
        )
        return f"Dataset[{self._num_rows} rows; {spec}]"


def _maybe_numeric(col: np.ndarray, dtype) -> np.ndarray:
    try:
        return col.astype(dtype)
    except ValueError:
        return col

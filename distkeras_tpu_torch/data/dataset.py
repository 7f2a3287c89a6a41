"""Columnar in-memory dataset: a dict of named numpy columns on the host.

Counterpart of ``distkeras_tpu/data/dataset.py`` ``Dataset``. The port keeps
its own copy (numpy only) so that it never imports the reference package.
Sparse columns, the native CSV parser and the native row gather are not part
of this slice: columns are dense ndarrays and rows are gathered with numpy.
"""

from __future__ import annotations

import csv as _csv
from collections.abc import Iterator, Mapping, Sequence

import numpy as np

__all__ = ["Dataset"]


class Dataset:
    """An immutable named-column table backed by numpy arrays.

    Columns share a leading row dimension; a column may be any rank
    (e.g. ``features`` of shape ``[N, 784]`` or token ids ``[N, S]``).
    """

    def __init__(self, columns: Mapping[str, np.ndarray]):
        if not columns:
            raise ValueError("Dataset requires at least one column")
        self._columns: dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in columns.items()
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
        """Read a headered CSV. If ``features`` is given, those columns are
        stacked into one vector column ``features_col``."""
        with open(path, newline="") as f:
            rows = [r for r in _csv.reader(f) if r]
        if not rows:
            raise ValueError(f"empty CSV file: {path}")
        header, body = rows[0], rows[1:]
        table = {
            name: np.array([row[i] for row in body])
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
        with np.load(path) as d:
            return cls({k: d[k] for k in d.files})

    def to_npz(self, path: str, compressed: bool = False) -> None:
        save = np.savez_compressed if compressed else np.savez
        save(path, **self._columns)

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
        return Dataset({k: v[indices] for k, v in self._columns.items()})

    def shuffle(self, seed: int = 0) -> "Dataset":
        perm = np.random.default_rng(seed).permutation(self._num_rows)
        return self.gather(perm)

    def repeat(self, n: int) -> "Dataset":
        return Dataset({k: np.concatenate([v] * n) for k, v in self._columns.items()})

    def concat(self, other: "Dataset") -> "Dataset":
        return Dataset(
            {k: np.concatenate([v, other._columns[k]]) for k, v in self._columns.items()}
        )

    # -- partitioning -------------------------------------------------------

    def partitions(self, num_partitions: int) -> list["Dataset"]:
        """Split rows into ``num_partitions`` near-equal contiguous shards."""
        bounds = np.linspace(0, self._num_rows, num_partitions + 1, dtype=np.int64)
        return [self.slice(int(bounds[i]), int(bounds[i + 1])) for i in range(num_partitions)]

    def split(self, fraction: float, seed: int = 0) -> tuple["Dataset", "Dataset"]:
        perm = np.random.default_rng(seed).permutation(self._num_rows)
        cut = int(self._num_rows * fraction)
        return self.gather(perm[:cut]), self.gather(perm[cut:])

    def rows(self) -> Iterator[dict[str, np.ndarray]]:
        for i in range(self._num_rows):
            yield {k: v[i] for k, v in self._columns.items()}

    def head(self, n: int = 5) -> "Dataset":
        return self.take(min(n, self._num_rows))

    def describe(self) -> dict[str, dict[str, float]]:
        """Per-column summary stats for numeric columns."""
        out: dict[str, dict[str, float]] = {}
        for name, col in self._columns.items():
            if not np.issubdtype(col.dtype, np.number):
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

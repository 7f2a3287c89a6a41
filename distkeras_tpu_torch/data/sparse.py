"""Row-sparse (CSR) feature columns.

Counterpart of ``distkeras_tpu/data/sparse.py`` (numpy only; the port keeps
its own copy). :class:`SparseColumn` is one CSR triple (``indptr [N+1]``,
``indices``, ``values``) plus the dense width: an ``[N, dim]`` logically
dense float matrix held at ``O(nnz)`` memory, the stand-in for the Spark
MLlib *SparseVector* columns that hashing and one-hot featurization produce.

A ``SparseColumn`` takes part in
:class:`~distkeras_tpu_torch.data.dataset.Dataset` like any ndarray column:
row slicing, gathering and concat keep it sparse (so shuffles and partition
splits never densify), and ``np.asarray`` densifies it (``__array__``),
which is what the minibatch feed does if training runs on a still-sparse
column. The explicit conversion is ``DenseTransformer`` or
:meth:`SparseColumn.to_dense`.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

__all__ = ["SparseColumn"]


class SparseColumn:
    """CSR row-sparse ``[N, dim]`` float column."""

    def __init__(
        self,
        indptr: np.ndarray,
        indices: np.ndarray,
        values: np.ndarray,
        dim: int,
    ):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.values = np.asarray(values)
        if self.values.dtype.kind != "f":
            self.values = self.values.astype(np.float32)
        self.dim = int(dim)
        if self.indptr.ndim != 1 or self.indptr[0] != 0:
            raise ValueError("indptr must be 1-D and start at 0")
        if self.indices.shape != self.values.shape:
            raise ValueError("indices/values length mismatch")
        if int(self.indptr[-1]) != self.indices.shape[0]:
            raise ValueError("indptr[-1] != nnz")
        if self.indices.size and int(self.indices.max()) >= self.dim:
            raise ValueError("column index out of range")

    # -- construction --------------------------------------------------------

    @classmethod
    def from_dense(cls, arr: np.ndarray) -> "SparseColumn":
        arr = np.asarray(arr)
        if arr.ndim != 2:
            raise ValueError(f"need [N, dim], got shape {arr.shape}")
        rows, cols = np.nonzero(arr)
        counts = np.bincount(rows, minlength=arr.shape[0])
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return cls(indptr, cols, arr[rows, cols], arr.shape[1])

    @classmethod
    def from_rows(
        cls,
        rows: Sequence[tuple[Sequence[int], Sequence[float]]],
        dim: int,
    ) -> "SparseColumn":
        """From per-row ``(indices, values)`` pairs — the shape of the
        reference's SparseVector (``size``, ``indices``, ``values``)."""
        indptr = np.zeros(len(rows) + 1, np.int64)
        idx_parts, val_parts = [], []
        for i, (idx, val) in enumerate(rows):
            idx = np.asarray(idx, dtype=np.int32)
            val = np.asarray(val, dtype=np.float32)
            if idx.shape != val.shape:
                raise ValueError(f"row {i}: indices/values length mismatch")
            indptr[i + 1] = indptr[i] + idx.size
            idx_parts.append(idx)
            val_parts.append(val)
        cat = lambda parts, dt: (
            np.concatenate(parts) if parts else np.zeros(0, dt)
        )
        return cls(
            indptr, cat(idx_parts, np.int32), cat(val_parts, np.float32), dim
        )

    # -- ndarray-like protocol ----------------------------------------------

    @property
    def shape(self) -> tuple[int, int]:
        return (self.indptr.shape[0] - 1, self.dim)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def nbytes(self) -> int:
        return self.indptr.nbytes + self.indices.nbytes + self.values.nbytes

    def __len__(self) -> int:
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        dense = self.to_dense()
        return dense.astype(dtype) if dtype is not None else dense

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, self.values.dtype)
        rows = np.repeat(
            np.arange(len(self)), np.diff(self.indptr).astype(np.int64)
        )
        out[rows, self.indices] = self.values
        return out

    def astype(self, dtype) -> "SparseColumn":
        return SparseColumn(
            self.indptr, self.indices, self.values.astype(dtype), self.dim
        )

    def __getitem__(self, key):
        """Row selection: an int returns the dense row vector (ndarray
        parity for ``Dataset.rows()``); a slice or integer array returns a
        ``SparseColumn`` — the shuffle/gather/partition paths never
        densify."""
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += len(self)  # numpy-parity negative indexing
            if not 0 <= i < len(self):
                raise IndexError(f"row {key} out of range for {len(self)} rows")
            row = np.zeros(self.dim, self.values.dtype)
            s, e = int(self.indptr[i]), int(self.indptr[i + 1])
            row[self.indices[s:e]] = self.values[s:e]
            return row
        if isinstance(key, slice):
            key = np.arange(*key.indices(len(self)))
        key = np.asarray(key)
        if key.ndim != 1:
            raise TypeError("SparseColumn supports 1-D row selection only")
        if key.dtype == np.bool_:
            # ndarray parity for boolean masks: length must match, then the
            # mask selects rows (the arithmetic below needs integer rows —
            # a raw bool mask would index the length-(N+1) indptr wrongly).
            if key.size != len(self):
                raise IndexError(
                    f"boolean mask length {key.size} != {len(self)} rows"
                )
            key = np.flatnonzero(key)
        key = np.where(key < 0, key + len(self), key)  # ndarray parity
        if key.size and (key.min() < 0 or key.max() >= len(self)):
            raise IndexError(f"row index out of range for {len(self)} rows")
        starts = self.indptr[key]
        counts = (self.indptr[key + 1] - starts).astype(np.int64)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        # Ragged range gather without a Python per-row loop: for each
        # output slot, its source = row_start + offset_within_row.
        total = int(counts.sum())
        take = (
            np.repeat(starts, counts)
            + np.arange(total) - np.repeat(indptr[:-1], counts)
        )
        return SparseColumn(
            indptr, self.indices[take], self.values[take], self.dim
        )

    def concat(self, other: "SparseColumn") -> "SparseColumn":
        return SparseColumn.concat_all([self, other])

    @staticmethod
    def concat_all(parts: Sequence["SparseColumn"]) -> "SparseColumn":
        """Concatenate many columns in ONE pass (a pairwise fold would
        re-copy the accumulated nnz arrays per step — O(n²) for repeat)."""
        dims = {p.dim for p in parts}
        if len(dims) != 1:
            raise ValueError(f"dim mismatch: {sorted(dims)}")
        offsets = np.cumsum([0] + [p.nnz for p in parts[:-1]])
        indptr = np.concatenate(
            [parts[0].indptr]
            + [p.indptr[1:] + off for p, off in zip(parts[1:], offsets[1:])]
        )
        return SparseColumn(
            indptr,
            np.concatenate([p.indices for p in parts]),
            np.concatenate([p.values for p in parts]),
            parts[0].dim,
        )

    def __repr__(self) -> str:
        n, d = self.shape
        return f"SparseColumn([{n}, {d}], nnz={self.nnz}, {self.dtype})"

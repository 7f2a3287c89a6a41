"""Integer seeds for independent random streams.

The reference derives per-step and per-layer dropout keys with
``jax.random.fold_in``. The port seeds a ``torch.Generator`` per use from a
plain integer instead, and :func:`fold_in` is how one seed becomes many:
the step's seed from the run's, a micro-batch's from the step's, a dropout
site's from the forward's. The bits differ from JAX's; the structure is the
same. :func:`worker_seed` is the reference's formula, bit for bit, so a
worker's shuffled partition follows the reference's order.
"""

from __future__ import annotations

__all__ = ["fold_in", "worker_seed"]

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data``: distinct ``data`` give
    unrelated seeds, the same pair always the same one."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (data & _MASK64)) >> 1


def worker_seed(seed: int, worker_index: int) -> int:
    """A distinct, deterministic integer seed per worker (the reference's
    ``distkeras_tpu/utils/rng.py worker_seed``)."""
    return (seed * 1_000_003 + worker_index * 7919) % (2**31 - 1)

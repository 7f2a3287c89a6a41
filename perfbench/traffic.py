"""The one generator of training traffic: a pool of rows from the seed.

A mix (``perfbench/traffic/<name>.json``) gives the objective, the batch a
rank takes, the sequence length, the ranks, and for masked language
modelling the share of positions masked and BERT's 80/10/10 split. The pool
holds ``pool_batches`` global batches of rows drawn from the seed; the
window's feed takes batches from it epoch after epoch, reshuffled, so every
seed has the same sizes and the same work, and the first epoch's rows all
differ.

- ``"mlm"``: token ids uniform over the configuration's word ids; in each
  row ``round(mask_rate * seq)`` positions are chosen, of which each becomes
  the mask token, a random word or stays, with the probabilities of
  ``mask_split``. The label of every position is its original token: the
  loss averages every position.
- ``"clm"``: rows of ``seq + 1`` uniform ids over the vocabulary; the
  features are the first ``seq``, the labels the last ``seq`` (next-token).
"""

from __future__ import annotations

import numpy as np


def pool_rows(traffic: dict) -> int:
    return traffic["pool_batches"] * traffic["batch"] * traffic["ranks"]


def make_pool(traffic: dict, cfg: dict, seed: int) -> dict[str, np.ndarray]:
    """``{"features": [N, seq], "label": [N, seq]}`` int32 rows from ``seed``."""
    rng = np.random.default_rng(seed)
    n, S, V = pool_rows(traffic), traffic["seq"], cfg["vocab_size"]
    if traffic["objective"] == "clm":
        tokens = rng.integers(0, V, size=(n, S + 1), dtype=np.int32)
        return {"features": np.ascontiguousarray(tokens[:, :S]),
                "label": np.ascontiguousarray(tokens[:, 1:])}
    if traffic["objective"] != "mlm":
        raise ValueError(f"unknown objective {traffic['objective']!r}")
    lo = cfg["first_word_id"]
    label = rng.integers(lo, V, size=(n, S), dtype=np.int32)
    k = int(round(traffic["mask_rate"] * S))
    # k distinct positions a row: the first k of a random order of the row.
    picked = np.argsort(rng.random((n, S)), axis=1)[:, :k]
    mask_p, random_p, _ = traffic["mask_split"]
    u = rng.random((n, k))
    random_words = rng.integers(lo, V, size=(n, k), dtype=np.int32)
    rows = np.arange(n)[:, None]
    features = label.copy()
    chosen = label[rows, picked]
    chosen = np.where(u < mask_p, np.int32(cfg["mask_token_id"]),
                      np.where(u < mask_p + random_p, random_words, chosen))
    features[rows, picked] = chosen
    return {"features": features, "label": label}

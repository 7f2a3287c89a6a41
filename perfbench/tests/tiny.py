"""A cell of the manifest cut to a size a CPU test run holds: the bert
family's tiny presets (hidden 128, 2 layers, 4 heads, vocabulary 1024), 8
rows of 32 tokens a rank, the cell's own limits and metrics."""

from __future__ import annotations

import copy

from perfbench import manifest


def tiny_spec(cell: str = "bert_base.train_s128_b256", ranks: int = 1,
              dtype: str = "bfloat16") -> dict:
    spec = copy.deepcopy(manifest.cell(cell))
    cfg = spec["config"]
    causal = cfg["causal"]
    cfg.update(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=512, vocab_size=1024, max_position_embeddings=64,
               dtype=dtype)
    cfg["port"]["constructor"] = "gpt_tiny" if causal else "bert_tiny_mlm"
    cfg["port"]["overrides"]["dtype"] = dtype
    if not causal:
        cfg.update(first_word_id=8, mask_token_id=3)
    spec["traffic"].update(batch=8, seq=32, ranks=ranks, pool_batches=4)
    return spec

#!/usr/bin/env python3
"""Does an idle RankPool slow the phases that run beside it?

    python3 scripts/pool_idle_chip.py

``chip_smoke.py`` spawns its four ranks (``chip_smoke.RankPool``) while
phase 1 builds the kernels; they hold a CUDA context each and wait, idle,
through phases 2-16. This times two host-bound paths of the main process
on the card, without the pool and with it, in the order without, with,
with, without: gpt_small's decode step (phase 12's loop, batch 8, a
128-token prompt, 127 steps, synchronized; the median) and bert_base_mlm's
steady train step (phase 5's, 32 x 128, 8 steps). Prints one line a run
with the card's name and power limit.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def decode_ms(model, variables, prompts) -> float:
    """Phase 12's loop: the median ms of 127 synchronized decode steps."""
    import torch

    from distkeras_tpu_torch.inference import generate as gen

    dec, dec_cfg = gen._decode_module(model)
    steps = []
    with torch.inference_mode():
        cache = gen._empty_cache(dec_cfg, prompts.shape[0], "cuda")
        logits, cache = gen._step(dec, variables, cache, prompts)
        tok = gen.greedy_ids(logits)
        torch.cuda.synchronize()
        for _ in range(127):
            t0 = time.perf_counter()
            logits, cache = gen._step(dec, variables, cache, tok[:, None])
            tok = gen.greedy_ids(logits)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(steps)


def train_ms(state, step, batches) -> tuple[float, object]:
    """Phase 5's steady step: 2 untimed, then the mean ms of 8."""
    import torch

    for i in range(2):
        state, _ = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(8):
        state, _ = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 8 * 1e3, state


def main() -> int:
    import numpy as np
    import torch

    from distkeras_tpu_torch.data.feed import DeviceFeed, minibatches
    from distkeras_tpu_torch.models import bert
    from distkeras_tpu_torch.ops.losses import get_optimizer
    from distkeras_tpu_torch.training.step import TrainState, make_train_step
    from distkeras_tpu_torch.utils.build import build_all

    if not torch.cuda.is_available():
        print("pool_idle_chip: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    card = cs.card_line()
    gpt = bert.gpt_small()
    gpt_vars = gpt.init(cs.SEED)
    prompts = torch.as_tensor(np.random.default_rng(cs.SEED).integers(
        0, gpt.config.vocab_size, size=(8, 128)).astype(np.int32), device="cuda")
    model, _, data = cs.bert_copy_task(128, 256)
    state = TrainState.create(model, get_optimizer("adam"), cs.SEED)
    step = make_train_step(model, "fused_categorical_crossentropy")
    batches = list(DeviceFeed(minibatches(data, 32)))
    decode_ms(gpt, gpt_vars, prompts)  # warm-up
    pool = None
    for run, with_pool in enumerate((False, True, True, False)):
        if with_pool and pool is None:
            pool = cs.RankPool(REPO)
            pool.wait_ready()
        if not with_pool and pool is not None:
            pool.close()
            pool = None
        d = decode_ms(gpt, gpt_vars, prompts)
        t, state = train_ms(state, step, batches)
        print(f"run {run}: {'with' if with_pool else 'without'} the idle pool: gpt_small "
              f"decode step median {d:.3f} ms, bert_base_mlm train step {t:.2f} ms "
              f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

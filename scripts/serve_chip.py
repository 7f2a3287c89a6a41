#!/usr/bin/env python3
"""Multi-device serving on the card, beside chip_smoke.py's phase 21.

    python3 scripts/serve_chip.py phase21       # one card: chip_smoke's phase 21 alone
    python3 scripts/serve_chip.py cards         # four cards, one NCCL rank each
    python3 scripts/serve_chip.py cards --cpu   # the same on the CPU over gloo, a tiny model

``phase21`` makes phase 14's gpt_small weights and greedy prompts (without
running phase 14) and runs ``chip_smoke.mesh_phase``. ``cards`` runs phase
21's serving task (``chip_smoke.mesh_gloo_task``) on four ranks over NCCL:
gpt_small (its vocabulary padded to 50304 for the tp splits) at tp=4, at
tp=2 x pp=2, and at pp=4 with pipeline_depth 4 (the published 50257; two
slots a micro-batch), then ``generate`` on a dp=4 mesh. Each case's
greedy tokens are held against one rank's plain engine (partings only at
bf16 ties), the decode step must compile once on every rank, and each
rank's tokens/s, ms per decode tick, collective share, bubble_fraction
and peak memory are logged. Exits non-zero when a check fails.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

CARDS = (("c-tp4", {"tp": 4}, {}, cs.MESH_TP_VOCAB),
         ("c-tp2pp2", {"tp": 2, "pp": 2}, {}, cs.MESH_TP_VOCAB),
         ("c-pp4", {"tp": 1, "pp": 4}, {"pipeline_depth": 4}, None))
CPU = (("c-tp4", {"tp": 4}, {}, 128),
       ("c-tp2pp2", {"tp": 2, "pp": 2}, {}, 128),
       ("c-tp2pp2-d4", {"tp": 2, "pp": 2}, {"pipeline_depth": 4}, 128))


def _served(spec, device, requests=8) -> dict:
    """Phase 14's weights and greedy prompts, as ``serving_phase`` leaves
    them, without serving them."""
    from distkeras_tpu_torch.models import bert

    model = getattr(bert, spec[0])(**spec[1])
    prompts, temps, _ = cs.serving_requests(model.config.vocab_size)
    if spec[0] != "gpt_small":  # the CPU's tiny model: short prompts
        prompts = [p[:24] for p in prompts]
    return {"model": model, "variables": model.init(cs.SEED, device=device),
            "prompts": prompts, "temps": temps}


def phase21() -> bool:
    cs.mesh_phase(_served(("gpt_small", {}), "cuda"))
    return True


def cards(cpu: bool) -> bool:
    if cpu:
        spec, device, backend, cases = ("gpt_tiny", {"seq_len": 64, "vocab_size": 64}), "cpu", \
            "gloo", CPU
        kw = dict(slots=8, max_queue=64, prefix_cache_mb=4, prefix_block_tokens=4,
                  prefill_chunk=8, top_k=50, seed=cs.SEED)
        new = 8
    else:
        spec, device, backend, cases = ("gpt_small", {}), "cuda", None, CARDS
        kw = dict(slots=8, max_queue=64, prefix_cache_mb=64, prefix_block_tokens=16,
                  prefill_chunk=128, top_k=50, seed=cs.SEED)
        new = cs.MESH_NEW
    import numpy as np

    from distkeras_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    served = _served(spec, device)
    greedy = [p for p, t in zip(served["prompts"], served["temps"]) if t <= 0][:8]
    wave = [[(p, new, 0.0) for p in greedy]]
    models, want = {}, {}
    for vocab in {c[3] for c in cases}:
        m, v = cs._mesh_model(spec, vocab, device, models, only=False)
        want[vocab], _ = cs._run_requests(ServingEngine(m, v, device=device, **kw), wave)
    gen_len = min(len(p) for p in greedy)
    gen_prompt = np.asarray([p[:gen_len] for p in greedy], np.int32)
    ranks = cs.dp_spawn(REPO, "cards", backend, 4, "mesh_gloo_task", prompts=greedy,
                        gen_prompt=gen_prompt.tolist(), new=new, kw=kw, cases=cases,
                        device=device, model=spec)
    ok = True
    for tag, shape, extra, vocab in cases:
        lead = ranks[0][tag]
        m, v = models[vocab]
        try:
            matched = cs._greedy_parts_at_ties(tag, m, v, greedy, lead["outs"], want[vocab])
        except AssertionError as e:
            cs.log(f"{tag}: {e}")
            ok, matched = False, [0]
        ok &= lead["compiles"] == [1] * 4
        for r, rep in enumerate(ranks):
            rep = rep[tag]
            shares = ", ".join(f"{k} {s / rep['wall_s']:.1%}" for k, s in
                               rep["collective_s"].items() if s)
            cs.log(f"{tag} mesh {shape} {extra or ''} rank {r} ({ranks[0]['backend']}, one rank a "
                   f"card): " + (f"{rep['tokens_per_s']:.1f} tokens/s, {rep['ticks']} decode "
                                 f"ticks at {rep['ms_per_tick']:.2f} ms, " if r == 0 else
                                 f"{rep['ops']} operations, ")
                   + f"wall {rep['wall_s']:.2f} s, collectives {rep['collective_share']:.1%} "
                   f"({shares or 'none'}), peak memory {rep['peak_mib']:.1f} MiB"
                   + (f", bubble_fraction {rep['bubble']:.3f}"
                      if r == 0 and rep.get("bubble") is not None else ""))
        cs.log(f"{tag}: greedy tokens equal to the plain engine's over {sum(matched)}/"
               f"{sum(map(len, want[vocab]))}; decode compile counts {lead['compiles']}")
    for r, rep in enumerate(ranks):
        ok &= rep["21f"]["tokens"] == ranks[0]["21f"]["tokens"]
        cs.log(f"generate on a dp=4 mesh, rank {r}: {rep['21f']['wall_s']:.2f} s")
    cs.log(f"backend {ranks[0]['backend']}, ok {ok}, {time.perf_counter() - t0:.2f} s")
    return ok


def main(argv) -> int:
    if argv[:1] == ["cards"] and argv[1:] == ["--cpu"]:
        cs.card_line = lambda: "cpu"
        return 0 if cards(cpu=True) else 1
    import torch

    if len(argv) != 1 or argv[0] not in ("phase21", "cards"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("serve_chip: no CUDA device", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}")
    run = {"phase21": phase21, "cards": lambda: cards(cpu=False)}[argv[0]]
    return 0 if run() else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

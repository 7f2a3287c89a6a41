#!/usr/bin/env python3
"""MoE and expert parallelism on the card, beside chip_smoke.py's phases 22
and 25.

    python3 scripts/moe_chip.py phase22       # one card: phase 2's 22a shapes, then phase 22
    python3 scripts/moe_chip.py phase25       # one card: phase 25 (MoE with tp and sp)
    python3 scripts/moe_chip.py cards         # four cards, one NCCL rank each
    python3 scripts/moe_chip.py cards --cpu   # the same over gloo on the CPU, a tiny model

``phase22`` builds the kernels (phase 1), runs phase 2's K1-K6 cases at
22a's shapes (B=32 S=64 H=4 D=32; [2048, 1024] float32 logits) and
``chip_smoke.moe_phase``. ``cards`` runs phase 22c's task
(``chip_smoke.moe_ep_task``) at ``{"ep": 4}`` on phase 22b's model
(bert_base_mlm's config with 8 experts at top-2, each rank 2 of them; 32 x
128 tokens, adam, fused loss, 3 steps on one global batch repeated), one
NCCL rank a card, and holds it to 22c's checks (``chip_smoke.moe_ep_report``):
each rank's ms per step and the ep_all_reduce span's share of it, the
losses (finite, equal on every rank, within LOSS_RTOL of SingleTrainer's
on rank 0), the replicated leaves equal, the launches (12 of K1-K3 and 1
of K4-K6 a step), and the first step's gradients, gathered whole, against
one process's on rank 0, within phase 17's bound. ``cards`` then runs
phase 25's 25a (``{"tp": 2, "ep": 2}``) and 25b (``{"sp": 2, "ep": 2}``
under the XLA split) at the model's full depth of 12 layers, one NCCL rank
a card, held to phase 25's checks (``chip_smoke.moe_tpsp_phase``).
``phase25`` builds the kernels and runs phase 25 as ``chip_smoke.py`` does
(four gloo ranks sharing the one card). Exits non-zero when a check
fails.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def phase22() -> bool:
    import torch

    from distkeras_tpu_torch.ops.flash_attention import flash_forward
    from distkeras_tpu_torch.ops.fused_xent import fused_softmax_xent
    from distkeras_tpu_torch.utils.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q = torch.randn(1, 64, 64, device="cuda", generator=gen).bfloat16().requires_grad_()
    flash_forward(q, q, q)[0].sum().backward()
    for dt in (torch.float32, torch.bfloat16):
        x = torch.zeros(2, 8, device="cuda", dtype=dt, requires_grad=True)
        fused_softmax_xent(x, torch.zeros(2, dtype=torch.long, device="cuda")).backward()
    cs.flash_case(32, 64, 4, 32, False, 0, gen)
    cs.flash_bwd_cases(32, 64, 4, 32, False, 0, gen)
    cs.xent_case(2048, 1024, torch.float32, gen)
    cs.xent_bwd_cases(2048, 1024, torch.float32, gen)
    counts = cs.moe_phase()
    cs.log(f"phase 22 launches {counts}")
    return all(n > 0 for n in counts.values())


def phase25() -> bool:
    from distkeras_tpu_torch.utils.build import build_all

    build_all()
    counts = cs.moe_tpsp_phase()
    cs.log(f"phase 25 launches {counts}")
    return all(n > 0 for n in counts.values())


def cards(cpu: bool) -> bool:
    if cpu:  # 22a's top-2 model: one of its 4 experts a rank
        backend, device, base = "gloo", "cpu", False
    else:
        from distkeras_tpu_torch.utils.build import build_all

        build_all()
        backend, device, base = None, "cuda", True
    t0 = time.perf_counter()
    ranks = cs.dp_spawn(REPO, "ep4", backend, 4, "moe_ep_task", base=base, device=device)
    cs.moe_ep_report("ep=4", ranks, cs.moe_model(2, base=base)[1], not cpu,
                     "gloo on the CPU" if cpu else "one NCCL rank a card")
    cs.log(f"ep=4: {time.perf_counter() - t0:.2f} s")
    # 25a and 25b at full depth (the tiny model's is 2 layers).
    cs.moe_tpsp_phase(REPO, cases=cs.MOE_TPSP_CASES[:2], base=base, layers=2 if cpu else 12,
                      device=device, backend=backend,
                      where="on the CPU" if cpu else "one rank a card")
    cs.log(f"ok, {time.perf_counter() - t0:.2f} s")
    return True


def main(argv) -> int:
    if argv[:1] == ["cards"] and argv[1:] == ["--cpu"]:
        cs.card_line = lambda: "cpu"
        return 0 if cards(cpu=True) else 1
    import torch

    if len(argv) != 1 or argv[0] not in ("phase22", "phase25", "cards"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("moe_chip: no CUDA device", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}")
    run = {"phase22": phase22, "phase25": phase25, "cards": lambda: cards(cpu=False)}[argv[0]]
    return 0 if run() else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

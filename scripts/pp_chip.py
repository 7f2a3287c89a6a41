#!/usr/bin/env python3
"""Pipeline parallelism on the card, beside chip_smoke.py's phase 20.

    python3 scripts/pp_chip.py phase20       # one card: the 1F1B loss kernel cases, then phase 20
    python3 scripts/pp_chip.py cards         # four cards, one NCCL rank each
    python3 scripts/pp_chip.py cards --cpu   # the same on the CPU over gloo, a tiny model

``phase20`` builds the kernels (phase 1), runs phase 2's K4-K6 cases at a
1F1B microbatch's logits (T=1024 V=30522 float32) and
``chip_smoke.pp_phase``. ``cards`` runs phase 20's two-rank task
(``chip_smoke.pp_gloo_task``) on four ranks over NCCL at pp=4 (gpipe,
gpipe with remat, virtual_stages=3, 1f1b; 3 layers a rank) and at
dp=2 x pp=2 (gpipe, 1f1b) on bert_base_mlm: each rank's ms per step, span
shares, losses and launches against ``chip_smoke.pp_launches``, the
losses against the one-process step's and the first-step gradients
against it, held to phase 20's bounds. Exits non-zero when a check fails.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

CARDS = (("p4-gpipe", "gpipe", {}), ("p4-remat", "gpipe", {"remat": True}),
         ("p4-v3", "gpipe", {"virtual_stages": 3}), ("p4-1f1b", "1f1b", {}))
CARDS_DPPP = (("d2p2-gpipe", "gpipe", {}), ("d2p2-1f1b", "1f1b", {}))
CPU = (("p4-gpipe", "gpipe", {}), ("p4-1f1b", "1f1b", {}))


def phase20() -> bool:
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
    cs.xent_case(1024, 30522, torch.float32, gen)
    cs.xent_bwd_cases(1024, 30522, torch.float32, gen)
    cs.pp_phase()
    return True


def _report(tag, ranks, cases, P, model_name, seq, batch, steps, M, counting) -> bool:
    ok = True
    cfg = cs.bert_copy_task(seq, batch, name=model_name)[1]
    for name, schedule, kw in cases:
        r0 = ranks[0][name]
        gaps = {}
        for r, rep in enumerate(ranks):
            rep = rep[name]
            index = r % P
            shares = ", ".join(f"{k[:-6]} {rep[k]:.1%}" for k in rep
                               if k.endswith("_share") and rep[k])
            cs.log(f"{tag} {name} rank {r} (pp index {index}): {rep['ms_per_step']:.2f} ms/step "
                   f"(steps {', '.join(f'{x:.1f}' for x in rep['step_ms'])}); {shares}; "
                   f"{rep['p2p_calls']} pp_p2p calls (median {rep['p2p_call_ms'][0]:.2f} ms, max "
                   f"{rep['p2p_call_ms'][1]:.2f} ms), staged {rep['staged']}; losses "
                   f"{rep['losses']}; launches {list(rep['counts'].values())}")
            ok &= rep["losses"] == r0["losses"] and all(
                b < a for a, b in zip(rep["losses"], rep["losses"][1:]))
            ok &= rep["replicated_sums"] == r0["replicated_sums"] and rep["whole"]
            if counting:
                ok &= rep["counts"] == cs.pp_launches(cfg, steps, M, P, index, schedule,
                                                      kw.get("remat", False))
            gaps.update({k: tuple(v) for k, v in rep["gaps"].items()})
        rel = sorted(v[0] for v in gaps.values())
        worst = max(gaps, key=lambda k: gaps[k][0] / gaps[k][1])
        cs.log(f"{tag} {name}: first-step gradients against one process: median "
               f"{rel[len(rel) // 2]:.3g}, worst {worst} {gaps[worst][0]:.3g} (allowed "
               f"{gaps[worst][1]:.3g})")
        ok &= rel[len(rel) // 2] <= cs.PP_GRAD_MEDIAN_TOL and gaps[worst][0] <= gaps[worst][1]
    return ok


def cards(cpu: bool) -> bool:
    if cpu:
        cases, dppp, backend, device = CPU, CPU, "gloo", "cpu"
        model_name, seq, batch = "gpt_tiny", 32, 8
        layers = 2
    else:
        from distkeras_tpu_torch.utils.build import build_all

        build_all()
        cases, dppp, backend, device = CARDS, CARDS_DPPP, None, "cuda"
        model_name, seq, batch = "bert_base_mlm", 128, 32
        layers = 12
    steps, M = 3, cs.PP_MICROBATCHES
    t0 = time.perf_counter()
    common = dict(seq=seq, batch=batch, steps=steps, model_name=model_name, device=device,
                  M=M, memory_m=())
    ok = True
    if layers % 4 == 0:
        ranks = cs.dp_spawn(REPO, "pp4", backend, 4, "pp_gloo_task", cases=cases, **common)
        ok &= _report("pp=4", ranks, cases, 4, model_name, seq, batch, steps, M, not cpu)
    ranks = cs.dp_spawn(REPO, "dp2pp2", backend, 4, "pp_gloo_task", cases=dppp,
                        axes={"dp": 2, "pp": 2}, **common)
    ok &= _report("dp=2 x pp=2", ranks, dppp, 2, model_name, seq, batch, steps, M, not cpu)
    cs.log(f"backend {ranks[0]['backend']}, ok {ok}, {time.perf_counter() - t0:.2f} s")
    return ok


def main(argv) -> int:
    if argv[:1] == ["cards"] and argv[1:] == ["--cpu"]:
        cs.card_line = lambda: "cpu"
        return 0 if cards(cpu=True) else 1
    import torch

    if len(argv) != 1 or argv[0] not in ("phase20", "cards"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("pp_chip: no CUDA device", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}")
    run = {"phase20": phase20, "cards": lambda: cards(cpu=False)}[argv[0]]
    return 0 if run() else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

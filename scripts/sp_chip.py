#!/usr/bin/env python3
"""Sequence parallelism on the card, beside chip_smoke.py's phase 19.

    python3 scripts/sp_chip.py probe     # one card: gloo P2P and all-to-all on CUDA tensors
    python3 scripts/sp_chip.py phase19   # one card: the ring-hop kernel cases, then phase 19
    python3 scripts/sp_chip.py phase23   # one card: phase 1's build, then phase 23
    python3 scripts/sp_chip.py cards     # four cards, one NCCL rank each
    python3 scripts/sp_chip.py cards23   # four cards: phase 23's cases alone
    python3 scripts/sp_chip.py cards --cpu   # the same on the CPU over gloo, tiny models

``probe`` starts two gloo ranks on the card and tries ``batch_isend_irecv``
and ``all_to_all_single`` on CUDA tensors, unstaged, each in ranks of its
own so that an abort is reported, not fatal: the reason ``sp_permute``
stages P2P through the host under gloo and ``sp_all_to_all`` does not.
``phase19`` builds the kernels (phase 1), runs phase 2's K1-K3 cases at a
ring hop's shape (B=8 S=256 H=12 D=64; causal, full, strict causal) and
``chip_smoke.sp_phase``. ``cards`` runs phase 19's two-rank task
(``chip_smoke.sp_gloo_task``) on four ranks over NCCL at sp=4 (gpt_small
``ring`` and ``ring_stripe``, bert_base_mlm ``ulysses``) and at dp=2 x sp=2
(``ring_stripe``) and at sp=2 x tp=2 (phase 23b's gpt_small ``ring`` and
``ulysses``): each rank's ms per step, span shares, losses and launches;
rank 0's losses against SingleTrainer's and first-step gradients against
one process, held to phase 19's bounds; then phase 23d's islands in one
process, DynSGD with 2 workers x 2 cards (``chip_smoke.island_phase``).
``cards23`` runs the last two alone (``cards23 --cpu`` on the CPU).
``phase23`` builds the kernels and runs ``chip_smoke.sp_remainder_phase``.
Exits non-zero when a check fails.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

CARDS = (("s4-ring", "gpt_small", 512, 8, "ring"),
         ("s4-stripe", "gpt_small", 512, 8, "ring_stripe"),
         ("s4-ulysses", "bert_base_mlm", 128, 32, "ulysses"))
CARDS_DPSP = (("d2s2-stripe", "gpt_small", 512, 8, "ring_stripe"),)
CPU = (("s4-ring", "gpt_tiny", 64, 4, "ring"), ("s4-stripe", "gpt_tiny", 64, 4, "ring_stripe"),
       ("s4-ulysses", "bert_tiny_mlm", 32, 8, "ulysses"))
CPU_DPSP = (("d2s2-stripe", "gpt_tiny", 64, 4, "ring_stripe"),)
CPU_SPTP = (("s2t2-ring", "gpt_tiny", 64, 4, "ring"),
            ("s2t2-ulysses", "gpt_tiny", 64, 4, "ulysses"))
CPU_ISLAND = {"seq": 32, "batch": 4, "window": 2, "windows": 2, "model_name": "bert_tiny_mlm"}


def _probe_rank(rank, world, store, what, out):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    if what == "p2p":
        x = torch.full((1024,), float(rank + 1), device="cuda")
        r = torch.empty_like(x)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (rank + 1) % world),
                                            dist.P2POp(dist.irecv, r, (rank - 1) % world)]):
            work.wait()
        got = r[0].item() == float((rank - 1) % world + 1)
    else:
        x = torch.arange(world, dtype=torch.float32, device="cuda") + 10 * rank
        r = torch.empty_like(x)
        dist.all_to_all_single(r, x)
        got = r.tolist() == [10.0 * j + rank for j in range(world)]
    out.put((rank, got))
    dist.destroy_process_group()


def probe() -> bool:
    ctx = multiprocessing.get_context("spawn")
    for what in ("p2p", "all_to_all"):
        store = os.path.join(cs.CKPT_ROOT, f"probe-{what}")
        os.makedirs(cs.CKPT_ROOT, exist_ok=True)
        if os.path.exists(store):
            os.remove(store)
        out = ctx.Queue()
        procs = [ctx.Process(target=_probe_rank, args=(r, 2, store, what, out)) for r in range(2)]
        for p in procs:
            p.start()
        results = {}
        try:
            for _ in procs:
                rank, got = out.get(timeout=60)
                results[rank] = got
        except Exception:  # a rank died (an abort) or hung: report, do not raise
            pass
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        cs.log(f"gloo {what} on CUDA tensors, unstaged: results {results}, exit codes "
               f"{[p.exitcode for p in procs]}")
    return True


def phase19() -> bool:
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
    for causal, shift in ((True, 0), (False, 0), (True, 1)):
        cs.flash_case(8, 256, 12, 64, causal, shift, gen)
        cs.flash_bwd_cases(8, 256, 12, 64, causal, shift, gen)
    cs.sp_phase()
    return True


def phase23() -> bool:
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
    cs.log(f"phase 23 launches {cs.sp_remainder_phase()}")
    return True


def _report(tag, ranks, cases) -> bool:
    ok = True
    for name, _, _, _, _ in cases:
        r0 = ranks[0][name]
        for r, rep in enumerate(ranks):
            rep = rep[name]
            shares = ", ".join(f"{k[:-6]} {rep[k]:.1%}" for k in rep
                               if k.endswith("_share") and rep[k])
            cs.log(f"{tag} {name} rank {r}: {rep['ms_per_step']:.2f} ms/step; {shares}; staged "
                   f"{rep['staged']}; losses {rep['losses']}; launches "
                   f"{list(rep['counts'].values())}")
            ok &= rep["losses"] == r0["losses"] and all(
                b < a for a, b in zip(rep["losses"], rep["losses"][1:]))
            ok &= rep["replicated_sums"] == r0["replicated_sums"] and rep["whole"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["single_losses"]))
        g = r0["grads"]
        cs.log(f"{tag} {name}: vs SingleTrainer {r0['single_losses']} gap {gap:.3g}; grads "
               f"median {g['median']:.3g} worst {g['worst']} {g['worst_rel']:.3g} (allowed "
               f"{g['worst_allowed']:.3g})")
        ok &= gap <= cs.LOSS_RTOL and g["worst_rel"] <= g["worst_allowed"]
    return ok


def cards(cpu: bool, only23: bool = False) -> bool:
    if cpu:
        cases, dpsp, backend, device = CPU, CPU_DPSP, "gloo", "cpu"
        sptp, vocab, island = CPU_SPTP, None, dict(CPU_ISLAND, device="cpu")
    else:
        from distkeras_tpu_torch.utils.build import build_all

        build_all()
        cases, dpsp, backend, device = CARDS, CARDS_DPSP, None, "cuda"
        sptp = tuple((f"s2t2-{impl}", *rest, impl) for _, *rest, impl in cs.SPTP_CASES)
        vocab, island = cs.SPTP_VOCAB, {"devices": [f"cuda:{i}" for i in range(4)]}
    t0 = time.perf_counter()
    ok = True
    if not only23:
        ranks = cs.dp_spawn(REPO, "sp4", backend, 4, "sp_gloo_task", cases=cases, device=device)
        ok &= _report("sp=4", ranks, cases)
        ranks = cs.dp_spawn(REPO, "dp2sp2", backend, 4, "sp_gloo_task", cases=dpsp,
                            device=device, axes={"dp": 2, "sp": 2})
        ok &= _report("dp=2 x sp=2", ranks, dpsp)
    ranks = cs.dp_spawn(REPO, "sp2tp2", backend, 4, "sp_gloo_task", cases=sptp, device=device,
                        axes={"sp": 2, "tp": 2}, vocab=vocab)
    ok &= _report("sp=2 x tp=2", ranks, sptp)
    cs.log(f"backend {ranks[0]['backend']}, ok {ok}, {time.perf_counter() - t0:.2f} s")
    cs.log(f"islands, 2 workers x 2 devices: launches "
           f"{cs.island_phase(tag='islands-2x2', **island)}")
    return ok


def main(argv) -> int:
    if argv[:1] in (["cards"], ["cards23"]) and argv[1:] == ["--cpu"]:
        cs.card_line = lambda: "cpu"
        return 0 if cards(cpu=True, only23=argv[0] == "cards23") else 1
    import torch

    if len(argv) != 1 or argv[0] not in ("probe", "phase19", "phase23", "cards", "cards23"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sp_chip: no CUDA device", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}")
    run = {"probe": probe, "phase19": phase19, "phase23": phase23,
           "cards": lambda: cards(cpu=False),
           "cards23": lambda: cards(cpu=False, only23=True)}[argv[0]]
    return 0 if run() else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

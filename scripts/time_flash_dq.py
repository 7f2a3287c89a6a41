#!/usr/bin/env python3
"""Time the flash-attention dQ kernel (K2) of one or more trees on one GPU.

    python3 scripts/time_flash_dq.py DIR [DIR ...]

Each DIR holds a ``distkeras_tpu_torch/`` package (a checkout, or an older
commit or an edited copy unpacked beside this one). Each runs in a process
of its own, in the order given, so that versions alternate on one card
(a, b, b, a). For each, the script builds the package's backward library,
prints ptxas's registers and spills of its kernels, and at chip_smoke.py's
three shapes (bert_base: B=32 S=128 H=12 D=64; gpt_small causal, shift 0
and 1: B=8 S=512 H=12 D=64) holds ``dq_call`` against
``flash_dq_reference`` (chip_smoke.FLASH_BWD_RTOL of the largest value) and
prints three CUDA-graph timings of ``dq_call`` in ms (50 calls each) and one
of ``dkv_call``. Exits non-zero if a tree fails.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((32, 128, False, 0), (8, 512, True, 0), (8, 512, True, 1))


def time_tree(root: str) -> None:
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    sys.path.insert(0, root)
    import torch

    from distkeras_tpu_torch.ops.flash_attention import (
        dkv_call, dq_call, flash_dq_reference, flash_forward_reference)
    from distkeras_tpu_torch.utils.build import build_all

    name = os.path.basename(os.path.normpath(root))
    report = build_all(["flash_attention_bwd"])["flash_attention_bwd"]
    for kernel, info in cs.ptxas_summary(report).items():
        print(f"  {name} {kernel}: {info}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for B, S, causal, shift in SHAPES:
        BH, D = B * 12, 64
        q, k, v, do = (torch.randn(BH, S, D, device="cuda", generator=gen).bfloat16()
                       for _ in range(4))
        out, lse = flash_forward_reference(q, k, v, causal, shift)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        dq = dq_call(q, k, v, do, lse, delta, causal, shift)
        want = flash_dq_reference(q, k, v, do, lse, delta, causal, shift)
        torch.cuda.synchronize()
        err = (dq.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        cs.check(err <= cs.FLASH_BWD_RTOL * scale, f"{name}: dq error {err} at S={S}")
        ms = [cs.cuda_ms(lambda: dq_call(q, k, v, do, lse, delta, causal, shift), 50)
              for _ in range(3)]
        dkv_ms = cs.cuda_ms(lambda: dkv_call(k, v, q, do, lse, delta, causal, shift), 50)
        print(f"  {name} B={B} S={S} causal={causal} shift={shift}: dq "
              f"{' '.join(f'{m:.4f}' for m in ms)} ms, err {err:.3g}, dkv {dkv_ms:.4f} ms",
              flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        time_tree(os.path.abspath(argv[1]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

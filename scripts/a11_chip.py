#!/usr/bin/env python3
"""The data and operations extras on the card, beside chip_smoke.py's phase 24.

    python3 scripts/a11_chip.py phase24        # one card: phase 1's build, then phase 24
    python3 scripts/a11_chip.py phase24 --cpu  # the same on the CPU with bert_tiny_mlm at seq 32

``phase24`` builds the kernels and warms them as phase 1 does, then runs
``chip_smoke.a11_phase``: 24a StreamingPredictor over a loopback
SocketSource on bert_base_mlm (108 launches of K1), 24b the sample CSV
through the native parser and sparse features into SingleTrainer, 24c
StepTimer, compiled_step_flops and the MFU on bert_base_mlm's train step,
24d a deployment Job of ``examples/torch/streaming_inference.py``. Prints
the phase's launch counts, the card's name and power limit; exits non-zero
when a check fails.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def phase24(cpu: bool) -> bool:
    t0 = time.perf_counter()
    if cpu:
        cs.card_line = lambda: "cpu"
        counts = cs.a11_phase(device="cpu", model_name="bert_tiny_mlm", seq=32)
        cs.log(f"phase 24 on the CPU: {time.perf_counter() - t0:.2f} s, launches {counts}")
        return True
    import torch

    from distkeras_tpu_torch.ops.flash_attention import flash_forward
    from distkeras_tpu_torch.ops.fused_xent import fused_softmax_xent
    from distkeras_tpu_torch.utils.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q = torch.randn(1, 64, 64, device="cuda", generator=gen).bfloat16().requires_grad_()
    flash_forward(q, q, q)[0].sum().backward()
    for dt in (torch.float32, torch.bfloat16):
        x = torch.zeros(2, 8, device="cuda", dtype=dt, requires_grad=True)
        fused_softmax_xent(x, torch.zeros(2, dtype=torch.long, device="cuda")).backward()
    torch.cuda.synchronize()
    cs.log(f"phase 1: built and warmed in {time.perf_counter() - t0:.2f} s")
    counts = cs.a11_phase()
    cs.log(f"phase 24 launches {counts}")
    print(cs.card_line())
    return counts == cs.expected(flash_attention_fwd=192, flash_attention_dq=84,
                                 flash_attention_dkv=84, fused_xent_fwd=7,
                                 fused_xent_stats=7, fused_xent_grad=7)


def main(argv) -> int:
    if not argv or argv[0] != "phase24" or argv[1:] not in ([], ["--cpu"]):
        print(__doc__, file=sys.stderr)
        return 2
    cpu = argv[1:] == ["--cpu"]
    if not cpu:
        import torch

        if not torch.cuda.is_available():
            print("a11_chip: no CUDA device", file=sys.stderr)
            return 2
    try:
        ok = phase24(cpu)
    except AssertionError as e:
        cs.log(f"FAILED: {e}")
        return 1
    cs.log("ok" if ok else "FAILED: phase 24's launches differ from 192, 84, 84, 7, 7, 7")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

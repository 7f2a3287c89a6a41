#!/usr/bin/env python3
"""Drive the PyTorch port (distkeras_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [--root DIR]   # phases 1-2 only

``--root`` drives the package of another checkout (an older commit unpacked
beside this one) with this script's checks and timings, so that two versions
of the kernels are compared by one script on one card.

Phases, each of which must pass or the script exits non-zero:

1. Build the hand-written kernels from the sources in this checkout (one
   nvcc per CUDA C++ source, all at once: the flash-attention forward, and
   its dQ and dK/dV kernels; Triton's JIT for the fused cross-entropy
   forward, stats and grad kernels) and print the build time and each CUDA
   kernel's registers and spills (K1, K2 and K3 must not spill).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time kernel, plain version and the
   one PyTorch call that computes the same function (scaled_dot_product_attention
   and its backward, with a float additive mask under the strict causal mask;
   cross_entropy and its backward, logsumexp), with the bound the card's
   published rates put on it, and the flash wrappers' host time per call.
3. Inference at full width: bert_base_mlm (seq 128, flash attention on,
   random weights from a seed) through ModelPredictor (64 rows, batch 32)
   and Trainer.evaluate with fused_categorical_crossentropy (512 rows,
   batch 32), counting kernel launches in each run; one 4-row batch's
   logits and loss compared with the same weights run on the CPU; a
   torch.profiler table of device time by kernel over 4 eval batches.
4. The same for gpt_small (seq 512, causal): ModelPredictor on 8 rows,
   Trainer.evaluate on 2 batches of 8.
5. Training at full width: SingleTrainer.train on bert_base_mlm (seq 128,
   batch 32, flash on, dropout 0.1, adam) for 3 epochs over a copy task
   (label = features, 256 rows), counting launches per step, checking that
   the losses are finite and fall, timing the run; 8 steady steps timed and
   4 profiled (batches already on the device); one step at dropout 0 on the card against the same step on the
   CPU from the same weights (loss and every gradient).
6. The same for gpt_small (seq 512, batch 8, causal), 2 epochs of 64 rows.
7. Asynchronous training at full width: DynSGD on bert_base_mlm (seq 128,
   batch 32, flash on, fused loss, adam, window 5) against the in-process
   parameter server, over a copy task. 7a: one worker, overlap_window on,
   dropout 0, the partition cached on the device; the PS's final center
   equals the worker's last snapshot (what its delta was taken from) and the
   tensors its optimizer steps, to 1e-6 of the parameters' norm. 7b: two
   workers, each on its own CUDA stream, dropout 0.1, batches through
   DeviceFeed; the commits equal the windows, the launches equal 12 (K1-K3)
   and 1 (K4-K6) per step summed over both, the losses are finite and fall,
   the center moved. Logged: ms per window per worker, the exchange split
   (device to host, PS apply, host to device, from the trainer's spans),
   tokens/s, peak memory, the staleness statusz reports, and a profiler
   table of the device's busy share over two windows with one worker and
   with two.
8. ADAG on cifar10_cnn at full width (2 workers, device_cache "auto",
   adam, window 12) on seeded class-prototype images: the commits equal the
   windows, the loss is finite and falls, and no kernel of ours launches.
9. resnet50 at full width (224x224x3, 1000 classes, bf16; BASELINE config
   #4). 9a: card against CPU on 16 images (where train-mode BatchNorm is
   well conditioned) from the same weights (BatchNorm scales and statistics
   drawn from a seed, so that every residual branch is live): logits at
   train=False, logits and the change of the BatchNorm statistics
   (new - old) at train=True, each within the larger of 2% and 3x the CPU
   bf16 run's own distance from the CPU float32 run (L2 norm). 9b: AEASGD
   with 2 workers on two streams, batch 32 per worker, window 4, 3 windows
   each, on seeded prototype images: images/s, ms per window, ps_apply ms,
   the device's busy share, peak memory, loss first -> last; the commits
   equal the windows, the loss and the returned BatchNorm statistics are
   finite, and no kernel of ours launches (cuDNN runs the convolutions).
10. Checkpoints and resume on bert_base_mlm at full width (batch 32 x seq
   128, flash on, fused loss, adam, dropout 0; K1-K6 on the path). 10a:
   SynchronousDistributedTrainer A (2 epochs of 3 steps), B (1 epoch with
   checkpoint_dir) and C (resume=True for 2 epochs): C ran A's steps less
   B's and C's weights equal A's (max abs difference held to 0). 10b:
   DynSGD with one worker and a short checkpoint interval: the snapshot
   thread fires and never fails, and a resumed run's PS starts from the
   last saved center bitwise. 10c: the 110M-parameter weight file saved and
   loaded bitwise, with MB/s.
11. EnsembleTrainer and AveragingTrainer on bert_base_mlm at full width (2
   replicas, 3 steps each, dropout 0, one seed and data): the average
   equals the mean of the ensemble's two models computed on the card, to
   float32 rounding; ms per step.
12. Print the kernels line, the card's name and power limit, and last the
   result line {"ok": true, "device": {...}}.

Phases 9-11 write their checkpoints under build/chip_smoke/ (git-ignored)
and remove them.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores

# Tolerances of kernel against plain version on the same inputs, and of the
# card's main path against the CPU's on the same weights.
FLASH_OUT_ATOL = 2e-2   # bf16 O: P rounds to bf16 against different maxima
FLASH_LSE_ATOL = 1e-3   # f32 lse of O(1..10) values, summation order
XENT_RTOL = 1e-5        # f32 per-row loss, summation order
LOGITS_ATOL = 0.1       # bf16 logits of |x| < 4: ~13 bf16 ulps of rounding drift over 12 layers
LOSS_RTOL = 2e-3
# bf16 dQ/dK/dV: both round P and dS to bf16 before the products, from exps
# computed by different code, so a weight near a rounding boundary lands one
# bf16 ulp apart; 1e-2 of the largest gradient.
FLASH_BWD_RTOL = 1e-2
XENT_STATS_RTOL = 1e-4  # f32 sum of exps by different code, in another order
# dlogits, element by element, |d - want| <= RTOL * |want| + ATOL * g: f32 exps
# from different code (a few ulps apart); bf16 one rounding of the same f32
# value (at most 2**-7 relative) apart, with room for two. The floor, 1e-12
# of g, lies far below the smallest entries here, so every column is checked.
XENT_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
XENT_GRAD_ATOL = 1e-12
# One training step at dropout 0 from the same weights, on the card (bf16)
# and on the CPU (bf16, and float32 as the exact step): each gradient's
# card-CPU difference, in norm, within 5% of the gradient's norm or within 3x
# the CPU bf16 step's own distance from the float32 step, whichever is larger.
# The second bound is for tensors whose gradient is mostly cancellation (the
# attention key weights: every row of dS sums to 0), where bf16 rounding
# alone moves the gradient by far more than 5% on any device.
GRAD_REL_TOL = 5e-2
GRAD_NOISE_FACTOR = 3.0
# resnet50 card against CPU (bf16, same weights, 16 images): each output's
# difference (the logits; the statistics' change new - old) in L2 norm,
# relative to the CPU's, within 2% or 3x the CPU bf16 run's own relative
# distance from the CPU float32 run, whichever is larger.
RESNET_REL_TOL = 2e-2
RESNET_NOISE_FACTOR = 3.0
# Phase 11: the average against the mean of the ensemble's models computed
# on the card: both are (a + b) / 2 in float32, one rounding each.
AVERAGE_ATOL_ULPS = 1.0
CKPT_ROOT = os.path.join(REPO, "build", "chip_smoke")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, the replay timed with CUDA events, so that the host's
    launch overhead (tens of microseconds a call in Python) is not counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture: library handles, workspaces
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_us(fn, rounds: int = 5, calls: int = 200) -> float:
    """Host time of one eager call of ``fn`` (the wrapper's checks, tensor
    maps and launch): ``rounds`` runs of ``calls`` calls by the host clock,
    with no synchronize inside a run; the median run's time per call (the
    host is shared, and single runs spread by tens of percent)."""
    import torch

    for _ in range(10):
        fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(per_call)[rounds // 2]


def sdpa_call(q4, k4, v4, causal: bool, shift: int):
    """The one PyTorch call that computes the flash function on [B, H, S, D]:
    SDPA with is_causal for shift 0; for shift 1 with a float additive mask,
    0 where row >= col + 1 and -1e30 elsewhere, so that row 0, which sees no
    key, averages every V row as the reference's does."""
    import torch
    import torch.nn.functional as F

    if not (causal and shift):
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    S = q4.shape[2]
    pos = torch.arange(S, device=q4.device)
    mask = torch.zeros(S, S, device=q4.device, dtype=q4.dtype)
    mask.masked_fill_(pos[:, None] < pos[None, :] + shift, -1e30)
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attended_pairs(S: int, causal: bool, shift: int) -> int:
    """Query-key pairs the attention needs: all of them, the causal
    triangle, or the strict triangle plus row 0, which under shift 1 sees no
    key and so, as in the reference, weighs every key equally."""
    if not causal:
        return S * S
    return S * (S + 1) // 2 if shift == 0 else S * (S - 1) // 2 + S


def ptxas_summary(report: str) -> dict:
    """Each kernel's registers and spills from ``nvcc -Xptxas -v`` output:
    {"flash_dkv_kernel<64>": "168 registers, 0 bytes spill stores, ..."}."""
    import re

    out, kernel = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:entry function|Function properties for) .*?\d([a-z_]+_kernel)ILi(\d+)E",
                      line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
            continue
        m = re.search(r"(\d+ bytes spill stores, \d+ bytes spill loads)|Used (\d+ registers)", line)
        if m and kernel:
            out[kernel] = ", ".join(filter(None, [out.get(kernel), m.group(1) or m.group(2)]))
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 2: kernels against their plain versions ---------------------------


def flash_case(B, S, H, D, causal, shift, gen):
    import torch

    from distkeras_tpu_torch.ops.flash_attention import flash_forward, flash_forward_reference

    BH = B * H
    q, k, v = (torch.randn(BH, S, D, device="cuda", generator=gen).bfloat16() for _ in range(3))
    out, lse = flash_forward(q, k, v, causal, shift)
    ref_out, ref_lse = flash_forward_reference(q, k, v, causal, shift)
    torch.cuda.synchronize()
    err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    check(math.isfinite(err) and err <= FLASH_OUT_ATOL, f"flash O error {err} > {FLASH_OUT_ATOL}")
    check(math.isfinite(lse_err) and lse_err <= FLASH_LSE_ATOL,
          f"flash lse error {lse_err} > {FLASH_LSE_ATOL}")
    ms = cuda_ms(lambda: flash_forward(q, k, v, causal, shift), 50)
    plain_ms = cuda_ms(lambda: flash_forward_reference(q, k, v, causal, shift), 5)
    host = host_us(lambda: flash_forward(q, k, v, causal, shift))
    q4, k4, v4 = (x.view(B, H, S, D) for x in (q, k, v))
    sdpa = sdpa_call(q4, k4, v4, causal, shift)
    library_ms = cuda_ms(sdpa, 50)
    library_err = (sdpa().reshape(BH, S, D).float() - ref_out.float()).abs().max().item()
    pairs = attended_pairs(S, causal, shift)
    nbytes = 4 * BH * S * D * 2 + BH * S * 4
    bound, by = bound_ms(nbytes, 4.0 * BH * pairs * D, BF16_TENSOR_FLOPS)
    case = {"shape": f"B={B} S={S} H={H} D={D} causal={causal} shift={shift} bf16",
            "max_abs_err": err, "lse_max_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "library_max_abs_err": library_err, "host_us": host}
    log(f"  K1 {case['shape']}: err {err:.3g} lse_err {lse_err:.3g} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {library_ms:.4f} ms "
        f"(SDPA, err {library_err:.3g}) bound {bound:.4f} ms ({by}), "
        f"host {host:.2f} us a call")
    return case


def xent_case(T, V, dtype, gen):
    import torch
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.fused_xent import xent_forward, xent_forward_reference

    logits = (torch.randn(T, V, device="cuda", generator=gen) * 3).to(dtype)
    labels = torch.randint(0, V, (T,), device="cuda", generator=gen)
    got = xent_forward(logits, labels)
    want = xent_forward_reference(logits, labels)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = ((got - want).abs() / want.abs().clamp_min(1e-6)).max().item()
    check(math.isfinite(err) and rel <= XENT_RTOL, f"xent relative error {rel} > {XENT_RTOL}")
    ms = cuda_ms(lambda: xent_forward(logits, labels), 20)
    plain_ms = cuda_ms(lambda: xent_forward_reference(logits, labels), 3)
    library_ms = cuda_ms(lambda: F.cross_entropy(logits, labels, reduction="none"), 20)
    nbytes = T * V * logits.element_size() + T * labels.element_size() + T * 4
    bound, by = bound_ms(nbytes, 4.0 * T * V, F32_FLOPS)
    case = {"shape": f"T={T} V={V} {str(dtype).split('.')[-1]}", "max_abs_err": err,
            "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}
    log(f"  K4 {case['shape']}: err {err:.3g} rel {rel:.3g} kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms library {library_ms:.4f} ms bound {bound:.4f} ms ({by})")
    return case


def flash_bwd_cases(B, S, H, D, causal, shift, gen):
    """K2 and K3 on the inputs the forward gives (lse from K1's plain
    version, delta = rowsum(dO * O)); the library yardstick is SDPA's
    backward, timed as SDPA forward+backward less SDPA forward."""
    import torch

    from distkeras_tpu_torch.ops.flash_attention import (
        dkv_call, dq_call, flash_dkv_reference, flash_dq_reference, flash_forward_reference)

    BH = B * H
    q, k, v, do = (torch.randn(BH, S, D, device="cuda", generator=gen).bfloat16()
                   for _ in range(4))
    out, lse = flash_forward_reference(q, k, v, causal, shift)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    dq = dq_call(q, k, v, do, lse, delta, causal, shift)
    dk, dv = dkv_call(k, v, q, do, lse, delta, causal, shift)
    want_dq = flash_dq_reference(q, k, v, do, lse, delta, causal, shift)
    want_dk, want_dv = flash_dkv_reference(k, v, q, do, lse, delta, causal, shift)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)):
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        check(math.isfinite(err) and err <= FLASH_BWD_RTOL * scale,
              f"flash {name} error {err} > {FLASH_BWD_RTOL} x {scale}")
        errs[name] = err
    q4, k4, v4 = (x.view(B, H, S, D).detach().requires_grad_() for x in (q, k, v))
    do4 = do.view(B, H, S, D)
    sdpa = sdpa_call(q4, k4, v4, causal, shift)
    fwd_ms = cuda_ms(sdpa, 20)
    both_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (q4, k4, v4), do4), 20)
    library_ms = both_ms - fwd_ms
    pairs = attended_pairs(S, causal, shift)
    tensor = BH * S * D * 2
    stats = 2 * BH * S * 4
    shape = f"B={B} S={S} H={H} D={D} causal={causal} shift={shift} bf16"
    cases = {}
    for name, fn, plain, nbytes, flops, err in (
        ("K2", lambda: dq_call(q, k, v, do, lse, delta, causal, shift),
         lambda: flash_dq_reference(q, k, v, do, lse, delta, causal, shift),
         5 * tensor + stats, 6.0 * BH * pairs * D, errs["dq"]),
        ("K3", lambda: dkv_call(k, v, q, do, lse, delta, causal, shift),
         lambda: flash_dkv_reference(k, v, q, do, lse, delta, causal, shift),
         6 * tensor + stats, 8.0 * BH * pairs * D, max(errs["dk"], errs["dv"])),
    ):
        ms = cuda_ms(fn, 50)
        plain_ms = cuda_ms(plain, 5)
        host = host_us(fn)
        bound, by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
        cases[name] = {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound, "bound_by": by, "host_us": host,
                       "library_ms": library_ms, "library": "SDPA backward (K2 and K3 together)"}
        log(f"  {name} {shape}: err {err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library (K2+K3) {library_ms:.4f} ms bound {bound:.4f} ms ({by}), "
            f"host {host:.2f} us a call")
    return cases["K2"], cases["K3"]


def xent_bwd_cases(T, V, dtype, gen):
    """K5 and K6; the yardsticks are torch.logsumexp for K5 and the backward
    of F.cross_entropy (forward+backward less forward) for K5 and K6
    together."""
    import torch
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.fused_xent import (
        xent_grad, xent_grad_reference, xent_stats, xent_stats_reference)

    logits = (torch.randn(T, V, device="cuda", generator=gen) * 3).to(dtype)
    labels = torch.randint(0, V, (T,), device="cuda", generator=gen)
    g = torch.full((T,), 1.0 / T, device="cuda")
    m, s = xent_stats(logits)
    want_m, want_s = xent_stats_reference(logits)
    d = xent_grad(logits, labels, g, want_m, want_s)
    want_d = xent_grad_reference(logits, labels, g, want_m, want_s)
    torch.cuda.synchronize()
    check(torch.equal(m, want_m), "xent stats: row max differs")
    s_err = (s - want_s).abs().max().item()
    s_rel = ((s - want_s).abs() / want_s).max().item()
    check(s_rel <= XENT_STATS_RTOL, f"xent stats relative error {s_rel} > {XENT_STATS_RTOL}")
    diff = (d.float() - want_d.float()).abs()
    d_err = diff.max().item()
    rtol, atol = XENT_GRAD_RTOL[str(dtype).split(".")[-1]], XENT_GRAD_ATOL / T
    d_rel = (diff / (want_d.float().abs() + atol)).max().item()
    excess = (diff - rtol * want_d.float().abs()).max().item()
    check(math.isfinite(d_err) and excess <= atol,
          f"xent grad: an element exceeds {rtol} x |want| + {atol} by {excess - atol}")
    del want_d, diff

    lse_ms = cuda_ms(lambda: torch.logsumexp(logits, dim=-1), 10)
    x = logits.detach().requires_grad_()
    ce_fwd_ms = cuda_ms(lambda: F.cross_entropy(x, labels), 5)
    ce_both_ms = cuda_ms(lambda: torch.autograd.grad(F.cross_entropy(x, labels), (x,)), 5)
    es = logits.element_size()
    shape = f"T={T} V={V} {str(dtype).split('.')[-1]}"
    cases = {}
    for name, fn, plain, nbytes, ops, err, library_ms, library in (
        ("K5", lambda: xent_stats(logits), lambda: xent_stats_reference(logits),
         T * V * es + 2 * T * 4, 4.0 * T * V, s_err, lse_ms,
         "torch.logsumexp"),
        ("K6", lambda: xent_grad(logits, labels, g, m, s),
         lambda: xent_grad_reference(logits, labels, g, m, s),
         2 * T * V * es + T * (labels.element_size() + 12), 5.0 * T * V, d_err,
         ce_both_ms - ce_fwd_ms, "F.cross_entropy backward (K5 and K6 together)"),
    ):
        ms = cuda_ms(fn, 10)
        plain_ms = cuda_ms(plain, 3)
        bound, by = bound_ms(nbytes, ops, F32_FLOPS)
        cases[name] = {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
                       "library": library}
        log(f"  {name} {shape}: err {err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library {library_ms:.4f} ms ({library}) bound {bound:.4f} ms ({by})")
        torch.cuda.empty_cache()
    cases["K6"]["max_rel_err"] = d_rel
    log(f"  K6 {shape}: largest error relative to the element {d_rel:.3g} (tolerance {rtol})")
    return cases["K5"], cases["K6"]


# -- phases 3 to 6: the slice at full width -----------------------------------


def kernel_wrappers() -> dict:
    """Each kernel's name in the kernels line -> its wrapper, which counts
    launches in ``.launches``."""
    from distkeras_tpu_torch.ops.flash_attention import dkv_call, dq_call, flash_forward
    from distkeras_tpu_torch.ops.fused_xent import xent_forward, xent_grad, xent_stats

    return {"flash_attention_fwd": flash_forward, "flash_attention_dq": dq_call,
            "flash_attention_dkv": dkv_call, "fused_xent_fwd": xent_forward,
            "fused_xent_stats": xent_stats, "fused_xent_grad": xent_grad}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def expected(**counts) -> dict:
    return {name: counts.get(name, 0) for name in kernel_wrappers()}


def run_model(name, seq, pred_rows, eval_rows, batch, cpu_rows):
    import numpy as np
    import torch

    from distkeras_tpu_torch import Dataset, ModelPredictor, TrainedModel, Trainer
    from distkeras_tpu_torch.models import bert
    from distkeras_tpu_torch.ops.fused_xent import fused_softmax_xent

    base = getattr(bert, name)(seq_len=seq)
    cfg = dataclasses.replace(base.config, use_flash_attention=True)
    model = bert._make(cfg, seq, name)
    t0 = time.perf_counter()
    variables = model.init(SEED)
    torch.cuda.synchronize()
    log(f"{name}: {model.count_params()} params, init {time.perf_counter() - t0:.2f} s, "
        f"layers {cfg.num_layers}, hidden {cfg.hidden_size}, vocab {cfg.vocab_size}, seq {seq}")
    trained = TrainedModel(model, variables)
    rng = np.random.default_rng(SEED)
    rows = max(pred_rows, eval_rows)
    data = Dataset.from_arrays(
        features=rng.integers(0, cfg.vocab_size, size=(rows, seq)).astype(np.int32),
        label=rng.integers(0, cfg.vocab_size, size=(rows, seq)).astype(np.int32))
    predictor = ModelPredictor(trained, batch_size=batch)
    trainer = Trainer(model, loss="fused_categorical_crossentropy")

    predictor.predict(data.take(batch))  # warm-up: cuBLAS handles, Triton cache
    trainer.evaluate(trained, data.take(batch), batch_size=batch)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    preds = predictor.predict(data.take(pred_rows))["prediction"]
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    pred_counts = read_counts()
    check(preds.shape == (pred_rows, seq, cfg.vocab_size), f"prediction shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), "non-finite logits")
    n_pred_batches = -(-pred_rows // batch)
    check(pred_counts == expected(flash_attention_fwd=cfg.num_layers * n_pred_batches),
          f"predict launches {pred_counts}")
    log(f"  predict {pred_rows} rows at batch {batch}: {pred_s:.3f} s "
        f"(host copy of the logits included), launches {pred_counts}")

    reset_counts()
    t0 = time.perf_counter()
    metrics = trainer.evaluate(trained, data.take(eval_rows), batch_size=batch)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = read_counts()
    n_eval_batches = -(-eval_rows // batch)
    check(eval_counts == expected(flash_attention_fwd=cfg.num_layers * n_eval_batches,
                                  fused_xent_fwd=n_eval_batches),
          f"evaluate launches {eval_counts}")
    ln_v = math.log(cfg.vocab_size)
    check(math.isfinite(metrics["loss"]) and abs(metrics["loss"] - ln_v) < 1.0,
          f"eval loss {metrics['loss']} not near ln V = {ln_v}")
    tokens = eval_rows * seq
    log(f"  evaluate {eval_rows} rows at batch {batch}: {eval_s:.3f} s, "
        f"{eval_s / n_eval_batches * 1e3:.2f} ms/batch, {tokens / eval_s:.0f} tokens/s, "
        f"loss {metrics['loss']:.5f} (ln V {ln_v:.5f}), accuracy {metrics['accuracy']:.6f}, "
        f"launches {eval_counts}")

    # The same weights on the CPU, through the plain versions.
    x = data["features"][:cpu_rows]
    y = torch.from_numpy(data["label"][:cpu_rows])
    t0 = time.perf_counter()
    cpu_logits = trained.to("cpu").predict(x)
    cpu_s = time.perf_counter() - t0
    gpu_logits = preds[:cpu_rows]
    err = float(np.abs(gpu_logits - cpu_logits).max())
    mean_err = float(np.abs(gpu_logits - cpu_logits).mean())
    gpu_loss = fused_softmax_xent(torch.from_numpy(gpu_logits).cuda(), y.cuda()).item()
    cpu_loss = fused_softmax_xent(torch.from_numpy(cpu_logits), y).item()
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    log(f"  card vs CPU on {cpu_rows} rows: logits max abs err {err:.4g} mean {mean_err:.3g} "
        f"(logits std {float(cpu_logits.std()):.3g}), loss {gpu_loss:.6f} vs {cpu_loss:.6f} "
        f"(rel {loss_rel:.3g}), CPU forward {cpu_s:.2f} s")
    check(err <= LOGITS_ATOL, f"card vs CPU logits error {err} > {LOGITS_ATOL}")
    check(loss_rel <= LOSS_RTOL, f"card vs CPU loss relative error {loss_rel} > {LOSS_RTOL}")

    sample = data.take(4 * batch)
    profile(f"{-(-sample.num_rows // batch)} eval batches",
            lambda: trainer.evaluate(trained, sample, batch_size=batch))
    return {k: pred_counts[k] + eval_counts[k] for k in pred_counts}


def profile(what: str, fn) -> float:
    """Device time by kernel, and the device's busy share, over one call of
    ``fn`` (torch.profiler with CUDA activity); returns the busy share."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_ms = sum(e.device_time_total for e in kernels) / 1e3
    # Busy: the union of the device activities' intervals, so that work
    # overlapping on two streams counts once.
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    busy_ms = busy_us / 1e3
    log(f"  profile: {what}, wall {wall_ms:.3f} ms, device time {total_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%})")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    return busy_ms / wall_ms


def train_model(name, seq, batch, rows, epochs, cpu_rows):
    """SingleTrainer.train at full width on a copy task; returns the launch
    counts of the timed run."""
    import numpy as np
    import torch

    from distkeras_tpu_torch import Dataset, SingleTrainer
    from distkeras_tpu_torch.models import bert

    base = getattr(bert, name)(seq_len=seq)
    cfg = dataclasses.replace(base.config, use_flash_attention=True)
    model = bert._make(cfg, seq, name)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, size=(rows, seq)).astype(np.int32)
    data = Dataset.from_arrays(features=tokens, label=tokens)
    log(f"{name} training: {model.count_params()} params, dropout {cfg.dropout_rate}, "
        f"batch {batch} x seq {seq}, {rows} rows x {epochs} epochs, adam, copy task")

    def trainer(n_epochs):
        return SingleTrainer(model, "adam", loss="fused_categorical_crossentropy",
                             batch_size=batch, num_epoch=n_epochs, seed=SEED)

    trainer(1).train(data.take(batch))  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    reset_counts()
    tr = trainer(epochs)
    t0 = time.perf_counter()
    trained = tr.train(data, shuffle=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    steps = len(tr.get_history())
    check(steps == epochs * (rows // batch), f"{steps} steps")
    L = cfg.num_layers
    check(counts == expected(flash_attention_fwd=L * steps, flash_attention_dq=L * steps,
                             flash_attention_dkv=L * steps, fused_xent_fwd=steps,
                             fused_xent_stats=steps, fused_xent_grad=steps),
          f"train launches {counts} for {steps} steps")
    losses = [h["loss"] for h in tr.get_history()]
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    per_epoch = rows // batch
    first = sum(losses[:per_epoch]) / per_epoch
    last = sum(losses[-per_epoch:]) / per_epoch
    check(last < first, f"loss did not fall: first epoch {first}, last epoch {last}")
    check(trained.device.type == "cuda", f"trained weights on {trained.device}")
    tokens_per_s = steps * batch * seq / wall_s
    log(f"  train {steps} steps: {wall_s:.3f} s ({wall_s / steps * 1e3:.2f} ms/step with "
        f"init and feed), {tokens_per_s:.0f} tokens/s; loss first step {losses[0]:.4f}, "
        f"epoch means {first:.4f} -> {last:.4f}, last step {losses[-1]:.4f}, "
        f"accuracy last step {tr.get_history()[-1]['accuracy']:.4f}; launches {counts}")
    steady_steps(model, data, batch, seq)
    card_vs_cpu_step(model, cfg, tokens[:cpu_rows])
    return counts


def steady_steps(model, data, batch, seq):
    """The train step alone, on trained-size state and batches already on
    the device: 8 steps timed by the host clock, then 4 under the
    profiler."""
    import torch

    from distkeras_tpu_torch.data.feed import DeviceFeed, minibatches
    from distkeras_tpu_torch.ops.losses import get_optimizer
    from distkeras_tpu_torch.training.step import TrainState, make_train_step

    state = TrainState.create(model, get_optimizer("adam"), SEED)
    step = make_train_step(model, "fused_categorical_crossentropy")
    batches = list(DeviceFeed(minibatches(data, batch)))

    def run(n):
        nonlocal state
        for i in range(n):
            state, _ = step(state, batches[i % len(batches)])

    run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(8)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 8 * 1e3
    log(f"  steady train step: {ms:.2f} ms/step, {batch * seq / ms * 1e3:.0f} tokens/s "
        f"(8 steps, batches on the device)")
    profile("4 train steps", lambda: run(4))


def card_vs_cpu_step(model, cfg, tokens):
    """Loss and gradients of one step at dropout 0, on the card and on the
    CPU from the same weights, with the CPU's float32 step as the exact
    reference."""
    import torch

    from distkeras_tpu_torch.models import bert
    from distkeras_tpu_torch.ops.fused_xent import fused_softmax_xent

    def make(dtype):
        return bert._make(dataclasses.replace(cfg, dropout_rate=0.0, dtype=dtype),
                          model.input_shape[0], model.name)

    model0 = make(cfg.dtype)
    weights = model0.init(SEED)

    def loss_and_grads(m, device):
        params = {k: v.to(device).requires_grad_() for k, v in weights.items()}
        x = torch.from_numpy(tokens).to(device)
        logits, _ = m.apply(params, x, True, 0)
        loss = fused_softmax_xent(logits, x)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.item(), {k: g.float().cpu() for k, g in zip(params, grads)}

    gpu_loss, gpu = loss_and_grads(model0, "cuda")
    t0 = time.perf_counter()
    cpu_loss, cpu = loss_and_grads(model0, "cpu")
    cpu_s = time.perf_counter() - t0
    f32_loss, exact = loss_and_grads(make(torch.float32), "cpu")
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    norms = {k: g.norm().item() for k, g in cpu.items()}
    floor = 1e-3 * max(norms.values())
    rel = {k: (gpu[k] - cpu[k]).norm().item() / max(norms[k], floor) for k in cpu}
    # Each bf16 step's distance from the float32 step, relative to its norm.
    card_err = {k: (gpu[k] - exact[k]).norm().item() / max(norms[k], floor) for k in cpu}
    cpu_err = {k: (cpu[k] - exact[k]).norm().item() / max(norms[k], floor) for k in cpu}
    allowed = {k: max(GRAD_REL_TOL, GRAD_NOISE_FACTOR * cpu_err[k]) for k in cpu}
    worst = sorted(rel, key=lambda k: rel[k] / allowed[k], reverse=True)
    log(f"  card vs CPU, one step on {tokens.shape[0]} rows at dropout 0: loss {gpu_loss:.6f} "
        f"vs {cpu_loss:.6f} (rel {loss_rel:.3g}; float32 {f32_loss:.6f}); gradient difference "
        f"norm relative to the gradient's: median {sorted(rel.values())[len(rel) // 2]:.3g}, "
        f"max {max(rel.values()):.3g} over {len(rel)} tensors; CPU bf16 step {cpu_s:.2f} s")
    for k in worst[:4]:
        log(f"    {k}: card-CPU {rel[k]:.3g} (allowed {allowed[k]:.3g}); from float32: "
            f"card {card_err[k]:.3g}, CPU {cpu_err[k]:.3g}")
    check(loss_rel <= LOSS_RTOL, f"card vs CPU loss relative error {loss_rel} > {LOSS_RTOL}")
    k = worst[0]
    check(rel[k] <= allowed[k], f"card vs CPU gradient {k}: {rel[k]} > {allowed[k]}")


# -- phases 7 and 8: the asynchronous parameter-server trainers ---------------


def span_totals(tracer) -> dict:
    """{(span name, worker): [count, seconds]} from a tracer's B/E events
    (each lane a stack)."""
    out: dict = {}
    stacks: dict = {}
    for ph, name, t, lane, _, attrs in tracer.events():
        if ph == "B":
            stacks.setdefault(lane, []).append((name, t, (attrs or {}).get("worker")))
        else:
            name, t0, worker = stacks[lane].pop()
            entry = out.setdefault((name, worker), [0, 0.0])
            entry[0] += 1
            entry[1] += t - t0
    return out


def log_spans(tracer) -> dict:
    totals = span_totals(tracer)
    for (name, worker), (n, sec) in sorted(totals.items(), key=lambda kv: str(kv[0])):
        who = "" if worker is None else f" worker {worker}"
        log(f"    span {name}{who}: {n} x {sec / n * 1e3:.2f} ms = {sec:.3f} s")
    return totals


def first_last(hist, window: int) -> tuple[float, float]:
    """Mean loss of every worker's first window and of every worker's last."""
    workers = sorted({h["worker"] for h in hist})
    per = [[h["loss"] for h in hist if h["worker"] == w] for w in workers]
    n = window * len(per)
    return sum(sum(p[:window]) for p in per) / n, sum(sum(p[-window:]) for p in per) / n


def rel_gap(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every tensor, in float64."""
    a = {k: v.detach().double() for k, v in a.items()}
    b = {k: v.detach().double() for k, v in b.items()}
    num = sum(float((a[k] - b[k]).square().sum()) for k in b)
    den = sum(float(b[k].square().sum()) for k in b)
    return (num / den) ** 0.5


def async_bert(seq=128, batch=32, window=5):
    """Phase 7: DynSGD on bert_base_mlm at full width; returns the launch
    counts of 7b."""
    import numpy as np
    import torch

    from distkeras_tpu_torch import Dataset, DynSGD
    from distkeras_tpu_torch.models import bert
    from distkeras_tpu_torch.telemetry.spans import Tracer, disable_tracing, enable_tracing

    base = bert.bert_base_mlm(seq_len=seq)
    cfg = dataclasses.replace(base.config, use_flash_attention=True)
    rng = np.random.default_rng(SEED)

    def data(rows):
        tokens = rng.integers(0, cfg.vocab_size, size=(rows, seq)).astype(np.int32)
        return Dataset.from_arrays(features=tokens, label=tokens)

    def trainer(model, workers, **kw):
        return DynSGD(model, "adam", loss="fused_categorical_crossentropy", num_workers=workers,
                      batch_size=batch, communication_window=window, seed=SEED, **kw)

    n_params = base.count_params()
    log(f"bert_base_mlm DynSGD: {n_params} params ({n_params * 4 / 2**20:.0f} MiB a float32 "
        f"delta), batch {batch} x seq {seq}, window {window}, adam, copy task")
    model0 = bert._make(dataclasses.replace(cfg, dropout_rate=0.0), seq, "bert_base_mlm")
    trainer(model0, 1).train(data(batch * window))  # warm-up: allocator, host pins
    torch.cuda.synchronize()

    # 7a: one worker, overlap on, dropout 0.
    tr = trainer(model0, 1, overlap_window=True)
    snaps = {}
    exchange = tr.protocol.worker_window

    def recording_exchange(params, carry, client):
        snaps["last"] = {k: v.detach().clone() for k, v in params.items()}
        return exchange(params, carry, client)

    tr.protocol.worker_window = recording_exchange
    windows_a = 4
    tracer = enable_tracing(Tracer())
    t0 = time.perf_counter()
    trained = tr.train(data(batch * window * windows_a))
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    disable_tracing()
    state = tr.worker_states[0]
    stepped = dict(zip(state.params, state.optimizer.param_groups[0]["params"]))
    center = {k: trained.variables[k] for k in stepped}
    gap_snap, gap_opt = rel_gap(center, snaps["last"]), rel_gap(center, stepped)
    steps_a = len(tr.get_history())
    log(f"  7a: 1 worker, {steps_a} steps in {wall_a:.3f} s ({steps_a * batch * seq / wall_a:.0f} "
        f"tokens/s), {tr.parameter_server.num_commits} commits; center vs the last snapshot "
        f"{gap_snap:.3g}, vs the optimizer's tensors {gap_opt:.3g} (relative norm)")
    log_spans(tracer)
    check(steps_a == windows_a * window and tr.parameter_server.num_commits == windows_a,
          f"7a: {steps_a} steps, {tr.parameter_server.num_commits} commits")
    check(gap_snap <= 1e-6 and gap_opt <= 1e-6,
          f"7a: center off the worker's parameters ({gap_snap}, {gap_opt})")
    check(all(p is q for p, q in zip(state.params.values(), stepped.values())),
          "7a: the optimizer steps tensors the trainer does not hold")
    del tr, trained, state, stepped, center, snaps
    torch.cuda.empty_cache()

    # 7b: two workers on two streams, dropout 0.1, the host feed.
    model = bert._make(cfg, seq, "bert_base_mlm")
    windows_b = 4
    rows = 2 * batch * window * windows_b
    center0 = {k: v.cpu() for k, v in model.init(SEED).items()}
    torch.cuda.reset_peak_memory_stats()
    tr = trainer(model, 2, device_cache=False)
    reset_counts()
    tracer = enable_tracing(Tracer())
    t0 = time.perf_counter()
    trained = tr.train(data(rows))
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    disable_tracing()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = tr.get_history()
    steps = len(hist)
    windows = sum(len(w) for w in tr.window_times)
    L = cfg.num_layers
    check(steps == 2 * windows_b * window and windows == 2 * windows_b,
          f"7b: {steps} steps in {windows} windows")
    check(tr.parameter_server.num_commits == windows,
          f"7b: {tr.parameter_server.num_commits} commits for {windows} windows")
    check(counts == expected(flash_attention_fwd=L * steps, flash_attention_dq=L * steps,
                             flash_attention_dkv=L * steps, fused_xent_fwd=steps,
                             fused_xent_stats=steps, fused_xent_grad=steps),
          f"7b: launches {counts} for {steps} steps")
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"7b: non-finite loss {losses}")
    first, last = first_last(hist, window)
    check(last < first, f"7b: loss did not fall: first windows {first}, last windows {last}")
    check(trained.device.type == "cuda", f"7b: trained weights on {trained.device}")
    moved = max((trained.variables[k].cpu() - center0[k]).abs().max().item() for k in center0)
    check(moved > 0, "7b: the center did not move")
    status = tr.training_health.statusz()
    log(f"  7b: 2 workers, {steps} steps in {wall_b:.3f} s ({steps * batch * seq / wall_b:.0f} "
        f"tokens/s over both), {windows} windows, {tr.parameter_server.num_commits} commits; "
        f"loss first windows {first:.4f} -> last {last:.4f}; center moved by up to {moved:.3g}; "
        f"peak memory {peak / 2**30:.2f} GiB; launches {counts}")
    for w, times in enumerate(tr.window_times):
        gaps = [b[0] - a[0] for a, b in zip(times, times[1:])]
        log(f"    worker {w}: window completions {len(times)}, ms between them "
            f"{[round(g * 1e3, 1) for g in gaps]}")
    log(f"    staleness {status.get('staleness')}, goodput {status.get('goodput')}, "
        f"workers {[{k: r.get(k) for k in ('worker', 'commits', 'steps', 'last_staleness')} for r in status['workers']]}")
    log_spans(tracer)
    del tr, trained
    torch.cuda.empty_cache()

    busy = {}
    for workers in (1, 2):
        tr = trainer(model, workers, device_cache=False)
        sample = data(workers * batch * window * 2)
        busy[workers] = profile(f"DynSGD, {workers} worker(s) x 2 windows of {window} steps",
                                lambda: tr.train(sample))
        del tr
    log(f"  device busy share: 1 worker {busy[1]:.1%}, 2 workers {busy[2]:.1%}")
    return counts


def async_cnn(batch=32, window=12, windows=3):
    """Phase 8: ADAG on cifar10_cnn at full width, two workers."""
    import numpy as np
    import torch

    from distkeras_tpu_torch import ADAG, Dataset, cifar10_cnn

    rng = np.random.default_rng(SEED)
    rows = 2 * batch * window * windows
    labels = rng.integers(0, 10, size=rows)
    protos = rng.normal(size=(10, 32, 32, 3)).astype(np.float32)
    images = (protos[labels] + rng.normal(size=(rows, 32, 32, 3))).astype(np.float32)
    data = Dataset.from_arrays(features=images, label=labels.astype(np.int32))
    model = cifar10_cnn()
    log(f"cifar10_cnn ADAG: {model.count_params()} params, 2 workers, batch {batch}, window "
        f"{window}, adam, {rows} prototype images 32x32x3")
    def trainer():
        return ADAG(model, "adam", num_workers=2, batch_size=batch, communication_window=window,
                    seed=SEED, device_cache="auto")

    trainer().train(data.take(4 * batch))  # warm-up: cuDNN's choice of algorithms
    torch.cuda.synchronize()
    reset_counts()
    tr = trainer()
    t0 = time.perf_counter()
    trained = tr.train(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    hist = tr.get_history()
    n_windows = sum(len(w) for w in tr.window_times)
    check(tr.parameter_server.num_commits == n_windows == 2 * windows,
          f"8: {tr.parameter_server.num_commits} commits, {n_windows} windows")
    check(counts == expected(), f"8: our kernels launched on the CNN path: {counts}")
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"8: non-finite loss {losses}")
    first, last = first_last(hist, window)
    check(last < first, f"8: loss did not fall: {first} -> {last}")
    acc = float((trained.predict(images[:512]).argmax(-1) == labels[:512]).mean())
    log(f"  8: {len(hist)} steps in {wall:.3f} s ({len(hist) * batch / wall:.0f} images/s over "
        f"both), {n_windows} windows = commits; loss {first:.4f} -> {last:.4f}; center's "
        f"accuracy on 512 training images {acc:.3f}; launches {counts}")


# -- phase 9: resnet50 ---------------------------------------------------------


def rel_norm(a, b) -> float:
    """||a - b|| / ||b|| over tensors or dicts of tensors, in float64."""
    if isinstance(b, dict):
        return rel_gap(a, b)
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def max_abs(a, b) -> float:
    if isinstance(b, dict):
        return max(max_abs(a[k], b[k]) for k in b)
    return (a.double().cpu() - b.double().cpu()).abs().max().item()


def resnet_card_vs_cpu(rows=16, size=224):
    """9a: resnet50 on the card against the CPU, the same weights and
    images, at train=False and train=True (the statistics compared by
    their change, new - old: the old values are the same on both sides)."""
    import numpy as np
    import torch

    from distkeras_tpu_torch import resnet50

    model = resnet50(image_size=size)
    weights = model.init(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        for k, v in weights.items():  # every residual branch live, eval stats not trivial
            if k.endswith(".weight") and v.ndim == 1:
                v.copy_(1 + 0.2 * torch.randn(v.shape, device="cuda", generator=gen))
            elif k.endswith(".mean"):
                v.copy_(0.1 * torch.randn(v.shape, device="cuda", generator=gen))
            elif k.endswith(".var"):
                v.copy_(0.5 + torch.rand(v.shape, device="cuda", generator=gen))
    cpu_weights = {k: v.cpu() for k, v in weights.items()}
    x = np.random.default_rng(SEED).normal(size=(rows, size, size, 3)).astype(np.float32)
    exact_model = resnet50(image_size=size, dtype=torch.float32)
    for train in (False, True):
        with torch.no_grad():
            card, card_stats = model.apply(weights, torch.from_numpy(x).cuda(), train=train)
            t0 = time.perf_counter()
            cpu, cpu_stats = model.apply(cpu_weights, torch.from_numpy(x), train=train)
            cpu_s = time.perf_counter() - t0
            exact, exact_stats = exact_model.apply(cpu_weights, torch.from_numpy(x), train=train)
        torch.cuda.synchronize()
        outputs = [("logits", card.cpu(), cpu, exact)]
        if train:
            check(card_stats.keys() == cpu_stats.keys() and len(card_stats) == 2 * 53,
                  f"9a: {len(card_stats)} updated statistics")
            outputs.append(("batch_stats change",
                            {k: v.cpu() - cpu_weights[k] for k, v in card_stats.items()},
                            {k: v - cpu_weights[k] for k, v in cpu_stats.items()},
                            {k: v - cpu_weights[k] for k, v in exact_stats.items()}))
        for what, got, want, ref in outputs:
            rel, noise = rel_norm(got, want), rel_norm(want, ref)
            allowed = max(RESNET_REL_TOL, RESNET_NOISE_FACTOR * noise)
            finite = (all(bool(torch.isfinite(v).all()) for v in got.values())
                      if isinstance(got, dict) else bool(torch.isfinite(got).all()))
            log(f"  9a train={train} {what}: card vs CPU max abs {max_abs(got, want):.4g}, "
                f"relative norm {rel:.4g} (allowed {allowed:.4g}: max of {RESNET_REL_TOL} and "
                f"{RESNET_NOISE_FACTOR} x the CPU bf16 run's {noise:.4g} from float32); "
                f"CPU bf16 forward {cpu_s:.2f} s")
            check(finite and rel <= allowed, f"9a train={train} {what}: {rel} > {allowed}")
    del weights, cpu_weights
    torch.cuda.empty_cache()


def prototype_images(rows, size, classes, seed):
    """Seeded synthetic images: each row a class prototype plus noise; the
    labels are spread over the 1000 ImageNet classes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, classes, size=rows)
    protos = rng.standard_normal((classes, size, size, 3), dtype=np.float32)
    images = protos[ids] + 0.5 * rng.standard_normal((rows, size, size, 3), dtype=np.float32)
    labels = (ids * (1000 // classes)).astype(np.int32)
    return images, labels


def resnet_steady_steps(model, data, batch):
    """The resnet50 train step alone (adam, one state, batches on the
    device): 8 steps by the host clock, then 4 under the profiler."""
    import torch

    from distkeras_tpu_torch.data.feed import DeviceFeed, minibatches
    from distkeras_tpu_torch.ops.losses import get_optimizer
    from distkeras_tpu_torch.training.step import TrainState, make_train_step

    state = TrainState.create(model, get_optimizer("adam"), SEED)
    step = make_train_step(model, "categorical_crossentropy")
    batches = list(DeviceFeed(minibatches(data.take(4 * batch), batch)))

    def run(n):
        nonlocal state
        for i in range(n):
            state, _ = step(state, batches[i % len(batches)])

    run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(8)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 8 * 1e3
    log(f"  9b: steady resnet50 train step alone: {ms:.2f} ms/step, {batch / ms * 1e3:.0f} "
        f"images/s (8 steps, batch {batch}, batches on the device)")
    busy = profile("4 resnet50 train steps", lambda: run(4))
    log(f"  9b: device busy share of the step alone {busy:.1%}")


def resnet_aeasgd(batch=32, window=4, windows=3, size=224):
    """9b: AEASGD on resnet50, two workers on two streams."""
    import torch

    from distkeras_tpu_torch import AEASGD, Dataset, resnet50
    from distkeras_tpu_torch.telemetry.spans import Tracer, disable_tracing, enable_tracing

    model = resnet50(image_size=size)
    rows = 2 * batch * window * windows
    images, labels = prototype_images(rows, size, 16, SEED)
    data = Dataset.from_arrays(features=images, label=labels)
    log(f"resnet50 AEASGD: {model.count_params()} params, 2 workers, batch {batch} per worker, "
        f"window {window}, {windows} windows each, adam 1e-3, rho 100, {rows} prototype images "
        f"{size}x{size}x3")

    def trainer():
        return AEASGD(model, "adam", learning_rate=1e-3, rho=100.0, num_workers=2,
                      batch_size=batch, communication_window=window, seed=SEED)

    trainer().train(data.take(2 * batch * window))  # warm-up: cuDNN, allocator
    resnet_steady_steps(model, data, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tr = trainer()
    tracer = enable_tracing(Tracer())
    t0 = time.perf_counter()
    trained = tr.train(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    disable_tracing()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = tr.get_history()
    n_windows = sum(len(w) for w in tr.window_times)
    commits = tr.parameter_server.num_commits
    check(commits == n_windows == 2 * windows, f"9b: {commits} commits, {n_windows} windows")
    check(counts == expected(), f"9b: our kernels launched on the ResNet path: {counts}")
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(v) for v in losses), f"9b: non-finite loss {losses}")
    stats = {k: v for k, v in trained.variables.items() if k.endswith((".mean", ".var"))}
    check(len(stats) == 2 * 53 and all(bool(torch.isfinite(v).all()) for v in stats.values()),
          "9b: the returned BatchNorm statistics are not all finite")
    first, last = first_last(hist, window)
    totals = span_totals(tracer)
    apply_n, apply_s = totals.get(("ps_apply", None), [0, 0.0])
    log(f"  9b: {len(hist)} steps in {wall:.3f} s, {len(hist) * batch / wall:.1f} images/s over "
        f"both, {commits} commits = windows; loss first windows {first:.4f} -> last {last:.4f}; "
        f"peak memory {peak / 2**30:.2f} GiB; ps_apply {apply_n} x "
        f"{apply_s / max(apply_n, 1) * 1e3:.1f} ms; launches {counts}")
    for w, times in enumerate(tr.window_times):
        gaps = [b[0] - a[0] for a, b in zip(times, times[1:])]
        log(f"    worker {w}: ms between window completions "
            f"{[round(g * 1e3, 1) for g in gaps]}")
    log_spans(tracer)
    del tr, trained
    torch.cuda.empty_cache()
    sample = data.take(2 * batch * window * 2)
    busy = profile(f"AEASGD resnet50, 2 workers x 2 windows of {window} steps",
                   lambda: trainer().train(sample))
    log(f"  9b: device busy share {busy:.1%} (2 workers)")


# -- phases 10 and 11: checkpoints and the replica trainers -------------------


def bert_copy_task(seq, rows, seed=SEED):
    import numpy as np

    from distkeras_tpu_torch import Dataset
    from distkeras_tpu_torch.models import bert

    base = bert.bert_base_mlm(seq_len=seq)
    cfg = dataclasses.replace(base.config, use_flash_attention=True, dropout_rate=0.0)
    model = bert._make(cfg, seq, "bert_base_mlm")
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  size=(rows, seq)).astype(np.int32)
    return model, cfg, Dataset.from_arrays(features=tokens, label=tokens)


def train_launches(cfg, steps) -> dict:
    L = cfg.num_layers
    return expected(flash_attention_fwd=L * steps, flash_attention_dq=L * steps,
                    flash_attention_dkv=L * steps, fused_xent_fwd=steps, fused_xent_stats=steps,
                    fused_xent_grad=steps)


def checkpoint_phase(seq=128, batch=32, steps_per_epoch=3) -> tuple[dict, float]:
    """Phase 10; returns the launch counts of 10a and 10b and the resume
    difference of 10a."""
    import torch

    from distkeras_tpu_torch import (CheckpointManager, DynSGD, SynchronousDistributedTrainer,
                                     TrainedModel, load_weights_file, params_from_jax)

    model, cfg, data = bert_copy_task(seq, batch * steps_per_epoch)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    os.makedirs(CKPT_ROOT)

    def sync(epochs, **kw):
        return SynchronousDistributedTrainer(model, "adam", loss="fused_categorical_crossentropy",
                                             batch_size=batch, num_epoch=epochs, seed=SEED, **kw)

    sync(1).train(data.take(batch))  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    a = sync(2)
    t0 = time.perf_counter()
    trained_a = a.train(data, shuffle=True)
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    ck = os.path.join(CKPT_ROOT, "sync")
    b = sync(1, checkpoint_dir=ck)
    t0 = time.perf_counter()
    b.train(data, shuffle=True)
    torch.cuda.synchronize()
    b_s = time.perf_counter() - t0
    c = sync(2, checkpoint_dir=ck, resume=True)
    t0 = time.perf_counter()
    trained_c = c.train(data, shuffle=True)
    torch.cuda.synchronize()
    c_s = time.perf_counter() - t0
    counts_a = read_counts()
    steps = len(a.history) + len(b.history) + len(c.history)
    check(counts_a == train_launches(cfg, steps), f"10a: launches {counts_a} for {steps} steps")
    check(len(c.history) == len(a.history) - len(b.history) == steps_per_epoch,
          f"10a: histories A {len(a.history)}, B {len(b.history)}, C {len(c.history)}")
    diff = max_abs(trained_c.variables, trained_a.variables)
    loss_diff = max(abs(x["loss"] - y["loss"]) for x, y in
                    zip(c.history, a.history[len(b.history):]))
    log(f"  10a: sync A {len(a.history)} steps {a_s:.2f} s, B {len(b.history)} steps with the "
        f"final save {b_s:.2f} s, C resumed {len(c.history)} steps {c_s:.2f} s (restore and save "
        f"included); C - A: max abs weight difference {diff:.3g}, loss {loss_diff:.3g}; "
        f"checkpoint steps {CheckpointManager(ck).all_steps()}")
    check(diff == 0.0, f"10a: the resumed run is {diff} off the uninterrupted one")
    del a, b, c, trained_a, trained_c
    shutil.rmtree(ck)
    torch.cuda.empty_cache()

    # 10b: DynSGD, one worker, the snapshot thread, then resume.
    window = 5
    _, _, async_data = bert_copy_task(seq, batch * window * 4, seed=SEED + 1)
    ck = os.path.join(CKPT_ROOT, "async")

    def dynsgd(**kw):
        return DynSGD(model, "adam", loss="fused_categorical_crossentropy", num_workers=1,
                      batch_size=batch, communication_window=window, seed=SEED,
                      checkpoint_dir=ck, **kw)

    reset_counts()
    tr = dynsgd(checkpoint_interval_s=0.5)
    savers = []
    save_center = tr._save_center

    def counting_save(mgr, ps, center=None):
        savers.append(threading.current_thread().name)
        return save_center(mgr, ps, center)

    tr._save_center = counting_save
    t0 = time.perf_counter()
    trained = tr.train(async_data)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ps = tr.parameter_server
    mgr = CheckpointManager(ck)
    saved = mgr.restore()
    mgr.close()
    center_gap = max_abs(saved["ps"]["center"], {k: trained.variables[k]
                                                 for k in saved["ps"]["center"]})
    second = dynsgd(resume=True)
    started = {}
    service = second.service

    def recording_service(center):
        started.update({k: v.detach().cpu().clone() for k, v in center.items()})
        return service(center)

    second.service = recording_service
    second.train(async_data.take(batch * window))
    torch.cuda.synchronize()
    counts_b = read_counts()
    resume_gap = max_abs(started, saved["ps"]["center"])
    steps_b = len(tr.history) + len(second.history)
    log(f"  10b: DynSGD {len(tr.history)} steps in {run_s:.2f} s, {ps.num_commits} commits, "
        f"saves {len(savers)} ({savers.count('ps-checkpoint')} from the ps-checkpoint thread), "
        f"snapshot failures {ps.snapshot_failures}; last saved step {mgr.latest_step()} "
        f"{saved['meta']}; saved center vs the returned one {center_gap:.3g}; resumed PS start vs "
        f"the saved center {resume_gap:.3g}; launches {counts_b}")
    check(ps.snapshot_failures == 0, f"10b: {ps.snapshot_failures} snapshot failures")
    check("ps-checkpoint" in savers, "10b: the snapshot thread never saved")
    check(saved["meta"] == {"weight_version": ps.num_commits}, f"10b: meta {saved['meta']}")
    check(center_gap == 0.0 and resume_gap == 0.0,
          f"10b: saved {center_gap}, resumed {resume_gap}")
    check(counts_b == train_launches(cfg, steps_b), f"10b: launches {counts_b}")
    del tr, second, trained, saved, started
    shutil.rmtree(ck)
    torch.cuda.empty_cache()

    # 10c: the weight file of the 110M-parameter model.
    trained = TrainedModel(model, {k: v.cpu() for k, v in model.init(SEED).items()})
    path = os.path.join(CKPT_ROOT, "bert_base.npz")
    t0 = time.perf_counter()
    trained.save_weights(path)
    save_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    back = params_from_jax(load_weights_file(path), device="cpu")
    load_s = time.perf_counter() - t0
    same = back.keys() == trained.variables.keys() and all(
        back[k].dtype == v.dtype and torch.equal(back[k], v) for k, v in trained.variables.items())
    log(f"  10c: weight file {mb:.1f} MB, save {save_s:.3f} s ({mb / save_s:.0f} MB/s), load "
        f"{load_s:.3f} s ({mb / load_s:.0f} MB/s), bitwise {same}")
    check(same, "10c: the weight file did not round-trip bitwise")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    return {k: counts_a[k] + counts_b[k] for k in counts_a}, diff


def replica_phase(seq=128, batch=32, steps=3) -> dict:
    """Phase 11: EnsembleTrainer and AveragingTrainer, 2 replicas."""
    import torch

    from distkeras_tpu_torch import AveragingTrainer, EnsembleTrainer

    model, cfg, data = bert_copy_task(seq, 2 * batch * steps)
    kw = dict(loss="fused_categorical_crossentropy", batch_size=batch, num_epoch=1, seed=SEED)
    EnsembleTrainer(model, "adam", num_models=2, **kw).train(data.take(2 * batch))  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ens = EnsembleTrainer(model, "adam", num_models=2, **kw)
    members = ens.train(data, shuffle=True)
    torch.cuda.synchronize()
    ens_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    avg = AveragingTrainer(model, "adam", num_workers=2, **kw)
    averaged = avg.train(data, shuffle=True)
    torch.cuda.synchronize()
    avg_s = time.perf_counter() - t0
    counts = read_counts()
    check(len(ens.history) == len(avg.history) == steps, f"11: {len(ens.history)} steps")
    check(counts == train_launches(cfg, 4 * steps), f"11: launches {counts}")
    worst = 0.0
    for k, v in averaged.variables.items():
        mean = (members[0].variables[k] + members[1].variables[k]) / 2
        ulp = torch.finfo(torch.float32).eps * mean.abs().max().item()
        worst = max(worst, (v - mean).abs().max().item() / max(ulp, 1e-30))
    losses = [list(map(float, h["loss"])) for h in ens.history]
    log(f"  11: 2 replicas x {steps} steps: ensemble {ens_s:.3f} s "
        f"({ens_s / (2 * steps) * 1e3:.1f} ms a replica step), averaging {avg_s:.3f} s "
        f"({avg_s / (2 * steps) * 1e3:.1f} ms a replica step); losses per step {losses}; "
        f"average vs the mean of the members: {worst:.3g} float32 ulps of the largest weight "
        f"(allowed {AVERAGE_ATOL_ULPS}); launches {counts}")
    check(worst <= AVERAGE_ATOL_ULPS, f"11: average off the members' mean by {worst} ulps")
    return counts


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1 and 2 only and print their cases as one JSON line")
    ap.add_argument("--root", default=REPO,
                    help="checkout whose distkeras_tpu_torch is driven (default: this "
                         "script's), to time two versions of the kernels with one script")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "distkeras_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from distkeras_tpu_torch.ops.flash_attention import flash_forward
    from distkeras_tpu_torch.ops.fused_xent import fused_softmax_xent
    from distkeras_tpu_torch.utils.build import build_all

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = build_all()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(1, 64, 64, device="cuda", generator=gen).bfloat16().requires_grad_()
    flash_forward(q, q, q)[0].sum().backward()  # K1, K2, K3
    for dt in (torch.float32, torch.bfloat16):  # Triton compiles per dtype: K4, K5, K6
        x = torch.zeros(2, 8, device="cuda", dtype=dt, requires_grad=True)
        fused_softmax_xent(x, torch.zeros(2, dtype=torch.long, device="cuda")).backward()
    torch.cuda.synchronize()
    log(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for kernel, info in ptxas_summary(rep).items():
            log(f"  {name}: {kernel}: {info}")
            if root == REPO and kernel.startswith("flash_"):  # K1-K3
                check("0 bytes spill stores" in info, f"{kernel} spills: {info}")

    log("phase 2: kernels against their plain versions on the card")
    k1 = [flash_case(32, 128, 12, 64, False, 0, gen),
          flash_case(8, 512, 12, 64, True, 0, gen),
          flash_case(8, 512, 12, 64, True, 1, gen)]
    k4 = [xent_case(4096, 30522, torch.float32, gen),
          xent_case(4096, 30522, torch.bfloat16, gen),
          xent_case(4096, 50257, torch.float32, gen)]
    k23 = [flash_bwd_cases(32, 128, 12, 64, False, 0, gen),
           flash_bwd_cases(8, 512, 12, 64, True, 0, gen),
           flash_bwd_cases(8, 512, 12, 64, True, 1, gen)]
    k56 = [xent_bwd_cases(4096, 30522, torch.float32, gen),
           xent_bwd_cases(4096, 30522, torch.bfloat16, gen),
           xent_bwd_cases(4096, 50257, torch.float32, gen)]
    torch.cuda.empty_cache()
    phase2 = {"flash_attention_fwd": k1, "flash_attention_dq": [c[0] for c in k23],
              "flash_attention_dkv": [c[1] for c in k23], "fused_xent_fwd": k4,
              "fused_xent_stats": [c[0] for c in k56], "fused_xent_grad": [c[1] for c in k56]}
    if args.kernels_only:
        print(json.dumps({"root": root, "card": card, "cases": phase2}))
        return 0

    runs = []
    log("phase 3: bert_base_mlm inference at full width")
    runs.append(run_model("bert_base_mlm", 128, 64, 512, 32, 4))
    log("phase 4: gpt_small inference at full width")
    runs.append(run_model("gpt_small", 512, 8, 16, 8, 1))
    log("phase 5: bert_base_mlm training at full width")
    runs.append(train_model("bert_base_mlm", 128, 32, 256, 3, 2))
    log("phase 6: gpt_small training at full width")
    runs.append(train_model("gpt_small", 512, 8, 64, 2, 1))
    log("phase 7: bert_base_mlm asynchronous training (DynSGD) at full width")
    runs.append(async_bert())
    log("phase 8: cifar10_cnn asynchronous training (ADAG) at full width")
    async_cnn()
    log("phase 9: resnet50 at full width, card against CPU, then AEASGD")
    resnet_card_vs_cpu()
    resnet_aeasgd()
    log("phase 10: bert_base_mlm checkpoints and resume at full width")
    counts, _ = checkpoint_phase()
    runs.append(counts)
    log("phase 11: bert_base_mlm EnsembleTrainer and AveragingTrainer at full width")
    runs.append(replica_phase())
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")

    kernels = []
    flash_src = "distkeras_tpu/ops/pallas/flash_attention.py"
    xent_src = "distkeras_tpu/ops/pallas/fused_xent.py"
    for name, route, source, replaces in (
        ("flash_attention_fwd", "cuda", "distkeras_tpu_torch/csrc/flash_attention_fwd.cu",
         f"{flash_src}:189"),
        ("flash_attention_dq", "cuda", "distkeras_tpu_torch/csrc/flash_attention_bwd.cu",
         f"{flash_src}:214"),
        ("flash_attention_dkv", "cuda", "distkeras_tpu_torch/csrc/flash_attention_bwd.cu",
         f"{flash_src}:238"),
        ("fused_xent_fwd", "triton", "distkeras_tpu_torch/ops/fused_xent.py", f"{xent_src}:107"),
        ("fused_xent_stats", "triton", "distkeras_tpu_torch/ops/fused_xent.py",
         f"{xent_src}:127"),
        ("fused_xent_grad", "triton", "distkeras_tpu_torch/ops/fused_xent.py",
         f"{xent_src}:145"),
    ):
        cases = phase2[name]
        main_case = cases[0]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "shape": main_case["shape"],
            "cases": cases,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
12. Generation on gpt_small at full width (12 layers, hidden 768, 12 heads,
   vocab 50257, max_seq_len 512, bf16, random weights from a seed):
   generate() on 8 seeded prompts of 128 tokens, 128 greedy tokens (prefill
   ms, the median synchronized decode step, generated tokens/s, the device's
   busy share, peak memory, the KV cache's bytes); (a) the cached tokens
   against the card's own no-cache full-forward rollout, a row's first
   divergence allowed only at a bf16 tie; (b) the decode-step logits at 4
   steps against the full forward's at those positions, in relative norm,
   within 3x the CPU bf16 full forward's distance from float32; (c) sampling
   at temperature 0.8, top-k 50: the same seed twice gives the same tokens,
   another seed others, every token in its top 50; (d) beam_search at batch
   2, 4 beams, 32 tokens: K = 1 is greedy (up to a bf16 tie), the scores are
   sorted and equal the full forward's summed log-probabilities (atol 0.05,
   rtol 2e-3, the reference test's). No kernel of ours launches: decode runs
   dense attention and F.linear, as the reference's does.
13. Real-data acceptance on the UCI digits set (tests/data/digits.csv.gz):
   SingleTrainer, ADAG and AEASGD (4 workers on their streams; AEASGD at
   rho 50, window 8) with the reference test's split and settings: single
   above 0.93, each async trainer within 0.08 of it. No kernel of ours
   launches.
14. Serving on gpt_small at full width (bf16, random weights from the
   seed; engine slots 8, max_queue 64, prefix_cache_mb 64 with 16-token
   blocks, prefill_chunk 128, top_k 50). 14a: 32 seeded requests of 16-256
   prompt tokens (8 share a 128-token prefix), 64 new tokens each, half
   greedy and half at temperature 0.8, submitted in 4 waves of 8 while
   earlier ones decode: generated tokens/s, TTFT and inter-token p50/p99,
   the host gap and device idle ratio, prefix hit tokens, peak memory and
   the KV cache's bytes; every greedy request equals generate() on the card
   for its prompt alone up to a parting at a bf16 tie, every sampled token
   lies in its step's top 50 of one full forward (up to 3 bf16 ulps at the
   edge), one decode signature, every slot free after the drain, prefix-
   cache hits. 14b: the greedy requests through pipeline_depth=0 equal
   14a's, up to a parting at a bf16 tie. 14c: a ServingServer on port 0;
   the port's ServingClient streams 4 requests over JSONL and 4 over bin1,
   each stream equal to its done record; metricsz and healthz answer;
   stop(drain=True) completes. No kernel of ours launches.
15. Paged serving on gpt_small at full width (the same model, weights and
   seeded requests as 14; engine slots 8, paged with 16-token blocks,
   prefill_chunk 128, top_k 50). Phase 14's requests and its generate()
   rollouts are the greedy reference (no rollout again). 15a: kv_pool_mb
   256 (455 blocks), the 32 requests in 4 waves under an auditor armed
   after warm-up: greedy rows equal 14a's dense engine and generate() up
   to a parting at a bf16 tie, one decode signature, prefix hits through
   adopted blocks with no copy; tokens/s, TTFT and inter-token p50/p99,
   pool blocks peak and used, the profiler's busy share over one wave.
   15b: kv_pool_blocks 64 (1024 tokens) with the 16 greedy requests:
   preemptions above 0, every request finishes, its tokens equal 15a's up
   to a bf16 tie. 15c: 4 score requests (log-probabilities against one full
   forward on the card, within 3 x the CPU's bf16 distance from float32),
   4 embed requests (against the full forward's mean-pooled last
   activation, the same bound), 2 sample requests at n=4 (every fork's
   token in its step's top 50 of a full forward; the prompt's complete
   blocks shared, not copied). 15d: constrained=True, 4 rows under seeded
   TokenDFAs mixed with 4 free rows: every constrained token obeys its
   automaton, the free rows equal 15a's up to a bf16 tie, one decode
   signature. 15e: spec_k 4, paged and dense, drafted by gpt_small itself
   and by a random gpt_tiny(seq_len=512, vocab_size=50257): greedy tokens
   equal 15a's up to a bf16 tie, one signature each of decode, draft and
   verify; the acceptance rate and ms per verify tick. 15f: the reload
   verb through ServingServer with a weight file that the port's
   checkpoint.py wrote from seed 1: weight_version changes, and the greedy
   tokens after the swap equal a fresh engine's on the seed-1 weights up
   to a bf16 tie. The phase's wall time. No kernel of ours launches.
16. The fleet on gpt_small at full width (phase 14's model, weights and
   requests; 15a's rows are the greedy reference; replicas are paged
   engines with 15a's options and an armed auditor). 16a: a ServingCluster
   of two LocalReplicas behind the Router, 14a's 32 requests in 4 waves
   through the port's client over bin1: greedy rows equal 15a's up to a
   bf16 tie, the fleet healthz rollups, one request's merged tracez with
   the router's record and the replica's hop under one trace_id; client-
   observed generated tokens/s, TTFT and inter-token p50/p99, each
   replica's 1 - serving_device_idle_ratio. 16d (same fleet): one replica
   killed mid-wave: zero-streamed requests retried, only mid-stream losses
   end typed, the supervisor restarts it and it rejoins; then the router's
   reload rolls a published seed-1 weight file through the fleet under load
   with no client error, every later done line on the new version. 16e
   (same fleet): wire_controller; a WeightPublisher publishes seed-2
   weights, which deploy (deploy latency printed); a NaN publish is
   canary-rejected and quarantined and the fleet stays on last-good. 16b:
   roles prefill=1, decode=1, 14a's 16 greedy requests and one 496-token
   prompt whose 31 blocks (17.4 MiB of KVX1) cross as two KVXC frames:
   every done line carries a kv_migration with bytes, tokens equal 15a's
   (the long prompt: generate()'s) up to a bf16 tie, export -> import ->
   re-export on the card is bitwise; migration ms and MiB/s. 16c: one
   engine with a 64-block pool over a 64 MiB host tier and a disk tier:
   the 8 shared-prefix requests, the other greedy requests, the 8 again:
   spills and readmits above 0, round 2 equal to round 1 up to a bf16 tie,
   ms to readmit a block beside ms to re-prefill one. 16f: `python -m
   distkeras_tpu_torch.run cluster --model gpt_small --replicas 2 --paged
   ...` as a child: one stream over TCP equal to 15a's, `run debugz`
   renders the fleet page, sloz lists its objectives, the replicas' memory
   rows show bytes in use on cuda:0, SIGINT exits 0. No kernel of ours
   launches.
17. Print the kernels line, the card's name and power limit, and last the
   result line {"ok": true, "device": {...}}.

Phases 9-11, 15f and 16 write their checkpoints and weight files under
build/chip_smoke/ (git-ignored)
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


# -- phases 12 and 13: generation and real-data acceptance --------------------

# Phase 12. (b): the decode-step logits against the full forward's at the
# same positions, in relative norm, within this factor times the CPU's own
# bf16 full forward's distance from its float32 one (row 0, same positions).
DECODE_NOISE_FACTOR = 3.0
# (d): a beam's score against its sequence's summed log-probabilities from
# one full forward: the reference test's bounds (atol 0.05, rtol 2e-3).
BEAM_ATOL, BEAM_RTOL = 0.05, 2e-3
DECODE_CHECK_STEPS = (0, 42, 85, 127)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def first_divergence(got, want) -> list:
    """Per row, the first index where two token arrays differ, or None."""
    import numpy as np

    out = []
    for g, w in zip(got, want):
        diff = np.nonzero(g != w)[0]
        out.append(int(diff[0]) if diff.size else None)
    return out


def tie_at(model, variables, prefix, a: int, b: int) -> tuple[bool, float, float]:
    """Whether tokens ``a`` and ``b`` tie at bf16 resolution in the full
    forward's last-position logits over ``prefix`` ([1, S])."""
    import torch

    with torch.inference_mode():
        logits = model.apply(variables, torch.as_tensor(prefix, device="cuda"))[0][0, -1]
    la, lb = float(logits[a]), float(logits[b])
    return abs(la - lb) <= bf16_ulp(max(abs(la), abs(lb))), la, lb


def generation_phase(batch=8, prompt_len=128, new=128, sample_new=32, beam_batch=2,
                     beams=4, beam_new=32, profile_new=32) -> dict:
    """12: generate/beam_search on gpt_small at full width, bf16, random
    weights; returns the launch counts of our kernels (none expected)."""
    import numpy as np
    import torch

    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.inference import generate as gen
    from distkeras_tpu_torch.models import bert

    model = bert.gpt_small()
    cfg = model.config
    variables = model.init(SEED)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    dec, dec_cfg = gen._decode_module(model)
    log(f"gpt_small generation: {model.count_params()} params, layers {cfg.num_layers}, hidden "
        f"{cfg.hidden_size}, heads {cfg.num_heads}, vocab {cfg.vocab_size}, max_seq_len "
        f"{cfg.max_seq_len}, {cfg.dtype}; batch {batch}, prompt {prompt_len}, {new} new tokens")
    t_phase = time.perf_counter()
    # Warm-up at the measured shapes: cuBLAS handles and heuristics.
    dk.generate(model, variables, prompts, 2, greedy=True)
    dk.beam_search(model, variables, prompts[:beam_batch], 2, num_beams=beams)
    reset_counts()

    # The greedy loop step by step (generate's own functions), synchronized.
    p = torch.as_tensor(prompts, device="cuda")
    step_ms, kept = [], {}
    with torch.inference_mode():
        cache = gen._empty_cache(dec_cfg, batch, "cuda")
        kv_bytes = sum(v.numel() * v.element_size() for k, v in cache.items()
                       if k.endswith(("cached_key", "cached_value")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = gen._step(dec, variables, cache, p)
        tok = gen.greedy_ids(logits)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tokens, kept[0] = [tok], logits.float()
        for t in range(1, new):
            t0 = time.perf_counter()
            logits, cache = gen._step(dec, variables, cache, tokens[-1][:, None])
            tokens.append(gen.greedy_ids(logits))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if t in DECODE_CHECK_STEPS:
                kept[t] = logits.float()
        cached = torch.stack(tokens, dim=1).cpu().numpy()
        del cache
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # the weights and what earlier phases keep
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = dk.generate(model, variables, prompts, new, greedy=True)
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(out.shape == (batch, new) and out.dtype == np.int32, f"12: generate gave {out.shape}")
    check(np.array_equal(out, cached), "12: generate() differs from its own loop run step by step")
    log(f"  12: prefill {prefill_ms:.3f} ms ({batch} x {prompt_len} tokens); decode step median "
        f"{float(np.median(step_ms)):.3f} ms (min {min(step_ms):.3f}, max {max(step_ms):.3f}, "
        f"synchronized, {len(step_ms)} steps); generate() {gen_s:.3f} s for {batch} x {new} "
        f"tokens: {batch * new / gen_s:.1f} generated tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} "
        f"GiB held before the call; KV cache {kv_bytes / 1e6:.1f} MB ({kv_bytes} bytes)")
    busy = profile(f"generate, batch {batch}, prompt {prompt_len}, {profile_new} greedy tokens",
                   lambda: dk.generate(model, variables, prompts, profile_new, greedy=True))
    log(f"  12: device busy share over generate() {busy:.1%}; "
        f"{time.perf_counter() - t_phase:.2f} s into the phase")

    # (a) Cached against the card's own no-cache full-forward rollout.
    toks = torch.as_tensor(prompts, device="cuda")
    roll = []
    with torch.inference_mode():
        for _ in range(new):
            nxt = gen.greedy_ids(model.apply(variables, toks)[0][:, -1])
            roll.append(nxt)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    roll = torch.stack(roll, dim=1).cpu().numpy()
    matched = []
    for b, t in enumerate(first_divergence(cached, roll)):
        matched.append(new if t is None else t)
        if t is not None:
            prefix = np.concatenate([prompts[b], cached[b, :t]])[None]
            tie, la, lb = tie_at(model, variables, prefix, int(cached[b, t]), int(roll[b, t]))
            log(f"  12a: row {b} diverges at token {t}: cached {cached[b, t]} ({la:.6f}) vs "
                f"rollout {roll[b, t]} ({lb:.6f}) in the full forward's logits; bf16 tie {tie}")
            check(tie, f"12a: row {b} diverges at {t} without a bf16 tie")
    log(f"  12a: cached vs no-cache rollout, matched tokens per row {matched} of {new}; "
        f"{time.perf_counter() - t_phase:.2f} s into the phase")

    # (b) Decode-step logits against the full forward's at the same positions.
    seq = np.concatenate([prompts, cached[:, :-1]], axis=1)
    pos = [prompt_len - 1 + t for t in DECODE_CHECK_STEPS]
    with torch.inference_mode():
        full = model.apply(variables, torch.as_tensor(seq, device="cuda"))[0][:, pos]
        decoded = torch.stack([kept[t] for t in DECODE_CHECK_STEPS], dim=1)
        rel = rel_norm(decoded, full)
        del full, decoded
        cpu_vars = {k: v.cpu() for k, v in variables.items()}
        exact = bert._make(dataclasses.replace(cfg, dtype=torch.float32), 512, "gpt_small")
        t0 = time.perf_counter()
        row0 = torch.as_tensor(seq[:1])
        cpu_bf16 = model.apply(cpu_vars, row0)[0][:, pos]
        cpu_f32 = exact.apply(cpu_vars, row0)[0][:, pos]
        cpu_s = time.perf_counter() - t0
    noise = rel_norm(cpu_bf16, cpu_f32)
    allowed = DECODE_NOISE_FACTOR * noise
    log(f"  12b: decode-step logits vs the full forward at steps {list(DECODE_CHECK_STEPS)}: "
        f"relative norm {rel:.4g} (allowed {allowed:.4g} = {DECODE_NOISE_FACTOR} x the CPU bf16 "
        f"full forward's {noise:.4g} from float32, row 0; CPU forwards {cpu_s:.2f} s)")
    check(math.isfinite(rel) and rel <= allowed, f"12b: {rel} > {allowed}")
    log(f"  12b: {time.perf_counter() - t_phase:.2f} s into the phase")

    # (c) Sampling: the same seed twice, another once; tokens in their top 50.
    top_k, temp, seed = 50, 0.8, SEED + 1
    sp = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        g = torch.Generator(device="cuda").manual_seed(seed)
        temps = torch.full((batch,), temp, device="cuda")
        cache = gen._empty_cache(dec_cfg, batch, "cuda")
        logits, cache = gen._step(dec, variables, cache, sp)
        in_top, sampled = True, []
        for t in range(sample_new):
            tok = gen.sample_rows(logits, temps, g, top_k)
            kth = torch.topk(logits.float() / temp, top_k, dim=-1).values[:, -1]
            picked = logits.float().gather(1, tok.long()[:, None])[:, 0] / temp
            in_top = in_top and bool((picked >= kth).all())
            sampled.append(tok)
            if t + 1 < sample_new:
                logits, cache = gen._step(dec, variables, cache, tok[:, None])
        sampled = torch.stack(sampled, dim=1).cpu().numpy()
        del cache
    t0 = time.perf_counter()
    again = dk.generate(model, variables, prompts, sample_new, temperature=temp, top_k=top_k,
                        seed=seed)
    sample_s = time.perf_counter() - t0
    other = dk.generate(model, variables, prompts, sample_new, temperature=temp, top_k=top_k,
                        seed=seed + 1)
    log(f"  12c: sampling at temperature {temp}, top-k {top_k}, {sample_new} tokens: same seed "
        f"same tokens {np.array_equal(sampled, again)}, another seed differs in "
        f"{int((other != again).sum())} of {other.size}, every token in its top {top_k} "
        f"{in_top}; generate() {sample_s:.3f} s")
    check(np.array_equal(sampled, again), "12c: the same seed gave other tokens")
    check(bool((other != again).any()), "12c: another seed gave the same tokens")
    check(in_top, f"12c: a sampled token outside its top {top_k}")

    # (d) Beam search: K = 1 is greedy; scores sorted and equal to the full
    # forward's summed log-probabilities.
    bp = prompts[:beam_batch]
    greedy = dk.generate(model, variables, bp, beam_new, greedy=True)
    one, _ = dk.beam_search(model, variables, bp, beam_new, num_beams=1)
    for b, t in enumerate(first_divergence(one[:, 0], greedy)):
        if t is not None:
            prefix = np.concatenate([bp[b], greedy[b, :t]])[None]
            tie, la, lb = tie_at(model, variables, prefix, int(one[b, 0, t]), int(greedy[b, t]))
            log(f"  12d: K=1 row {b} diverges from greedy at {t}: {one[b, 0, t]} ({la:.6f}) vs "
                f"{greedy[b, t]} ({lb:.6f}); bf16 tie {tie}")
            check(tie, f"12d: K=1 beam row {b} diverges from greedy at {t} without a tie")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, scores = dk.beam_search(model, variables, bp, beam_new, num_beams=beams)
    beam_s = time.perf_counter() - t0
    flat = seqs.reshape(beam_batch * beams, beam_new)
    full_seq = np.concatenate([np.repeat(bp, beams, axis=0), flat[:, :-1]], axis=1)
    with torch.inference_mode():
        logp = torch.log_softmax(
            model.apply(variables, torch.as_tensor(full_seq, device="cuda"))[0][
                :, bp.shape[1] - 1:].float(), dim=-1)
        true = logp.gather(2, torch.as_tensor(flat, device="cuda").long()[:, :, None]).sum(
            dim=(1, 2)).reshape(beam_batch, beams).cpu().numpy()
    err = np.abs(true - scores)
    bound = BEAM_ATOL + BEAM_RTOL * np.abs(true)
    log(f"  12d: beam search, batch {beam_batch}, {beams} beams, {beam_new} tokens: {beam_s:.3f} "
        f"s, {beam_s / beam_new * 1e3:.3f} ms per token; scores {scores.tolist()}; against the "
        f"full forward's summed log-probs max abs {float(err.max()):.4g} (allowed "
        f"{BEAM_ATOL} + {BEAM_RTOL} x |score|); sorted {bool((np.diff(scores, 1) <= 0).all())}")
    check(seqs.shape == (beam_batch, beams, beam_new), f"12d: beam shape {seqs.shape}")
    check(bool((np.diff(scores, axis=1) <= 0).all()), "12d: beams not sorted")
    check(bool((err <= bound).all()), f"12d: beam scores off the full forward's: {err}")
    counts = read_counts()
    check(counts == expected(), f"12: our kernels launched on the decode path: {counts}")
    log(f"  12: phase wall {time.perf_counter() - t_phase:.2f} s")
    del variables, cpu_vars
    torch.cuda.empty_cache()
    return counts


DIGITS_CSV = os.path.join(REPO, "tests", "data", "digits.csv.gz")


def digits_phase() -> dict:
    """13: the reference's real-data acceptance on the card: SingleTrainer,
    ADAG and AEASGD (4 workers on their streams) on the UCI digits set;
    returns the launch counts of our kernels (none expected)."""
    import numpy as np
    import torch

    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models.core import Model
    from distkeras_tpu_torch.models.mlp import MLP

    table = np.loadtxt(DIGITS_CSV, delimiter=",", dtype=np.float64)
    ds = dk.Dataset.from_arrays(features=table[:, :-1].astype(np.float32),
                                label=table[:, -1].astype(np.float32))
    ds = dk.MinMaxTransformer(min=0, max=16, output_col="features").transform(ds)
    ds = ds.shuffle(seed=0)
    train, test = ds.slice(0, 1500), ds.slice(1500, len(ds))
    kwargs = dict(worker_optimizer="adam", learning_rate=1e-3, batch_size=32, num_epoch=20,
                  seed=0)

    def model():
        return Model(lambda: MLP(64, (64, 64), 10), name="digits_mlp", input_shape=(64,),
                     output_dim=10)

    def accuracy(trained):
        pred = dk.ModelPredictor(trained).predict(test)
        return dk.AccuracyEvaluator(prediction_col="prediction",
                                    label_col="label").evaluate(pred)

    reset_counts()
    accs = {}
    for name, extra in (("SingleTrainer", {}), ("ADAG", {"num_workers": 4}),
                        ("AEASGD", {"num_workers": 4, "rho": 50.0,
                                    "communication_window": 8})):
        t0 = time.perf_counter()
        trained = getattr(dk, name)(model(), **extra, **kwargs).train(train, shuffle=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        accs[name] = accuracy(trained)
        log(f"  13: {name}: test accuracy {accs[name]:.4f} on {test.num_rows} rows, train "
            f"{wall:.2f} s ({train.num_rows} rows x 20 epochs)")
    single = accs["SingleTrainer"]
    check(single > 0.93, f"13: SingleTrainer accuracy {single} <= 0.93")
    for name in ("ADAG", "AEASGD"):
        check(abs(accs[name] - single) < 0.08,
              f"13: {name} accuracy {accs[name]} not within 0.08 of single {single}")
    counts = read_counts()
    check(counts == expected(), f"13: our kernels launched on the digits MLP: {counts}")
    return counts


# -- phase 14: the serving engine and server -------------------------------------

# 14a: a sampled token counts as within its step's top k when its logit in
# one full forward over the request's sequence is at least the k-th largest
# less this many bf16 ulps of it: the full forward's logits differ from the
# decode step's by a few bf16 ulps (phase 12b), which can reorder the top k's
# edge.
TOPK_EDGE_ULPS = 3


def _run_requests(engine, waves, tokens_before_next=16):
    """Submit ``waves`` (lists of (prompt, max_new, temperature)) to a
    running ``engine``: wave k+1 once every request of wave k has streamed
    ``tokens_before_next`` tokens (or ended), so that each wave arrives
    while the one before decodes. Returns each request's tokens, in order,
    and the wall seconds from the first submit to the last token."""
    import asyncio

    async def go():
        task = asyncio.create_task(engine.run())
        try:
            t0 = time.perf_counter()
            reqs = []
            for wave in waves:
                batch = [engine.submit(p, n, temperature=temp) for p, n, temp in wave]
                reqs += batch
                while not all(r.done.is_set() or len(r.out_tokens) >= tokens_before_next
                              for r in batch):
                    await asyncio.sleep(0.002)
            outs = [await r.result() for r in reqs]
            return outs, time.perf_counter() - t0
        finally:
            engine.shutdown(drain=True)
            await task

    return asyncio.run(go())


def _greedy_parts_at_ties(tag, model, variables, prompts, got, want) -> list:
    """Per request, how many tokens ``got`` and ``want`` share before they
    part; a parting is allowed only at a bf16 tie of the two tokens in the
    full forward's logits over the shared prefix."""
    import numpy as np

    matched = []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        t = first_divergence([np.asarray(g)], [np.asarray(w)])[0]
        matched.append(len(g) if t is None else t)
        if t is not None:
            prefix = np.asarray([list(p) + list(g[:t])], np.int32)
            tie, la, lb = tie_at(model, variables, prefix, int(g[t]), int(w[t]))
            log(f"  {tag}: request {i} parts at token {t}: {g[t]} ({la:.6f}) vs {w[t]} "
                f"({lb:.6f}) in the full forward's logits; bf16 tie {tie}")
            check(tie, f"{tag}: request {i} parts at {t} without a bf16 tie")
    return matched


def serving_phase(slots=8, waves=4, per_wave=8, new=64, shared_len=128, min_len=16,
                  max_len=256, temperature=0.8, top_k=50, chunk=128, server_requests=4) -> dict:
    """14: the port's ServingEngine on gpt_small at full width (bf16, random
    weights from the seed), then behind ServingServer; returns the launch
    counts of our kernels (none expected)."""
    import asyncio

    import numpy as np
    import torch

    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models import bert
    from distkeras_tpu_torch.serving import ServingClient, ServingEngine, ServingServer

    card = card_line()
    model = bert.gpt_small()
    cfg = model.config
    variables = model.init(SEED)
    rng = np.random.default_rng(SEED + 14)
    n = waves * per_wave
    lengths = rng.integers(min_len, max_len + 1, size=n)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(L)).tolist() for L in lengths]
    # 8 prompts share a 128-token prefix, two in each wave, one greedy and
    # one sampled, so that later waves can hit what the first stored.
    shared = rng.integers(0, cfg.vocab_size, size=shared_len).tolist()
    shared_ids = [w * per_wave + j for w in range(waves) for j in (0, 1)]
    for i in shared_ids:
        tail = int(rng.integers(1, max_len - shared_len + 1))
        prompts[i] = shared + rng.integers(0, cfg.vocab_size, size=tail).tolist()
    temps = [0.0 if i % 2 == 0 else temperature for i in range(n)]
    greedy_ids = [i for i in range(n) if temps[i] <= 0]
    kw = dict(slots=slots, max_queue=64, prefix_cache_mb=64, prefix_block_tokens=16,
              prefill_chunk=chunk, top_k=top_k, seed=SEED)
    log(f"gpt_small serving: layers {cfg.num_layers}, hidden {cfg.hidden_size}, heads "
        f"{cfg.num_heads}, vocab {cfg.vocab_size}, max_seq_len {cfg.max_seq_len}, {cfg.dtype}; "
        f"{n} requests in {waves} waves of {per_wave}, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens ({len(shared_ids)} share a {shared_len}-token "
        f"prefix), {new} new tokens each, {len(greedy_ids)} greedy and "
        f"{n - len(greedy_ids)} at temperature {temperature}; engine {kw}")
    t_phase = time.perf_counter()
    # Warm-up on an engine of its own: cuBLAS at the prefill and decode shapes.
    warm = ServingEngine(model, variables, **kw)
    _run_requests(warm, [[(prompts[0][:chunk + 8], 4, 0.0), (prompts[1][:20], 4, 0.8)]])
    del warm
    torch.cuda.empty_cache()
    reset_counts()

    # 14a: four waves of eight, submitted while earlier ones decode.
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, variables, **kw)
    kv_bytes = sum(v.numel() * v.element_size() for k, v in engine._cache.items()
                   if k.endswith(("cached_key", "cached_value")))
    waves_in = [[(prompts[i], new, temps[i]) for i in range(w * per_wave, (w + 1) * per_wave)]
                for w in range(waves)]
    log(f"  14: warm-up done {time.perf_counter() - t_phase:.2f} s into the phase")
    outs, wall = _run_requests(engine, waves_in)
    peak = torch.cuda.max_memory_allocated()
    summ = engine.metrics.summary()
    stats = engine.prefix_cache.stats()
    generated = sum(len(o) for o in outs)
    log(f"  14a ({card}): {generated} tokens generated in {wall:.3f} s: {generated / wall:.1f} "
        f"generated tokens/s; TTFT p50 {summ['ttft_p50_s'] * 1e3:.3f} ms, p99 "
        f"{summ['ttft_p99_s'] * 1e3:.3f} ms; inter-token p50 "
        f"{summ['inter_token_p50_s'] * 1e3:.3f} ms, p99 {summ['inter_token_p99_s'] * 1e3:.3f} "
        f"ms; queue wait p50 {summ['queue_wait_p50_s'] * 1e3:.3f} ms; prefill device p50 "
        f"{summ['prefill_device_p50_s'] * 1e3:.3f} ms; decode iterations "
        f"{int(summ['decode_iterations'])}")
    log(f"  14a ({card}): host gap mean {summ.get('host_gap_mean_s', float('nan')) * 1e3:.4f} "
        f"ms (p50 {summ.get('host_gap_p50_s', float('nan')) * 1e3:.4f}, p99 "
        f"{summ.get('host_gap_p99_s', float('nan')) * 1e3:.4f}); device idle ratio "
        f"{summ.get('device_idle_ratio', float('nan')):.4f}; prefix cache hit tokens "
        f"{stats['hit_tokens']} of {stats['hit_tokens'] + stats['miss_tokens']} in "
        f"{stats['hit_requests']} requests, {stats['blocks_used']} of "
        f"{stats['capacity_blocks']} blocks used, {stats['evicted_blocks']} evicted; peak "
        f"memory {peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held before; KV cache {kv_bytes / 1e6:.1f} MB ({kv_bytes} "
        f"bytes)")
    check(all(len(o) == new for o in outs), "14a: a request ended short")
    check(engine.decode_compile_count() == 1,
          f"14a: decode_compile_count {engine.decode_compile_count()}")
    check(engine.active_slots == 0 and engine.free_slots == slots, "14a: slots not free")
    check(stats["hit_tokens"] > 0 and stats["hit_requests"] > 0, "14a: no prefix-cache hit")
    # Greedy requests against generate() on the card, each prompt alone.
    t0 = time.perf_counter()
    alone = {i: dk.generate(model, variables, np.asarray([prompts[i]], np.int32), new,
                            greedy=True)[0].tolist() for i in greedy_ids}
    gen_s = time.perf_counter() - t0
    matched = _greedy_parts_at_ties("14a", model, variables,
                                    [prompts[i] for i in greedy_ids],
                                    [outs[i] for i in greedy_ids],
                                    [alone[i] for i in greedy_ids])
    log(f"  14a: greedy requests vs generate() alone, matched tokens {matched} of {new} "
        f"(generate() {gen_s:.2f} s for {len(greedy_ids)} prompts); "
        f"{time.perf_counter() - t_phase:.2f} s into the phase")
    # Sampled tokens in their step's top k of one full forward.
    inside, edge, short = 0, 0, 0.0
    with torch.inference_mode():
        for i in range(n):
            if temps[i] <= 0:
                continue
            seq = prompts[i] + outs[i][:-1]
            logits = model.apply(variables, torch.as_tensor([seq], device="cuda"))[0][0].float()
            rows = logits[len(prompts[i]) - 1:]
            kth = torch.topk(rows, top_k, dim=-1).values[:, -1]
            picked = rows.gather(1, torch.as_tensor(outs[i], device="cuda")[:, None])[:, 0]
            inside += int((picked >= kth).sum())
            ulp = torch.as_tensor([bf16_ulp(float(x)) for x in kth.cpu()], device="cuda")
            near = (picked < kth) & (picked >= kth - TOPK_EDGE_ULPS * ulp)
            edge += int(near.sum())
            short = max(short, float((kth - picked).clamp(min=0).max()))
            check(bool((picked >= kth - TOPK_EDGE_ULPS * ulp).all()),
                  f"14a: request {i} sampled a token outside its top {top_k}")
    sampled_total = (n - len(greedy_ids)) * new
    log(f"  14a: sampled tokens in their step's top {top_k} of the full forward: {inside} of "
        f"{sampled_total} strictly, {edge} within {TOPK_EDGE_ULPS} bf16 ulps of the edge "
        f"(largest shortfall {short:.5f}); {time.perf_counter() - t_phase:.2f} s into the phase")
    # The device's busy share over one more pipelined wave, under the profiler.
    prof_engine = ServingEngine(model, variables, **kw)
    busy = profile(f"ServingEngine, {per_wave} greedy requests, {new // 8} new tokens each",
                   lambda: _run_requests(prof_engine, [[(prompts[i], new // 8, 0.0)
                                                        for i in greedy_ids[:per_wave]]]))
    log(f"  14a ({card}): device busy share over a pipelined wave {busy:.1%}; "
        f"{time.perf_counter() - t_phase:.2f} s into the phase")
    del prof_engine

    # 14b: the greedy requests again, through pipeline_depth=0.
    engine0 = ServingEngine(model, variables, pipeline_depth=0, **kw)
    greedy_waves = [[(prompts[i], new, 0.0) for i in greedy_ids[w::waves]] for w in range(waves)]
    order = [i for w in range(waves) for i in greedy_ids[w::waves]]
    outs0, wall0 = _run_requests(engine0, greedy_waves)
    summ0 = engine0.metrics.summary()
    matched0 = _greedy_parts_at_ties("14b", model, variables, [prompts[i] for i in order],
                                     outs0, [outs[i] for i in order])
    log(f"  14b ({card}): pipeline_depth=0, {len(order)} greedy requests in {wall0:.3f} s "
        f"({sum(map(len, outs0)) / wall0:.1f} generated tokens/s, host gap mean "
        f"{summ0.get('host_gap_mean_s', float('nan')) * 1e3:.4f} ms, device idle ratio "
        f"{summ0.get('device_idle_ratio', float('nan')):.4f}); tokens equal to 14a's in "
        f"{sum(m == new for m in matched0)} of {len(order)} requests, matched {matched0}")
    check(engine0.decode_compile_count() == 1, "14b: decode_compile_count != 1")
    log(f"  14b: {time.perf_counter() - t_phase:.2f} s into the phase")
    del engine, engine0
    torch.cuda.empty_cache()

    # 14c: ServingServer on port 0, the port's client over JSONL and bin1.
    picks = greedy_ids[:2 * server_requests]

    async def serve():
        server = ServingServer(ServingEngine(model, variables, **kw), port=0)
        await server.start()

        async def one(i, wire_mode):
            streamed = []
            async with ServingClient("127.0.0.1", server.port, wire_mode=wire_mode) as c:
                done = await c.generate(prompts[i], new, on_token=streamed.append)
                return streamed, done, c.proto

        try:
            got = await asyncio.gather(*(
                one(i, "jsonl" if k < server_requests else "bin1") for k, i in enumerate(picks)))
            async with ServingClient("127.0.0.1", server.port) as c:
                snap = await c.metricsz()
                prom = await c.metricsz(format="prometheus")
                health = await c.healthz()
        finally:
            await server.stop(drain=True)
        return got, snap, prom, health

    t0 = time.perf_counter()
    got, snap, prom, health = asyncio.run(serve())
    serve_s = time.perf_counter() - t0
    protos = [proto for _, _, proto in got]
    log(f"  14c: ServingServer, {server_requests} requests over JSONL and {server_requests} over "
        f"bin1 ({protos}), {new} tokens each, {serve_s:.3f} s; metricsz "
        f"{len(snap)} series, {len(prom.splitlines())} Prometheus lines; healthz slots "
        f"{health['slots']}, active {health['active_slots']}, decode_compile_count "
        f"{health['decode_compile_count']}, device memory {health['device_memory']}")
    check(protos == ["jsonl"] * server_requests + ["bin1"] * server_requests,
          f"14c: protocols {protos}")
    for (streamed, done, _), i in zip(got, picks):
        check(streamed == done["tokens"] and len(streamed) == new,
              f"14c: request {i} streamed tokens differ from its done record")
    check(snap["serving_requests_completed_total"]["value"] == len(picks),
          "14c: metricsz does not count the requests")
    check("# TYPE serving_ttft_seconds histogram" in prom, "14c: no Prometheus page")
    check(health["slots"] == slots and health["decode_compile_count"] == 1,
          f"14c: healthz {health}")
    counts = read_counts()
    check(counts == expected(), f"14: our kernels launched on the serving path: {counts}")
    log(f"  14: phase wall {time.perf_counter() - t_phase:.2f} s ({card})")
    torch.cuda.empty_cache()
    served = {"model": model, "variables": variables, "prompts": prompts, "temps": temps,
              "outs": outs, "alone": alone, "new": new, "waves": waves,
              "per_wave": per_wave}
    return counts, served


# -- phase 15: paged serving ----------------------------------------------------

def _greedy_check(tag, model, variables, prompts, got, want) -> list:
    """The 14a tie check, plus the count of requests equal over all their
    tokens."""
    matched = _greedy_parts_at_ties(tag, model, variables, prompts, got, want)
    equal = sum(list(g) == list(w) for g, w in zip(got, want))
    log(f"  {tag}: {equal} of {len(got)} requests equal over all their tokens, matched "
        f"{matched}")
    return matched


def _seeded_dfa(rng, vocab, states=3, width=4) -> dict:
    """A cyclic token automaton: state s allows ``width`` seeded tokens,
    each leading to state s + 1 (mod ``states``); no terminal state."""
    edges = []
    for s in range(states):
        for tok in rng.choice(vocab, size=width, replace=False):
            edges.append([s, int(tok), (s + 1) % states])
    return {"start": 0, "edges": edges}


def _dfa_obeyed(spec, tokens) -> bool:
    table = {}
    for s, tok, nxt in spec["edges"]:
        table[(s, tok)] = nxt
    state = spec["start"]
    for tok in tokens:
        if (state, tok) not in table:
            return False
        state = table[(state, tok)]
    return True


def _spec_ticks(engine) -> tuple[int, float]:
    """Speculative ticks in the engine's tick lane and their mean
    dispatch-to-harvest ms (a spec tick is harvested before the next
    dispatch, so this is its wall)."""
    ticks = [t for t in engine.tick_timeline() if t["kind"] == "spec"]
    if not ticks:
        return 0, float("nan")
    return len(ticks), 1e3 * sum(t["t_harvest"] - t["t_dispatch"] for t in ticks) / len(ticks)


def _cpu_noise(model, cfg, variables, seq) -> tuple[float, float]:
    """The CPU's bf16 full forward's relative distance from its float32 one
    over ``seq``: of the next-token log-probabilities and of the mean-pooled
    last activation. Phase 15c's bounds are 3 x these (phase 12b's rule)."""
    import torch

    from distkeras_tpu_torch.models import bert

    exact = bert._make(dataclasses.replace(cfg, dtype=torch.float32), 512, "gpt_small")
    cpu_vars = {k: v.cpu() for k, v in variables.items()}
    row = torch.as_tensor([seq])
    with torch.inference_mode():
        lp = [torch.log_softmax(m.apply(cpu_vars, row)[0][0].float(), -1) for m in (model, exact)]
        hid = [m.apply(cpu_vars, row, return_hidden=True)[0][0].float().mean(0)
               for m in (model, exact)]
    targets = torch.as_tensor(seq[1:])[:, None]
    picked = [x[:-1].gather(1, targets)[:, 0] for x in lp]
    return rel_norm(picked[0], picked[1]), rel_norm(hid[0], hid[1])


def paged_phase(served, slots=8, chunk=128, top_k=50, pool_mb=256, tight_blocks=64,
                kind_requests=4, forks=4, fork_requests=2, constrained_new=32, spec_new=32,
                reload_new=16) -> dict:
    """15: the paged ServingEngine on gpt_small at full width, on phase
    14's model, weights and requests; returns the launch counts of our
    kernels (none expected)."""
    import asyncio

    import numpy as np
    import torch

    from distkeras_tpu_torch.checkpoint import save_weights_file
    from distkeras_tpu_torch.models import bert
    from distkeras_tpu_torch.serving import ServingClient, ServingEngine, ServingServer
    from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
    from distkeras_tpu_torch.utils.bridge import params_to_jax

    card = card_line()
    model, variables = served["model"], served["variables"]
    prompts, temps, outs, alone = (served[k] for k in ("prompts", "temps", "outs", "alone"))
    new, waves, per_wave = served["new"], served["waves"], served["per_wave"]
    cfg = model.config
    n = len(prompts)
    greedy_ids = [i for i in range(n) if temps[i] <= 0]
    base = dict(slots=slots, max_queue=64, paged=True, kv_block_tokens=16,
                prefill_chunk=chunk, top_k=top_k, seed=SEED)
    log(f"gpt_small paged serving: engine {base}; 15a kv_pool_mb {pool_mb}, 15b kv_pool_blocks "
        f"{tight_blocks}")
    t_phase = time.perf_counter()
    warm = ServingEngine(model, variables, kv_pool_mb=pool_mb, **base)
    _run_requests(warm, [[(prompts[0][:chunk + 8], 4, 0.0), (prompts[1][:20], 4, 0.8)]])
    del warm
    torch.cuda.empty_cache()
    reset_counts()

    # 15a: phase 14a's four waves through a 256 MiB pool, auditor armed.
    auditor = RecompileAuditor()
    engine = ServingEngine(model, variables, kv_pool_mb=pool_mb, auditor=auditor,
                           arm_auditor_after_warmup=True, **base)
    pool = engine.kv_pool
    waves_in = [[(prompts[i], new, temps[i]) for i in range(w * per_wave, (w + 1) * per_wave)]
                for w in range(waves)]
    outs_a, wall = _run_requests(engine, waves_in)
    summ = engine.metrics.summary()
    stats = pool.stats()
    generated = sum(len(o) for o in outs_a)
    log(f"  15a ({card}): {generated} tokens generated in {wall:.3f} s: {generated / wall:.1f} "
        f"generated tokens/s; TTFT p50 {summ['ttft_p50_s'] * 1e3:.3f} ms, p99 "
        f"{summ['ttft_p99_s'] * 1e3:.3f} ms; inter-token p50 "
        f"{summ['inter_token_p50_s'] * 1e3:.3f} ms, p99 {summ['inter_token_p99_s'] * 1e3:.3f} "
        f"ms; prefill device p50 {summ['prefill_device_p50_s'] * 1e3:.3f} ms; host gap mean "
        f"{summ.get('host_gap_mean_s', float('nan')) * 1e3:.4f} ms, device idle ratio "
        f"{summ.get('device_idle_ratio', float('nan')):.4f}")
    log(f"  15a: pool {pool.capacity} blocks of {pool.bytes_per_block} bytes, peak "
        f"{stats['peak_blocks_used']} used, {stats['blocks_used']} used after the drain "
        f"(adopted into the trie); preemptions {engine.metrics.preemptions}; prefix hit tokens "
        f"{stats['hit_tokens']} of {stats['hit_tokens'] + stats['miss_tokens']} in "
        f"{stats['hit_requests']} requests; {stats['inserted_blocks']} blocks adopted, "
        f"{stats['evicted_blocks']} evicted; decode signatures "
        f"{auditor.compiles('serving_decode')}")
    check(all(len(o) == new for o in outs_a), "15a: a request ended short")
    check(auditor.compiles("serving_decode") == 1 and engine.decode_compile_count() == 1,
          f"15a: decode signatures {auditor.compiles('serving_decode')}")
    check(auditor.report()["serving_decode"]["armed"], "15a: the auditor was not armed")
    check(engine.active_slots == 0 and engine.prefix_cache is None, "15a: slots or a copy cache")
    check(stats["hit_tokens"] > 0 and stats["hit_requests"] > 0, "15a: no prefix hit")
    check(stats["inserted_blocks"] > 0 and stats["fork_cow_copies"] == 0,
          "15a: prefix blocks were not adopted in place")
    served["outs_paged"] = outs_a
    order = greedy_ids
    _greedy_check("15a vs 14a", model, variables, [prompts[i] for i in order],
                  [outs_a[i] for i in order], [outs[i] for i in order])
    _greedy_check("15a vs generate()", model, variables, [prompts[i] for i in order],
                  [outs_a[i] for i in order], [alone[i] for i in order])
    log(f"  15a: {time.perf_counter() - t_phase:.2f} s into the phase")
    prof_engine = ServingEngine(model, variables, kv_pool_mb=pool_mb, **base)
    busy = profile(f"paged ServingEngine, {per_wave} greedy requests, {new // 8} new tokens each",
                   lambda: _run_requests(prof_engine, [[(prompts[i], new // 8, 0.0)
                                                        for i in greedy_ids[:per_wave]]]))
    log(f"  15a ({card}): device busy share over a pipelined paged wave {busy:.1%}; "
        f"{time.perf_counter() - t_phase:.2f} s into the phase")
    del prof_engine, engine

    # 15b: the greedy requests through a 64-block pool: preemption.
    tight = ServingEngine(model, variables, kv_pool_blocks=tight_blocks, **base)
    outs_b, wall_b = _run_requests(tight, [[(prompts[i], new, 0.0) for i in greedy_ids]])
    sb = tight.kv_pool.stats()
    log(f"  15b ({card}): {len(greedy_ids)} greedy requests through {tight_blocks} blocks in "
        f"{wall_b:.3f} s ({sum(map(len, outs_b)) / wall_b:.1f} generated tokens/s); "
        f"preemptions {tight.metrics.preemptions}, peak blocks {sb['peak_blocks_used']}, "
        f"prefix hit tokens {sb['hit_tokens']}, evicted {sb['evicted_blocks']}")
    check(tight.metrics.preemptions > 0, "15b: no preemption")
    check(all(len(o) == new for o in outs_b), "15b: a request ended short")
    check(tight.decode_compile_count() == 1, "15b: decode signatures != 1")
    _greedy_check("15b vs 15a", model, variables, [prompts[i] for i in greedy_ids], outs_b,
                  [outs_a[i] for i in greedy_ids])
    log(f"  15b: {time.perf_counter() - t_phase:.2f} s into the phase")
    del tight

    # 15c: score, embed and sample requests.
    kinds = ServingEngine(model, variables, kv_pool_mb=pool_mb, **base)
    picks = greedy_ids[:kind_requests]
    fork_prompts = [prompts[i] for i in greedy_ids[kind_requests:kind_requests + fork_requests]]

    async def kind_run():
        task = asyncio.create_task(kinds.run())
        try:
            reqs = ([kinds.submit(prompts[i], 0, kind="score") for i in picks]
                    + [kinds.submit(prompts[i], 0, kind="embed") for i in picks]
                    + [kinds.submit(p, new // 4, kind="sample", n=forks, temperature=0.8,
                                    speculate=False) for p in fork_prompts])
            for r in reqs:
                await r.result()
            return reqs
        finally:
            kinds.shutdown(drain=True)
            await task

    t0 = time.perf_counter()
    reqs = asyncio.run(kind_run())
    kinds_s = time.perf_counter() - t0
    scores, embeds, samples = (reqs[:kind_requests], reqs[kind_requests:2 * kind_requests],
                               reqs[2 * kind_requests:])
    lp_noise, hid_noise = _cpu_noise(model, cfg, variables, prompts[picks[0]])
    score_rel, embed_rel = [], []
    with torch.inference_mode():
        for i, sr, er in zip(picks, scores, embeds):
            row = torch.as_tensor([prompts[i]], device="cuda")
            lp = torch.log_softmax(model.apply(variables, row)[0][0].float(), -1)
            want = lp[:-1].gather(1, row[0, 1:, None].long())[:, 0]
            score_rel.append(rel_norm(torch.as_tensor(sr.logprobs, device="cuda"), want))
            hid = model.apply(variables, row, return_hidden=True)[0][0].float().mean(0)
            embed_rel.append(rel_norm(torch.as_tensor(er.embedding, device="cuda"), hid))
    log(f"  15c ({card}): {kind_requests} score, {kind_requests} embed and {fork_requests} "
        f"sample (n={forks}) requests in {kinds_s:.3f} s; score relative norms {score_rel} "
        f"(allowed {DECODE_NOISE_FACTOR * lp_noise:.4g}); embed {embed_rel} (allowed "
        f"{DECODE_NOISE_FACTOR * hid_noise:.4g})")
    for rel in score_rel:
        check(math.isfinite(rel) and rel <= DECODE_NOISE_FACTOR * lp_noise,
              f"15c: score {rel} > {DECODE_NOISE_FACTOR * lp_noise}")
    for rel in embed_rel:
        check(math.isfinite(rel) and rel <= DECODE_NOISE_FACTOR * hid_noise,
              f"15c: embed {rel} > {DECODE_NOISE_FACTOR * hid_noise}")
    sk = kinds.kv_pool.stats()
    bt = kinds.kv_block_tokens
    shared_want = sum((forks - 1) * (len(p) // bt) for p in fork_prompts)
    cow_want = sum((forks - 1) * bool(len(p) % bt) for p in fork_prompts)
    log(f"  15c: forks shared {sk['forked_blocks_total']} extra block references (want "
        f"{shared_want}), {sk['fork_cow_copies']} tail blocks copied (want {cow_want})")
    check(sk["forked_blocks_total"] == shared_want and sk["fork_cow_copies"] == cow_want,
          "15c: fork block accounting")
    with torch.inference_mode():
        for p, r in zip(fork_prompts, samples):
            check(len(r.fork_completions) == forks, "15c: a fork is missing")
            for fork in r.fork_completions:
                seq = list(p) + fork[:-1]
                logits = model.apply(variables, torch.as_tensor([seq], device="cuda"))[0][0]
                rows = logits[len(p) - 1:].float()
                kth = torch.topk(rows, top_k, dim=-1).values[:, -1]
                picked = rows.gather(1, torch.as_tensor(fork, device="cuda")[:, None])[:, 0]
                ulp = torch.as_tensor([bf16_ulp(float(x)) for x in kth.cpu()], device="cuda")
                check(bool((picked >= kth - TOPK_EDGE_ULPS * ulp).all()),
                      f"15c: a fork sampled outside its top {top_k}")
    check(kinds.decode_compile_count() == 1, "15c: decode signatures != 1")
    log(f"  15c: {time.perf_counter() - t_phase:.2f} s into the phase")
    del kinds

    # 15d: constrained rows beside free ones.
    rng = np.random.default_rng(SEED + 15)
    dfas = [_seeded_dfa(rng, cfg.vocab_size) for _ in range(slots // 2)]
    free = greedy_ids[:slots // 2]
    cons_prompts = [prompts[i] for i in greedy_ids[slots // 2:slots]]
    c_auditor = RecompileAuditor()
    con = ServingEngine(model, variables, kv_pool_mb=pool_mb, constrained=True,
                        auditor=c_auditor, arm_auditor_after_warmup=True, **base)

    async def con_run():
        task = asyncio.create_task(con.run())
        try:
            reqs = [con.submit(p, constrained_new, constraint=d)
                    for p, d in zip(cons_prompts, dfas)]
            reqs += [con.submit(prompts[i], constrained_new) for i in free]
            return [await r.result() for r in reqs]
        finally:
            con.shutdown(drain=True)
            await task

    t0 = time.perf_counter()
    got_d = asyncio.run(con_run())
    log(f"  15d ({card}): {len(dfas)} constrained and {len(free)} free rows, {constrained_new} "
        f"tokens each, in {time.perf_counter() - t0:.3f} s; decode signatures "
        f"{c_auditor.compiles('serving_decode')}; mask uploads "
        f"{con.metrics.registry.snapshot()['mask_upload_seconds']['count']}")
    for k, (d, toks) in enumerate(zip(dfas, got_d[:len(dfas)])):
        check(len(toks) == constrained_new and _dfa_obeyed(d, toks),
              f"15d: constrained row {k} left its automaton: {toks}")
    check(c_auditor.compiles("serving_decode") == 1, "15d: decode signatures != 1")
    _greedy_check("15d free rows vs 15a", model, variables, [prompts[i] for i in free],
                  got_d[len(dfas):], [outs_a[i][:constrained_new] for i in free])
    log(f"  15d: {time.perf_counter() - t_phase:.2f} s into the phase")
    del con

    # 15e: speculative decoding, paged and dense, two drafts.
    tiny = bert.gpt_tiny(seq_len=512, vocab_size=cfg.vocab_size)
    tiny_vars = tiny.init(SEED + 1)
    spec_ids = greedy_ids[:slots]
    for draft_name, dm, dv in (("gpt_small", model, variables), ("gpt_tiny", tiny, tiny_vars)):
        for layout in ("paged", "dense"):
            kw = dict(base, kv_pool_mb=pool_mb) if layout == "paged" else {
                k: v for k, v in base.items() if k not in ("paged", "kv_block_tokens")}
            s_auditor = RecompileAuditor()
            spec = ServingEngine(model, variables, draft_model=dm, draft_variables=dv,
                                 spec_k=4, auditor=s_auditor, arm_auditor_after_warmup=True,
                                 **kw)
            got_e, wall_e = _run_requests(spec, [[(prompts[i], spec_new, 0.0)
                                                  for i in spec_ids]])
            ticks, tick_ms = _spec_ticks(spec)
            rate = spec.metrics.summary().get("spec_accept_rate", float("nan"))
            tag = f"15e {layout}, draft {draft_name}"
            log(f"  {tag} ({card}): {len(spec_ids)} greedy requests x {spec_new} tokens in "
                f"{wall_e:.3f} s ({sum(map(len, got_e)) / wall_e:.1f} generated tokens/s); "
                f"acceptance rate {rate:.4f}; {ticks} verify ticks, {tick_ms:.3f} ms per verify "
                f"tick; signatures {[s_auditor.compiles(x) for x in ('serving_decode', 'serving_draft', 'serving_verify')]}")
            for name in ("serving_decode", "serving_draft", "serving_verify"):
                check(s_auditor.compiles(name) == 1, f"{tag}: {name} signatures != 1")
            if draft_name == "gpt_small":
                check(rate > 0.9, f"{tag}: acceptance {rate} with the target as its draft")
            _greedy_check(tag, model, variables, [prompts[i] for i in spec_ids], got_e,
                          [outs_a[i][:spec_new] for i in spec_ids])
            del spec
    del tiny_vars
    log(f"  15e: {time.perf_counter() - t_phase:.2f} s into the phase")

    # 15f: the reload verb through ServingServer, seed-1 weights from a file.
    vars1 = model.init(SEED + 1)
    os.makedirs(CKPT_ROOT, exist_ok=True)
    path = os.path.join(CKPT_ROOT, "gpt_small_seed1.npz")
    save_weights_file(path, params_to_jax(vars1, model.module), version=2)
    picks_f = greedy_ids[:2]

    async def reload_run():
        server = ServingServer(ServingEngine(model, variables, kv_pool_mb=pool_mb, **base),
                               port=0)
        await server.start()
        try:
            async with ServingClient("127.0.0.1", server.port) as c:
                before = [await c.generate(prompts[i], reload_new) for i in picks_f]
                t0 = time.perf_counter()
                swapped = await c.reload(path)
                swap_s = time.perf_counter() - t0
                after = [await c.generate(prompts[i], reload_new) for i in picks_f]
        finally:
            await server.stop(drain=True)
        return before, swapped, swap_s, after

    before, swapped, swap_s, after = asyncio.run(reload_run())
    fresh = ServingEngine(model, vars1, kv_pool_mb=pool_mb, **base)
    want_f, _ = _run_requests(fresh, [[(prompts[i], reload_new, 0.0)] for i in picks_f])
    log(f"  15f ({card}): reload in {swap_s:.3f} s, weight_version "
        f"{before[0]['weight_version']} -> {swapped['weight_version']}")
    check(swapped["ok"] and swapped["weight_version"] != before[0]["weight_version"]
          and after[0]["weight_version"] == swapped["weight_version"],
          f"15f: weight_version {swapped}")
    _greedy_check("15f after reload vs a fresh seed-1 engine", model, vars1,
                  [prompts[i] for i in picks_f], [a["tokens"] for a in after], want_f)
    _greedy_check("15f before reload vs 15a", model, variables, [prompts[i] for i in picks_f],
                  [b["tokens"] for b in before], [outs_a[i][:reload_new] for i in picks_f])
    os.remove(path)
    del fresh, vars1
    counts = read_counts()
    check(counts == expected(), f"15: our kernels launched on the paged path: {counts}")
    log(f"  15: phase wall {time.perf_counter() - t_phase:.2f} s ({card})")
    torch.cuda.empty_cache()
    return counts


# -- phase 16: the serving fleet and deployment ----------------------------------

def _pct(xs, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else float("nan")


async def _client_waves(port, waves, tokens_before_next=16, **gen_kw):
    """Phase 14's wave schedule through the port's client over bin1, one
    connection a request: wave k+1 once each request of wave k has
    streamed ``tokens_before_next`` tokens (or ended). Returns each
    request's done record (None for a typed failure, with its streamed
    count), the client-side token times and the wall seconds."""
    import asyncio

    from distkeras_tpu_torch.serving import ServingClient
    from distkeras_tpu_torch.serving.client import ServerError

    t0 = time.perf_counter()
    n = sum(len(w) for w in waves)
    dones, stamps, failures = [None] * n, [[] for _ in range(n)], {}
    submit_t = [0.0] * n

    async def one(i, prompt, new, temp):
        submit_t[i] = time.perf_counter()
        async with ServingClient("127.0.0.1", port, wire_mode="bin1") as c:
            try:
                dones[i] = await c.generate(
                    prompt, new, temperature=temp,
                    on_token=lambda _t: stamps[i].append(time.perf_counter()), **gen_kw)
            except (ServerError, ConnectionError) as e:
                failures[i] = (getattr(e, "code", type(e).__name__), len(stamps[i]), str(e))

    tasks, k = [], 0
    for wave in waves:
        ids = list(range(k, k + len(wave)))
        tasks += [asyncio.create_task(one(i, p, m, t)) for i, (p, m, t) in zip(ids, wave)]
        k += len(wave)
        while not all(dones[i] is not None or i in failures
                      or len(stamps[i]) >= tokens_before_next for i in ids):
            await asyncio.sleep(0.002)
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t0
    ttft = [s[0] - submit_t[i] for i, s in enumerate(stamps) if s]
    itl = [b - a for s in stamps for a, b in zip(s, s[1:])]
    return dones, failures, {"wall": wall, "ttft": ttft, "itl": itl,
                             "tokens": sum(len(s) for s in stamps)}


def _client_line(tag, card, m) -> str:
    return (f"  {tag} ({card}): {m['tokens']} tokens in {m['wall']:.3f} s: "
            f"{m['tokens'] / m['wall']:.1f} generated tokens/s (client-observed); TTFT p50 "
            f"{_pct(m['ttft'], 50) * 1e3:.3f} ms, p99 {_pct(m['ttft'], 99) * 1e3:.3f} ms; "
            f"inter-token p50 {_pct(m['itl'], 50) * 1e3:.3f} ms, p99 "
            f"{_pct(m['itl'], 99) * 1e3:.3f} ms")


def _busy(engine) -> float:
    """1 - ``serving_device_idle_ratio``: the share of the engine's tick
    span not spent in the measured gaps between ticks (the host-gap
    tracker's view; a profiler also sees the idle inside a tick)."""
    ratio = engine.metrics.summary().get("device_idle_ratio", float("nan"))
    return 1.0 - ratio


def fleet_phase(served, slots=8, chunk=128, top_k=50, pool_mb=256, long_len=496,
                disagg_new=16, tier_blocks=64, tier_host_mb=64, tier_new=32,
                load_new=24, cli_new=8) -> dict:
    """16: the fleet on gpt_small at full width (phase 14's model, weights
    and requests; 15a's rows are the greedy reference); returns the launch
    counts of our kernels (none expected)."""
    import asyncio
    import signal
    import tempfile

    import numpy as np
    import torch

    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch import run as cli
    from distkeras_tpu_torch.checkpoint import publish_weights, read_manifest
    from distkeras_tpu_torch.deploy import PublishPolicy, WeightPublisher
    from distkeras_tpu_torch.deploy.harness import wire_controller
    from distkeras_tpu_torch.serving import (
        LocalReplica,
        ServingClient,
        ServingCluster,
        ServingEngine,
    )
    from distkeras_tpu_torch.serving import kv_transfer as kvt
    from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
    from distkeras_tpu_torch.telemetry.registry import MetricsRegistry
    from distkeras_tpu_torch.telemetry.request_trace import TraceStore
    from distkeras_tpu_torch.utils.bridge import params_to_jax

    card = card_line()
    model, variables = served["model"], served["variables"]
    prompts, temps, new = served["prompts"], served["temps"], served["new"]
    waves, per_wave, outs_a = served["waves"], served["per_wave"], served["outs_paged"]
    cfg = model.config
    n = len(prompts)
    greedy_ids = [i for i in range(n) if temps[i] <= 0]
    base = dict(slots=slots, max_queue=64, paged=True, kv_block_tokens=16,
                prefill_chunk=chunk, top_k=top_k, seed=SEED)
    sup = dict(health_interval_s=0.25, health_timeout_s=10.0, fail_after=3,
               base_delay_s=0.1, max_delay_s=2.0, stable_after_s=1.0)
    root = os.path.join(CKPT_ROOT, "fleet")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    log(f"gpt_small fleet: replicas of the paged engine {base}, kv_pool_mb {pool_mb}")
    t_phase = time.perf_counter()
    reset_counts()

    def factory(engines, auditors=None, weights=None):
        def make(i):
            def build():
                aud = None
                if auditors is not None:
                    aud = auditors[i] = RecompileAuditor()
                eng = ServingEngine(model, weights or variables, kv_pool_mb=pool_mb,
                                    auditor=aud, arm_auditor_after_warmup=aud is not None,
                                    trace_store=TraceStore(512), **base)
                engines[i] = eng
                return eng

            return LocalReplica(build)

        return make

    waves_in = [[(prompts[i], new, temps[i]) for i in range(w * per_wave, (w + 1) * per_wave)]
                for w in range(waves)]
    vars1 = model.init(SEED + 1)
    pub_dir = os.path.join(root, "publish")
    boot = publish_weights(pub_dir, params_to_jax(vars1, model.module), meta={"phase": "16d"})

    async def fleet():
        engines, auditors = {}, {}
        cluster = ServingCluster(factory(engines, auditors), 2, supervisor_kwargs=sup,
                                 registry=MetricsRegistry(),
                                 router_kwargs={"affinity_tokens": 16})
        out = {}
        async with cluster:
            # 16a: phase 14a's waves through the router.
            dones, failures, m = await _client_waves(cluster.port, waves_in)
            check(not failures, f"16a: client errors {failures}")
            out["a"] = (dones, m, {i: _busy(e) for i, e in engines.items()},
                        {i: e.decode_compile_count() for i, e in engines.items()},
                        {i: a.report()["serving_decode"]["armed"] for i, a in auditors.items()})
            async with ServingClient("127.0.0.1", cluster.port, wire_mode="bin1") as c:
                traced = await c.generate(prompts[greedy_ids[0]], 8, trace_id="phase16a-trace")
                out["trace"] = await c.tracez("phase16a-trace")
                out["health_a"] = await c.healthz()
            log(f"  16a: {time.perf_counter() - t_phase:.2f} s into the phase")

            # 16d: kill r0 mid-wave, then roll seed-1 weights under load.
            load = [(prompts[i], load_new, 0.0) for i in greedy_ids]
            task = asyncio.create_task(_client_waves(cluster.port, [load], tokens_before_next=1))
            await asyncio.sleep(0.05)
            while not any(e.active_slots for e in engines.values()):
                await asyncio.sleep(0.005)
            await asyncio.sleep(0.3)
            t_kill = time.perf_counter()
            await cluster.replicas["r0"].handle.kill()
            dones_d, failures_d, m_d = await task
            deadline = time.monotonic() + 120
            while cluster.replicas["r0"].restarts < 1 or cluster.supervisor.ready_count < 2:
                check(time.monotonic() < deadline, "16d: r0 was not restarted")
                await asyncio.sleep(0.05)
            out["d_kill"] = (dones_d, failures_d, m_d, time.perf_counter() - t_kill,
                             cluster.replicas["r0"].restarts)
            completions, errors = [], []
            stop = asyncio.Event()

            async def worker(k):
                async with ServingClient("127.0.0.1", cluster.port, wire_mode="bin1") as c:
                    j = k
                    while not stop.is_set():
                        p = prompts[greedy_ids[j % len(greedy_ids)]]
                        j += 3
                        try:
                            done = await c.generate(p, 8)
                            completions.append((time.perf_counter(), done["weight_version"]))
                        except Exception as e:
                            errors.append(repr(e))
                            return

            workers = [asyncio.create_task(worker(k)) for k in range(3)]
            while len(completions) < 3 and not errors:
                await asyncio.sleep(0.01)
            t0 = time.perf_counter()
            async with ServingClient("127.0.0.1", cluster.port) as c:
                rep = await c.reload(boot["path"], timeout=120.0)
            t1 = time.perf_counter()
            n_after = len(completions) + 6
            while len(completions) < n_after and not errors:
                await asyncio.sleep(0.01)
            stop.set()
            await asyncio.gather(*workers)
            out["d_reload"] = (rep, completions, errors, t0, t1)
            log(f"  16d: {time.perf_counter() - t_phase:.2f} s into the phase")

            # 16e: the deploy controller over the same fleet.
            ctrl = wire_controller(cluster.router, pub_dir, model=model,
                                   vocab=cfg.vocab_size, golden_count=2, golden_len=16,
                                   golden_new_tokens=8, seed=SEED,
                                   registry=cluster.router.registry,
                                   initial_weights=boot["path"])
            publisher = WeightPublisher(pub_dir, PublishPolicy(every_steps=1))
            vars2 = model.init(SEED + 2)
            await asyncio.to_thread(publisher.publish, params_to_jax(vars2, model.module),
                                    step=2, loss=1.0)
            t0 = time.perf_counter()
            good = await ctrl.poll_once()
            deploy_s = time.perf_counter() - t0
            nan_vars = {k: v * float("nan") if v.is_floating_point() else v
                        for k, v in model.init(SEED + 3).items()}
            await asyncio.to_thread(publisher.publish, params_to_jax(nan_vars, model.module),
                                    step=3, loss=float("nan"))
            t0 = time.perf_counter()
            bad = await ctrl.poll_once()
            reject_s = time.perf_counter() - t0
            async with ServingClient("127.0.0.1", cluster.port) as c:
                after = await c.generate(prompts[greedy_ids[0]], 8)
                health_e = await c.healthz()
                dz = await c.deployz()
            out["e"] = (good, deploy_s, bad, reject_s, after, health_e, dz)
            del vars2, nan_vars
        return out

    t_fleet = time.perf_counter()
    res = asyncio.run(fleet())
    log(f"  16a+16d+16e fleet wall {time.perf_counter() - t_fleet:.2f} s")

    # 16a's checks.
    dones, m, busy, compiles, armed = res["a"]
    log(_client_line("16a", card, m))
    log(f"  16a: replica busy share (1 - serving_device_idle_ratio) "
        f"{ {f'r{i}': round(b, 4) for i, b in busy.items()} }; decode signatures {compiles}")
    got = [d["tokens"] for d in dones]
    check(all(len(g) == new for g in got), "16a: a request ended short")
    check(all(c == 1 for c in compiles.values()) and all(armed.values()),
          f"16a: decode signatures {compiles}, armed {armed}")
    _greedy_check("16a fleet vs 15a", model, variables, [prompts[i] for i in greedy_ids],
                  [got[i] for i in greedy_ids], [outs_a[i] for i in greedy_ids])
    h = res["health_a"]["router"]
    log(f"  16a healthz rollup: replicas_ready {h['replicas_ready']}, outstanding "
        f"{h['outstanding_total']}, weight_versions {h['weight_versions']}, "
        f"kv_migrations {h.get('kv_migrations')}")
    check(h["replicas_ready"] == 2 and h["mixed_weight_versions"] is False,
          f"16a: fleet healthz {h}")
    trace = res["trace"]
    hops = trace.get("engine_hops") or []
    log(f"  16a tracez: router record {bool(trace.get('router'))}, engine hops "
        f"{[hp.get('source') for hp in hops]}, events "
        f"{[e[2] if len(e) > 2 else e for e in trace.get('events', [])][:8]}")
    check(trace.get("router") is not None and hops
          and all(hp["trace_id"] == "phase16a-trace" for hp in hops),
          f"16a: tracez does not show the router and replica hops: {trace}")

    # 16d's checks.
    dones_d, failures_d, m_d, rejoin_s, restarts = res["d_kill"]
    log(f"  16d kill ({card}): {sum(d is not None for d in dones_d)} of {len(dones_d)} "
        f"requests completed, {len(failures_d)} ended typed "
        f"{[(code, k) for code, k, _ in failures_d.values()]}; r0 restarted {restarts} "
        f"time(s), fleet ready again {rejoin_s:.2f} s after the kill")
    for i, (code, streamed, msg) in failures_d.items():
        check(streamed >= 1, f"16d: request {i} failed with zero tokens streamed: {msg}")
        check(code in ("replica_lost", "error"), f"16d: request {i} ended {code}: {msg}")
    ok_d = [i for i, d in enumerate(dones_d) if d is not None]
    _greedy_check("16d survivors vs 15a", model, variables,
                  [prompts[greedy_ids[i]] for i in ok_d],
                  [dones_d[i]["tokens"] for i in ok_d],
                  [outs_a[greedy_ids[i]][:load_new] for i in ok_d])
    rep, completions, errors, t0, t1 = res["d_reload"]
    new_v = boot["version"]
    during = [c for c in completions if t0 <= c[0] <= t1]
    late = [wv for t, wv in completions if t > t1]
    log(f"  16d reload ({card}): rolled in {t1 - t0:.3f} s, reloaded {rep.get('reloaded')}, "
        f"failed {rep.get('failed')}; {len(completions)} completions ({len(during)} during "
        f"the roll), {len(errors)} client errors; later versions "
        f"{sorted({wv['version'] for wv in late})}")
    check(rep.get("ok") and not rep.get("failed"), f"16d: reload {rep}")
    check(not errors, f"16d: client errors under the reload {errors}")
    check(late and all(wv["version"] == new_v and wv["digest"] == boot["digest"]
                       for wv in late), f"16d: a later done line is not v{new_v}")

    # 16e's checks.
    good, deploy_s, bad, reject_s, after, health_e, dz = res["e"]
    log(f"  16e deploy ({card}): seed-2 publish {good['status']} in {deploy_s:.3f} s "
        f"(manifest seen to fleet verified); NaN publish {bad['status']} in "
        f"{reject_s:.3f} s ({bad.get('reason')}); fleet serves v"
        f"{after['weight_version']['version']}; counters {dz['counters']}; quarantined "
        f"{[q['version'] for q in dz['quarantined']]}")
    check(good["status"] == "deployed", f"16e: good publish {good}")
    check(bad["status"] == "canary_rejected" and "not finite" in bad.get("reason", ""),
          f"16e: NaN publish {bad}")
    check(after["weight_version"]["version"] == good["version"]
          and health_e["router"]["mixed_weight_versions"] is False,
          f"16e: the fleet left last-good: {after['weight_version']}")
    check([q["version"] for q in dz["quarantined"]] == [bad["version"]],
          f"16e: quarantine {dz['quarantined']}")
    log(f"  16e: {time.perf_counter() - t_phase:.2f} s into the phase")
    torch.cuda.empty_cache()

    # 16b: disaggregated prefill/decode, 14a's 16 greedy requests and one
    # prompt of long_len tokens whose KVX1 payload passes the frame cap.
    rng = np.random.default_rng(SEED + 16)
    long_prompt = rng.integers(0, cfg.vocab_size, size=long_len).tolist()
    bt = base["kv_block_tokens"]
    per_token = 2 * cfg.num_layers * cfg.num_heads * (cfg.hidden_size // cfg.num_heads) * 2
    log(f"  16b: one {long_len}-token prompt: {long_len // bt} blocks of "
        f"{per_token * bt} bytes, {long_len // bt * per_token * bt / 2**20:.2f} MiB of KV "
        f"against the {kvt.MAX_TRANSFER_BYTES / 2**20:.2f} MiB frame cap")

    async def disagg():
        engines = {}
        registry = MetricsRegistry()
        cluster = ServingCluster(factory(engines), 2, roles=["prefill", "decode"],
                                 registry=registry, supervisor_kwargs=sup,
                                 router_kwargs={"affinity_tokens": 16,
                                                "min_handoff_tokens": bt})
        async with cluster:
            dones, failures, m = await _client_waves(
                cluster.port, [[(prompts[i], new, 0.0) for i in greedy_ids]])
            async with ServingClient("127.0.0.1", cluster.port, wire_mode="bin1") as c:
                long_done = await c.generate(long_prompt, disagg_new)
                health = await c.healthz()
            pre, dec = engines[0], engines[1]
            first = await _kv_export(pre, long_prompt)
            imp = await _kv_import(dec, first["payload"])
            again = await _kv_export(dec, long_prompt)
            frames = kvt.split_frames(first["payload"])
            return (dones, failures, m, long_done, health, first, imp, again, frames,
                    registry.snapshot(), pre.metrics.kv_exports, dec.metrics.kv_migrations)

    (dones_b, failures_b, m_b, long_done, health_b, first, imp, again, frames, snap_b,
     exports, migrations) = asyncio.run(disagg())
    log(_client_line("16b", card, m_b))
    kms = [d.get("kv_migration") or {} for d in dones_b] + [long_done.get("kv_migration") or {}]
    lk = long_done["kv_migration"]
    log(f"  16b ({card}): migrations {migrations} on the decode replica, {exports} exports on "
        f"the prefill replica; per request bytes {[km.get('bytes') for km in kms]}; the "
        f"{long_len}-token prompt: {lk.get('bytes')} bytes in {len(frames)} KVBLK frames, "
        f"{lk.get('latency_s', float('nan')) * 1e3:.3f} ms pull+adopt, "
        f"{lk.get('bytes', 0) / 2**20 / max(lk.get('latency_s', 1e-9), 1e-9):.1f} MiB/s; "
        f"migration ms p50 {_pct([km['latency_s'] for km in kms if 'latency_s' in km], 50) * 1e3:.3f}")
    check(not failures_b, f"16b: client errors {failures_b}")
    check(all(km.get("bytes", 0) > 0 and "fallback" not in km for km in kms),
          f"16b: a done line without a migration: {kms}")
    check(len(frames) == 2 and lk["bytes"] > kvt.MAX_TRANSFER_BYTES,
          f"16b: the long prompt crossed in {len(frames)} frames, {lk.get('bytes')} bytes")
    check(snap_b["router_kv_handoff_fallbacks_total"]["value"] == 0, "16b: handoff fallbacks")
    _greedy_check("16b disaggregated vs 15a", model, variables,
                  [prompts[i] for i in greedy_ids], [d["tokens"] for d in dones_b],
                  [outs_a[i] for i in greedy_ids])
    want_long = dk.generate(model, variables, np.asarray([long_prompt], np.int32),
                            disagg_new, greedy=True)[0].tolist()
    _greedy_check("16b long prompt vs generate()", model, variables, [long_prompt],
                  [long_done["tokens"]], [want_long])
    log(f"  16b: export -> import ({imp.get('adopted_blocks')} adopted, "
        f"{imp.get('resident_blocks')} resident) -> re-export: "
        f"{len(first['payload'])} and {len(again['payload'])} bytes, bitwise "
        f"{first['payload'] == again['payload']}")
    check(first["payload"] == again["payload"], "16b: re-export differs from the export")
    check(health_b["router"].get("roles") == {"prefill": 1, "decode": 1},
          f"16b: roles {health_b['router'].get('roles')}")
    log(f"  16b: {time.perf_counter() - t_phase:.2f} s into the phase")
    torch.cuda.empty_cache()

    # 16c: a 64-block pool over host and disk tiers; the shared-prefix
    # requests twice.
    shared = [i for i in range(n) if prompts[i][:128] == prompts[0][:128]] or greedy_ids[:8]
    disk = tempfile.mkdtemp(prefix="kvtier-", dir=root)
    tiered = ServingEngine(model, variables, kv_pool_blocks=tier_blocks,
                           kv_host_tier_mb=tier_host_mb, kv_disk_tier_dir=disk,
                           kv_disk_tier_mb=tier_host_mb, **base)

    others = [i for i in greedy_ids if i not in shared]

    async def rounds():
        # Round 1, then the other greedy requests (whose admissions evict
        # round 1's adopted chains into the tiers), then round 2.
        task = asyncio.create_task(tiered.run())
        try:
            out = []
            for ids in (shared, others, shared):
                reqs = [tiered.submit(prompts[i], tier_new) for i in ids]
                out.append([await q.result() for q in reqs])
                out.append(reqs)
            return out
        finally:
            tiered.shutdown(drain=True)
            await task

    t0 = time.perf_counter()
    r1, reqs1, _, _, r2, reqs2 = asyncio.run(rounds())
    tier_s = time.perf_counter() - t0
    mt = tiered.metrics
    snap = mt.registry.snapshot()
    readmit_h = snap.get("kv_tier_readmit_seconds") or {}
    readmit_block_ms = (1e3 * readmit_h.get("sum", float("nan")) / max(mt.kv_readmits, 1))
    pre_s = sum(q.prefill_device_s or 0.0 for q in reqs1)
    pre_tokens = sum(len(q.prompt) - (q.prefix_hit_tokens or 0) for q in reqs1)
    reprefill_block_ms = 1e3 * pre_s / max(pre_tokens, 1) * bt
    log(f"  16c ({card}): {len(shared)} shared-prefix requests twice, {len(others)} others "
        f"between, through {tier_blocks} blocks in {tier_s:.3f} s; spills {mt.kv_spills} ({mt.kv_spill_bytes} bytes), "
        f"readmits {mt.kv_readmits} ({mt.kv_readmit_bytes} bytes), preemptions "
        f"{mt.preemptions}; tier {tiered.kv_tier.stats()}")
    log(f"  16c ({card}): readmit {readmit_block_ms:.3f} ms a block (host tier to pool, "
        f"kv_tier_readmit_seconds) against re-prefill {reprefill_block_ms:.3f} ms a block "
        f"(round 1's prefill device seconds over its computed tokens, x {bt}); round 2 prefix "
        f"hit tokens {sum(q.prefix_hit_tokens or 0 for q in reqs2)} vs round 1 "
        f"{sum(q.prefix_hit_tokens or 0 for q in reqs1)}")
    check(mt.kv_spills > 0 and mt.kv_readmits > 0,
          f"16c: spills {mt.kv_spills}, readmits {mt.kv_readmits}")
    _greedy_check("16c round 2 vs round 1", model, variables, [prompts[i] for i in shared],
                  r2, r1)
    del tiered
    shutil.rmtree(disk, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  16c: {time.perf_counter() - t_phase:.2f} s into the phase")

    # 16f: the command line, as a child on the card.
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distkeras_tpu_torch.run", "cluster", "--model", "gpt_small",
         "--replicas", "2", "--paged", "--kv-pool-mb", str(pool_mb), "--kv-block-tokens",
         str(bt), "--prefill-chunk", str(chunk), "--slots", str(slots), "--port", "0",
         "--slo-ms", "60000", "--flight-dir", os.path.join(root, "flight")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True, start_new_session=True)
    try:
        banner = json.loads(proc.stdout.readline())
        up_s = time.perf_counter() - t0
        port = banner["port"]

        async def cli_stream():
            async with ServingClient("127.0.0.1", port) as c:
                done = await c.generate(prompts[greedy_ids[0]], cli_new)
                health = await c.healthz()
                slo = await c._control({"cmd": "sloz"})
            return done, health, slo

        done_f, health_f, slo = asyncio.run(cli_stream())
        import contextlib
        import io

        page = io.StringIO()
        with contextlib.redirect_stdout(page):
            rc_dz = cli.main(["debugz", "--port", str(port)])
        proc.send_signal(signal.SIGINT)
        tail, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    mem = [row for rep_ in health_f["replicas"].values()
           for row in (rep_.get("healthz") or {}).get("device_memory", [])]
    objectives = (slo.get("sloz") or {}).get("objectives") or []
    log(f"  16f ({card}): `run cluster` up in {up_s:.2f} s ({banner['replicas']}); one "
        f"stream of {len(done_f['tokens'])} tokens; debugz rc {rc_dz}, "
        f"{len(page.getvalue().splitlines())} lines; sloz objectives "
        f"{[o.get('objective') for o in objectives]}; device memory rows "
        f"{[(r['device'], r['bytes_in_use']) for r in mem]}; SIGINT exit {proc.returncode}")
    check(len(done_f["tokens"]) == cli_new, "16f: the stream ended short")
    _greedy_check("16f cli vs 15a", model, variables, [prompts[greedy_ids[0]]],
                  [done_f["tokens"]], [outs_a[greedy_ids[0]][:cli_new]])
    check(rc_dz == 0 and "replica r0" in page.getvalue() and "replica r1" in page.getvalue(),
          f"16f: debugz page {page.getvalue()[:400]}")
    check(objectives, f"16f: sloz lists no objective: {slo}")
    check(mem and all(r["device"] == "cuda:0" and r["available"] and r["bytes_in_use"] > 0
                      for r in mem), f"16f: memory rows {mem}")
    check(proc.returncode == 0 and "restarts" in tail, f"16f: SIGINT exit {proc.returncode}")
    shutil.rmtree(root, ignore_errors=True)
    counts = read_counts()
    check(counts == expected(), f"16: our kernels launched on the fleet path: {counts}")
    log(f"  16: phase wall {time.perf_counter() - t_phase:.2f} s ({card})")
    return counts


async def _kv_export(engine, prompt) -> dict:
    ev, res = engine.request_kv_export(prompt)
    await ev.wait()
    check("error" not in res and res.get("payload"), f"16b: export {res}")
    return res


async def _kv_import(engine, payload) -> dict:
    ev, res = engine.request_kv_import(payload)
    await ev.wait()
    check("error" not in res, f"16b: import {res}")
    return res


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
    t0 = time.perf_counter()
    log("phase 12: gpt_small generation (generate, sampling, beam_search) at full width")
    runs.append(generation_phase())
    log("phase 13: real-data acceptance on the digits set (SingleTrainer, ADAG, AEASGD)")
    runs.append(digits_phase())
    log(f"phases 12-13: {time.perf_counter() - t0:.2f} s")
    log("phase 14: gpt_small ServingEngine and ServingServer at full width")
    counts, served = serving_phase()
    runs.append(counts)
    log("phase 15: gpt_small paged serving (pool, preemption, request kinds, constrained and "
        "speculative decoding, reload) at full width")
    runs.append(paged_phase(served))
    log("phase 16: the gpt_small fleet (router, replicas, disaggregated prefill/decode, KV "
        "tiers, faults and rolling reload, deploy, the command line) at full width")
    runs.append(fleet_phase(served))
    del served
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

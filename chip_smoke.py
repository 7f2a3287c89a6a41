#!/usr/bin/env python3
"""Drive the PyTorch port (distkeras_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. Build the hand-written kernels from the sources in this checkout (nvcc
   for the CUDA C++ flash-attention forward, Triton's JIT for the fused
   cross-entropy forward) and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time kernel, plain version and the
   one PyTorch call that computes the same function (scaled_dot_product_attention,
   cross_entropy), with the bound the card's published rates put on it.
3. The slice at full width: bert_base_mlm (seq 128, flash attention on,
   random weights from a seed) through ModelPredictor (64 rows, batch 32)
   and Trainer.evaluate with fused_categorical_crossentropy (512 rows,
   batch 32), counting kernel launches in each run; one 4-row batch's
   logits and loss compared with the same weights run on the CPU; a
   torch.profiler table of device time by kernel over 4 eval batches.
4. The same for gpt_small (seq 512, causal): ModelPredictor on 8 rows,
   Trainer.evaluate on 2 batches of 8.
5. Print the kernels line, the card's name and power limit, and last the
   result line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
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


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 2: kernels against their plain versions ---------------------------


def flash_case(B, S, H, D, causal, shift, gen):
    import torch
    import torch.nn.functional as F

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
    library_ms = None
    if shift == 0:  # SDPA has no strict-causal form of the same function
        q4, k4, v4 = (x.view(B, H, S, D) for x in (q, k, v))
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal), 50)
    pairs = S * S if not causal else (S * (S + 1) // 2 if shift == 0 else S * (S - 1) // 2)
    nbytes = 4 * BH * S * D * 2 + BH * S * 4
    bound, by = bound_ms(nbytes, 4.0 * BH * pairs * D, BF16_TENSOR_FLOPS)
    case = {"shape": f"B={B} S={S} H={H} D={D} causal={causal} shift={shift} bf16",
            "max_abs_err": err, "lse_max_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}
    log(f"  K1 {case['shape']}: err {err:.3g} lse_err {lse_err:.3g} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {library_ms} ms "
        f"bound {bound:.4f} ms ({by})")
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


# -- phases 3 and 4: the slice at full width ----------------------------------


def reset_counts():
    from distkeras_tpu_torch.ops.flash_attention import flash_forward
    from distkeras_tpu_torch.ops.fused_xent import xent_forward

    flash_forward.launches = 0
    xent_forward.launches = 0


def read_counts() -> dict:
    from distkeras_tpu_torch.ops.flash_attention import flash_forward
    from distkeras_tpu_torch.ops.fused_xent import xent_forward

    return {"flash_attention_fwd": flash_forward.launches,
            "fused_xent_fwd": xent_forward.launches}


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
    check(pred_counts == {"flash_attention_fwd": cfg.num_layers * n_pred_batches,
                          "fused_xent_fwd": 0}, f"predict launches {pred_counts}")
    log(f"  predict {pred_rows} rows at batch {batch}: {pred_s:.3f} s "
        f"(host copy of the logits included), launches {pred_counts}")

    reset_counts()
    t0 = time.perf_counter()
    metrics = trainer.evaluate(trained, data.take(eval_rows), batch_size=batch)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = read_counts()
    n_eval_batches = -(-eval_rows // batch)
    check(eval_counts == {"flash_attention_fwd": cfg.num_layers * n_eval_batches,
                          "fused_xent_fwd": n_eval_batches}, f"evaluate launches {eval_counts}")
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

    profile_eval(trainer, trained, data.take(4 * batch), batch)
    return {k: pred_counts[k] + eval_counts[k] for k in pred_counts}


def profile_eval(trainer, trained, data, batch):
    """Device time by kernel, and the device's busy share, over the eval
    batches of ``data`` (torch.profiler with CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.evaluate(trained, data, batch_size=batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    log(f"  profile: {-(-data.num_rows // batch)} eval batches, wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%})")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "distkeras_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from distkeras_tpu_torch.ops.flash_attention import flash_forward
    from distkeras_tpu_torch.utils.build import build_all

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = build_all()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(1, 64, 64, device="cuda", generator=gen).bfloat16()
    flash_forward(q, q, q)
    from distkeras_tpu_torch.ops.fused_xent import xent_forward

    for dt in (torch.float32, torch.bfloat16):
        xent_forward(torch.zeros(2, 8, device="cuda", dtype=dt),
                     torch.zeros(2, dtype=torch.long, device="cuda"))
    torch.cuda.synchronize()
    log(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 2: kernels against their plain versions on the card")
    k1 = [flash_case(32, 128, 12, 64, False, 0, gen),
          flash_case(8, 512, 12, 64, True, 0, gen),
          flash_case(8, 512, 12, 64, True, 1, gen)]
    k4 = [xent_case(4096, 30522, torch.float32, gen),
          xent_case(4096, 30522, torch.bfloat16, gen),
          xent_case(4096, 50257, torch.float32, gen)]

    log("phase 3: bert_base_mlm at full width")
    launches = run_model("bert_base_mlm", 128, 64, 512, 32, 4)
    log("phase 4: gpt_small at full width")
    gpt = run_model("gpt_small", 512, 8, 16, 8, 1)
    launches = {k: launches[k] + gpt[k] for k in launches}
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")

    kernels = []
    for name, route, source, replaces, cases in (
        ("flash_attention_fwd", "cuda", "distkeras_tpu_torch/csrc/flash_attention_fwd.cu",
         "distkeras_tpu/ops/pallas/flash_attention.py:189", k1),
        ("fused_xent_fwd", "triton", "distkeras_tpu_torch/ops/fused_xent.py",
         "distkeras_tpu/ops/pallas/fused_xent.py:107", k4),
    ):
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

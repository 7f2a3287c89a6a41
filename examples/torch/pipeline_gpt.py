"""Pipeline-parallel GPT training and KV-cache generation on the PyTorch port.

A 4-layer causal LM trains with its trunk pipelined over a ``pp`` axis of
a ``torch.distributed`` group (optionally interleaved: 2 virtual chunks per
rank; ``--schedule 1f1b`` for the hand-rolled one-forward-one-backward
schedule), then the trained weights drive greedy and beam-search generation
through the KV-cache decoder.

Run N stages: torchrun --nproc-per-node N examples/torch/pipeline_gpt.py
(without torchrun it runs a pipe of one stage; ``--device cpu`` uses gloo).
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
if os.path.isdir(os.path.join(ROOT, "distkeras_tpu_torch")):
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--virtual-stages", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--schedule", choices=["gpipe", "1f1b"], default="gpipe",
                    help="1f1b: near-flat activation residency in the microbatch count "
                         "(needs --virtual-stages 1)")
    ap.add_argument("--moe-experts", type=int, default=0,
                    help="replace the MLP with a routed MoE of this many experts")
    ap.add_argument("--ep", type=int, default=1,
                    help="shard the experts over an ep axis (dp x pp x ep)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.schedule == "1f1b" and args.virtual_stages != 1:
        print("note: 1f1b is non-interleaved; forcing --virtual-stages 1")
        args.virtual_stages = 1
    if args.ep > 1 and not args.moe_experts:
        ap.error("--ep needs --moe-experts (a dense MLP has no expert weights to shard)")

    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models.bert import BertConfig, _make
    from distkeras_tpu_torch.parallel import distributed
    from distkeras_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(backend="gloo" if args.device == "cpu" else None)
    world, rank = distributed.process_count(), distributed.process_index()
    pp = world // args.ep
    mesh = make_mesh({"pp": pp, **({"ep": args.ep} if args.ep > 1 else {})})

    vocab, seq = 64, 32
    cfg = BertConfig(vocab_size=vocab, hidden_size=64, num_layers=4, num_heads=4, mlp_dim=128,
                     max_seq_len=seq, dropout_rate=0.0, causal=True,
                     moe_experts=args.moe_experts)
    model = _make(cfg, seq, "gpt_pipe")

    # Cyclic-sequence next-token task (the loss collapses if training works).
    base = np.arange(4096) % vocab
    windows = np.stack([base[i : i + seq] for i in range(args.rows)])
    features = windows.astype(np.int32)
    labels = np.roll(windows, -1, axis=1).astype(np.int32)
    ds = dk.Dataset.from_arrays(features=features, label=labels)

    trainer = dk.PipelineTrainer(
        model, worker_optimizer="adam", learning_rate=3e-3, mesh=mesh,
        virtual_stages=args.virtual_stages, num_microbatches=4, batch_size=args.batch_size,
        num_epoch=args.epochs, seed=0, schedule=args.schedule, device=args.device,
    )
    t0 = time.time()
    trained = trainer.train(ds, shuffle=True)
    hist = trainer.get_history()
    out = {"steps": len(hist), "first": float(hist[0]["loss"]), "last": float(hist[-1]["loss"])}
    if rank != 0:
        return out
    aux = (f" aux {hist[0]['aux_loss']:.3f} -> {hist[-1]['aux_loss']:.3f}"
           if "aux_loss" in hist[0] else "")
    moe = f" moe={args.moe_experts} ep={args.ep}" if args.moe_experts else ""
    print(f"pp={pp} V={args.virtual_stages} {args.schedule}{moe}: "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}{aux} "
          f"({len(hist)} steps, {time.time() - t0:.1f}s)")

    prompt = features[:1, :8]
    greedy = dk.generate(trained.model, trained.variables, prompt, 12, greedy=True,
                         device=args.device)
    seqs, scores = dk.beam_search(trained.model, trained.variables, prompt, 12, num_beams=4,
                                  device=args.device)
    expect = labels[0, 7:19]
    print("prompt:      ", prompt[0].tolist())
    print("greedy:      ", greedy[0].tolist())
    print("beam best:   ", seqs[0, 0].tolist(), f"(score {scores[0, 0]:.2f})")
    print("ground truth:", expect.tolist())
    acc = float(np.mean(greedy[0] == expect))
    print(f"greedy continuation accuracy vs cycle: {acc:.2f}")
    return {**out, "greedy_accuracy": acc}


if __name__ == "__main__":
    main()

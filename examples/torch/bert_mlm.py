"""BERT masked-LM on the PyTorch port (BASELINE config #5).

Two modes:

- ``--mode sync``: SynchronousDistributedTrainer on a dp x tp mesh over the
  ranks of a ``torch.distributed`` group (tensor parallelism shards heads,
  the MLP and the vocabulary over tp). Run N ranks with ``torchrun
  --nproc-per-node N examples/torch/bert_mlm.py``; without torchrun it runs
  at world size 1.
- ``--mode dynsgd``: the DynSGD asynchronous protocol with staleness-damped
  commits (worker threads, one in-process parameter server).

Masked-LM objective on synthetic token streams: 15% of tokens masked; the
label is the original token id (the loss is taken over all positions).

Run: python examples/torch/bert_mlm.py [--mode dynsgd] [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
if os.path.isdir(os.path.join(ROOT, "distkeras_tpu_torch")):
    sys.path.insert(0, ROOT)

import distkeras_tpu_torch as dk  # noqa: E402
from distkeras_tpu_torch.parallel import distributed  # noqa: E402
from distkeras_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

MASK_ID = 0


def make_mlm_data(n=2048, seq=64, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, size=(n, seq))
    mask = rng.random((n, seq)) < 0.15
    corrupted = np.where(mask, MASK_ID, tokens)
    return dk.Dataset.from_arrays(features=corrupted.astype(np.int32),
                                  label=tokens.astype(np.int32))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="sync", choices=["sync", "dynsgd"])
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ds = make_mlm_data(n=args.rows, seq=args.seq, vocab=args.vocab)
    model = dk.bert_tiny_mlm(seq_len=args.seq, vocab_size=args.vocab)
    common = dict(
        worker_optimizer="adam", learning_rate=1e-3,
        loss="categorical_crossentropy",
        batch_size=args.batch_size, num_epoch=args.epochs, device=args.device,
    )

    t0 = time.time()
    if args.mode == "sync":
        # A no-op without torchrun's environment; gloo for CPU ranks.
        distributed.initialize(backend="gloo" if args.device == "cpu" else None)
        ndev = distributed.process_count()
        tp = args.tp if ndev % args.tp == 0 else 1
        mesh = make_mesh({"dp": ndev // tp, "tp": tp})
        trainer = dk.SynchronousDistributedTrainer(model, mesh=mesh, **common)
    else:
        trainer = dk.DynSGD(model, num_workers=args.workers, communication_window=5, **common)
    trainer.train(ds)
    hist = trainer.get_history()
    if distributed.process_index() == 0:
        print(f"bert-mlm {args.mode}: steps={len(hist)} "
              f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
              f"wall={time.time() - t0:.1f}s")
    out = {"steps": len(hist), "first": float(hist[0]["loss"]),
           "last": float(hist[-1]["loss"])}
    if args.mode == "dynsgd":
        # The history holds each worker's steps in turn, so its first and last
        # rows are two workers' losses on other batches: report each
        # worker's own first and last step.
        losses = {}
        for row in hist:
            losses.setdefault(int(row["worker"]), []).append(float(row["loss"]))
        out["workers"] = {w: (l[0], l[-1]) for w, l in sorted(losses.items())}
    return out


if __name__ == "__main__":
    main()

"""MNIST workflow on the PyTorch port (the reference's ``examples/mnist.py``).

The canonical dist-keras user flow: load data, preprocess with
transformers, train with SingleTrainer or a distributed trainer, predict,
evaluate. Pass ``--npz path`` (arrays ``x`` [N,784] or [N,28,28], ``y``
[N]) to use the real MNIST; otherwise a synthetic stand-in with the same
shapes is generated.

Run: python examples/torch/mnist.py [--trainer adag] [--epochs 2] [--device cpu]
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


def load_mnist(npz: str | None = None, n=8192, seed=0):
    if npz:
        with np.load(npz) as d:
            x = d["x"].reshape(len(d["x"]), -1).astype(np.float32)
            y = d["y"].astype(np.float32)
        return dk.Dataset.from_arrays(features=x, label=y)
    # Synthetic MNIST-shaped data: 10 gaussian digit prototypes.
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 255, size=(10, 784))
    labels = rng.integers(0, 10, size=n)
    x = protos[labels] + rng.normal(0, 64, size=(n, 784))
    x = np.clip(x, 0, 255).astype(np.float32)
    return dk.Dataset.from_arrays(features=x, label=labels.astype(np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trainer", default="single",
                    choices=["single", "downpour", "adag", "aeasgd", "eamsgd",
                             "dynsgd", "sync", "averaging"])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--rows", type=int, default=8192, help="synthetic rows")
    ap.add_argument("--npz", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    raw = load_mnist(args.npz, n=args.rows)
    pipeline = [
        dk.MinMaxTransformer(new_min=0.0, new_max=1.0, min=0.0, max=255.0,
                             input_col="features", output_col="features_normalized"),
        dk.OneHotTransformer(10, input_col="label", output_col="label_encoded"),
    ]
    ds = raw
    for t in pipeline:
        ds = t.transform(ds)
    train, test = ds.split(0.9, seed=1)

    model = dk.mnist_mlp()
    common = dict(
        worker_optimizer="adam", learning_rate=0.003,
        loss="categorical_crossentropy",
        features_col="features_normalized", label_col="label_encoded",
        batch_size=args.batch_size, num_epoch=args.epochs, device=args.device,
    )
    if args.trainer == "single":
        trainer = dk.SingleTrainer(model, **common)
    elif args.trainer == "sync":
        trainer = dk.SynchronousDistributedTrainer(model, **common)
    elif args.trainer == "averaging":
        trainer = dk.AveragingTrainer(model, num_workers=args.workers, **common)
    else:
        cls = {"downpour": dk.DOWNPOUR, "adag": dk.ADAG, "aeasgd": dk.AEASGD,
               "eamsgd": dk.EAMSGD, "dynsgd": dk.DynSGD}[args.trainer]
        trainer = cls(model, num_workers=args.workers, **common)

    t0 = time.time()
    trained = trainer.train(train, shuffle=True)
    print(f"trainer={args.trainer} training_time={trainer.get_training_time():.2f}s "
          f"steps={len(trainer.get_history())}")

    predictor = dk.ModelPredictor(trained, features_col="features_normalized",
                                  device=args.device)
    test = predictor.predict(test)
    test = dk.LabelIndexTransformer(input_col="prediction").transform(test)
    acc = dk.AccuracyEvaluator(prediction_col="prediction_index",
                               label_col="label").evaluate(test)
    print(f"test_accuracy={acc:.4f} total_wall={time.time() - t0:.2f}s")
    avg = trainer.get_averaged_history()
    if avg:
        print("averaged_history:", {k: round(v, 4) for k, v in avg.items()})
    return {"accuracy": acc, "steps": len(trainer.get_history())}


if __name__ == "__main__":
    main()

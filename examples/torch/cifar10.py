"""CIFAR-10 CNN via ADAG on the PyTorch port (BASELINE config #2).

Asynchronous data-parallel training of the convolutional model with the
ADAG protocol (accumulated-gradient normalization). Synthetic CIFAR-shaped
data stands in when the real dataset is not on disk; pass ``--npz`` with
arrays ``x`` (N,32,32,3 uint8) and ``y`` (N,) to use real CIFAR-10.

Run: python examples/torch/cifar10.py [--workers 2] [--epochs 2] [--device cpu]
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


def load_cifar(npz: str | None, n=4096, seed=0):
    if npz:
        with np.load(npz) as d:
            x, y = d["x"], d["y"]
    else:
        rng = np.random.default_rng(seed)
        protos = rng.uniform(0, 255, size=(10, 32, 32, 3))
        y = rng.integers(0, 10, size=n)
        x = np.clip(protos[y] + rng.normal(0, 48, size=(n, 32, 32, 3)), 0, 255)
    return dk.Dataset.from_arrays(features=x.astype(np.float32), label=y.astype(np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--npz", default=None)
    ap.add_argument("--rows", type=int, default=4096, help="synthetic rows")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ds = load_cifar(args.npz, n=args.rows)
    ds = dk.MinMaxTransformer(min=0.0, max=255.0, input_col="features",
                              output_col="features_normalized").transform(ds)
    ds = dk.OneHotTransformer(10, input_col="label", output_col="label_encoded").transform(ds)
    train, test = ds.split(0.9, seed=1)

    trainer = dk.ADAG(
        dk.cifar10_cnn(), worker_optimizer="adam", learning_rate=1e-3,
        loss="categorical_crossentropy",
        num_workers=args.workers, batch_size=args.batch_size,
        num_epoch=args.epochs, communication_window=12,
        features_col="features_normalized", label_col="label_encoded", device=args.device,
    )
    t0 = time.time()
    trained = trainer.train(train, shuffle=True)
    out = dk.ModelPredictor(trained, features_col="features_normalized",
                            device=args.device).predict(test)
    out = dk.LabelIndexTransformer(input_col="prediction").transform(out)
    acc = dk.AccuracyEvaluator(prediction_col="prediction_index",
                               label_col="label").evaluate(out)
    commits = trainer.parameter_server.num_commits
    print(f"adag cifar10: accuracy={acc:.4f} wall={time.time() - t0:.1f}s commits={commits}")
    return {"accuracy": acc, "commits": commits}


if __name__ == "__main__":
    main()

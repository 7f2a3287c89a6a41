"""Real-data acceptance run on the PyTorch port: handwritten digits (the
UCI ODR digits set, 1797 real 8x8 grayscale images, bundled as
``tests/data/digits.csv.gz``: no network and no sklearn needed).

The reference's acceptance criterion was "distributed accuracy ~ the
single-node run on real data" (its ``examples/workflow.ipynb``). This runs
that workflow end to end:

    raw digits -> MinMaxTransformer -> train/test split
    -> SingleTrainer baseline vs async trainers -> accuracy comparison

Run: python examples/torch/real_data_digits.py [--trainers single,adag] [--device cpu]
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
from distkeras_tpu_torch.models.core import Model  # noqa: E402
from distkeras_tpu_torch.models.mlp import MLP  # noqa: E402

DIGITS = os.path.join(ROOT, "tests", "data", "digits.csv.gz")
ALL = "single,adag,downpour,dynsgd,aeasgd,eamsgd"


def load_digits_dataset(path=DIGITS):
    table = np.loadtxt(path, delimiter=",", dtype=np.float64)  # 64 pixels, then the label
    return dk.Dataset.from_arrays(features=table[:, :-1].astype(np.float32),
                                  label=table[:, -1].astype(np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--trainers", default=ALL)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ds = load_digits_dataset()
    # Reference workflow step 1: min-max scale the pixel range (0..16).
    ds = dk.MinMaxTransformer(min=0, max=16, output_col="features").transform(ds)
    ds = ds.shuffle(seed=0)
    n_test = 297
    train = ds.slice(0, len(ds) - n_test)
    test = ds.slice(len(ds) - n_test, len(ds))

    def model():
        return Model(lambda: MLP(64, (64, 64), 10), name="digits_mlp", input_shape=(64,),
                     output_dim=10)

    kwargs = dict(worker_optimizer="adam", learning_rate=1e-3, batch_size=32,
                  num_epoch=args.epochs, device=args.device)
    # The elastic family: alpha = rho * lr is the center's tracking rate, and
    # the returned model IS the center, so adam-scale lr needs rho ~ 50.
    elastic = dict(num_workers=args.workers, rho=50.0, communication_window=8)
    trainers = {
        "single": lambda: dk.SingleTrainer(model(), **kwargs),
        "adag": lambda: dk.ADAG(model(), num_workers=args.workers, **kwargs),
        "downpour": lambda: dk.DOWNPOUR(model(), num_workers=args.workers, **kwargs),
        "dynsgd": lambda: dk.DynSGD(model(), num_workers=args.workers, **kwargs),
        "aeasgd": lambda: dk.AEASGD(model(), **elastic, **kwargs),
        "eamsgd": lambda: dk.EAMSGD(model(), **elastic, **kwargs),
    }
    results = {}
    for name in args.trainers.split(","):
        t0 = time.time()
        trained = trainers[name]().train(train, shuffle=True)
        wall = time.time() - t0
        pred = dk.ModelPredictor(trained, device=args.device).predict(test)
        acc = dk.AccuracyEvaluator(prediction_col="prediction",
                                   label_col="label").evaluate(pred)
        results[name] = acc
        print(f"{name:10s} test_accuracy={acc:.4f} wall={wall:.1f}s")

    base = results.get("single")
    if base is not None:
        for name, acc in results.items():
            status = "OK" if abs(acc - base) < 0.05 else "DIVERGED"
            print(f"parity[{name}] = {acc - base:+.4f} {status}")
    return results


if __name__ == "__main__":
    main()

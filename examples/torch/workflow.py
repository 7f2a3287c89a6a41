"""ATLAS-Higgs-style workflow on the PyTorch port (the reference's
``examples/workflow.ipynb``).

Read the bundled sample CSV (``examples/data/higgs_sample.csv``: 28
features and a binary label; ``--csv`` names another file, ``--synthetic
N`` draws a surrogate of N rows instead), assemble features, normalize,
one-hot the label, then compare trainers (Single vs DOWNPOUR vs ADAG vs
AEASGD vs DynSGD ...) on accuracy and training time, finishing with
prediction and evaluation. ``--sparse`` carries the features as a CSR
``SparseColumn`` densified by ``DenseTransformer`` first, the reference's
path for SparseVector columns.

Run: python examples/torch/workflow.py [--trainers single,adag] [--device cpu]
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
from distkeras_tpu_torch.data import SparseColumn  # noqa: E402

FEATURES = 28
CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data", "higgs_sample.csv")


def load_higgs(csv: str | None, n: int = 16384, seed: int = 0) -> dk.Dataset:
    if csv:
        names = [f"f{i}" for i in range(FEATURES)]
        return dk.Dataset.from_csv(csv, features=names, label="label")
    rng = np.random.default_rng(seed)
    # two overlapping gaussian classes in a 28-d feature space
    w = rng.normal(size=(FEATURES,))
    x = rng.normal(size=(n, FEATURES)).astype(np.float32)
    margin = x @ w / np.sqrt(FEATURES) + 0.3 * rng.normal(size=n)
    y = (margin > 0).astype(np.float32)
    x = (x * rng.uniform(0.5, 50.0, size=FEATURES)).astype(np.float32)  # raw scales
    return dk.Dataset.from_arrays(features=x, label=y)


TRAINERS = {
    "single": lambda m, a, c: dk.SingleTrainer(m, **c),
    "downpour": lambda m, a, c: dk.DOWNPOUR(m, num_workers=a.workers, communication_window=8, **c),
    "adag": lambda m, a, c: dk.ADAG(m, num_workers=a.workers, communication_window=8, **c),
    "aeasgd": lambda m, a, c: dk.AEASGD(m, num_workers=a.workers, communication_window=8,
                                        rho=20.0, **c),
    "eamsgd": lambda m, a, c: dk.EAMSGD(m, num_workers=a.workers, communication_window=8,
                                        rho=20.0, momentum=0.8, **c),
    "dynsgd": lambda m, a, c: dk.DynSGD(m, num_workers=a.workers, communication_window=8, **c),
    "sync": lambda m, a, c: dk.SynchronousDistributedTrainer(m, **c),
    "averaging": lambda m, a, c: dk.AveragingTrainer(m, num_workers=a.workers, **c),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv", default=CSV)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="draw this many surrogate rows instead of reading --csv")
    ap.add_argument("--sparse", action="store_true",
                    help="carry the features as a SparseColumn, densified before training")
    ap.add_argument("--trainers", default="single,downpour,adag")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    raw = load_higgs(None if args.synthetic else args.csv, n=args.synthetic)
    if args.sparse:
        raw = raw.with_column("features", SparseColumn.from_dense(raw["features"]))
        raw = dk.DenseTransformer("features", "features").transform(raw)
    ds = dk.MinMaxTransformer(
        new_min=0.0, new_max=1.0, input_col="features",
        output_col="features_normalized",
    ).transform(raw)
    ds = dk.OneHotTransformer(2, input_col="label", output_col="label_encoded").transform(ds)
    train, test = ds.split(0.85, seed=1)

    common = dict(
        worker_optimizer="adam", learning_rate=0.003,
        loss="categorical_crossentropy",
        features_col="features_normalized", label_col="label_encoded",
        batch_size=args.batch_size, num_epoch=args.epochs, device=args.device,
    )
    results = {}
    for name in args.trainers.split(","):
        model = dk.higgs_mlp(input_dim=FEATURES)
        trainer = TRAINERS[name](model, args, common)
        t0 = time.time()
        trained = trainer.train(train, shuffle=True)
        wall = time.time() - t0
        predictor = dk.ModelPredictor(trained, features_col="features_normalized",
                                      device=args.device)
        out = predictor.predict(test)
        out = dk.LabelIndexTransformer(input_col="prediction").transform(out)
        acc = dk.AccuracyEvaluator(
            prediction_col="prediction_index", label_col="label"
        ).evaluate(out)
        results[name] = (acc, wall)
        print(f"{name:10s} accuracy={acc:.4f} wall={wall:.1f}s "
              f"train_time={trainer.get_training_time():.1f}s")

    best = max(results, key=lambda k: results[k][0])
    print(f"best: {best} ({results[best][0]:.4f})")
    return {name: acc for name, (acc, _) in results.items()}


if __name__ == "__main__":
    main()

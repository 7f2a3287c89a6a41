#!/usr/bin/env python3
"""Accuracy of the sample-CSV workflow over seeds, on the CPU, in either package.

    python3 scripts/higgs_seed_sweep.py port 0 20   # the PyTorch port, seeds 0-19
    python3 scripts/higgs_seed_sweep.py ref 0 20    # the JAX reference, seeds 0-19

The reference test's configuration (``tests/test_examples_data.py``):
``examples/data/higgs_sample.csv`` (600 x 28), ``MinMaxTransformer``,
``SingleTrainer(higgs_mlp())`` with adam at lr 0.01, batch 32, 15 epochs,
accuracy on the training rows. Prints one line per seed and the count of
runs at or below 0.78, the test's bar: one run's accuracy is chaotic at
this learning rate, which is why ``chip_smoke.py`` 24b holds the median
of five seeds to the bar.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CSV = os.path.join(REPO, "examples", "data", "higgs_sample.csv")
BAR = 0.78


def main(argv) -> int:
    if len(argv) != 3 or argv[0] not in ("port", "ref"):
        print(__doc__, file=sys.stderr)
        return 2
    pkg, lo, hi = argv[0], int(argv[1]), int(argv[2])
    kw = {}
    if pkg == "ref":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import distkeras_tpu as dk
        from distkeras_tpu.models import higgs_mlp
    else:
        import distkeras_tpu_torch as dk
        from distkeras_tpu_torch import higgs_mlp

        kw = {"device": "cpu"}
    names = [f"f{i}" for i in range(28)]
    ds = dk.Dataset.from_csv(CSV, features=names, label="label")
    ds = dk.MinMaxTransformer(input_col="features",
                              output_col="features_normalized").transform(ds)
    accs = []
    for seed in range(lo, hi):
        trainer = dk.SingleTrainer(higgs_mlp(), worker_optimizer="adam", learning_rate=0.01,
                                   features_col="features_normalized", label_col="label",
                                   batch_size=32, num_epoch=15, seed=seed, **kw)
        trained = trainer.train(ds, shuffle=True)
        out = dk.ModelPredictor(trained, features_col="features_normalized", **kw).predict(ds)
        out = dk.LabelIndexTransformer(input_col="prediction").transform(out)
        acc = dk.AccuracyEvaluator(prediction_col="prediction_index",
                                   label_col="label").evaluate(out)
        accs.append(acc)
        print(f"{pkg} seed {seed}: accuracy {acc:.4f}", flush=True)
    below = sum(a <= BAR for a in accs)
    print(f"{pkg}: {below} of {len(accs)} runs at or below {BAR}; "
          f"min {min(accs):.4f}, max {max(accs):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

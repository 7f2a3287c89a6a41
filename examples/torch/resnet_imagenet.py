"""ResNet via AEASGD on the PyTorch port (BASELINE config #4's shape).

Elastic-averaging training of ResNet-18 or ResNet-50 on ImageNet-shaped
synthetic data, at reduced image sizes by default so the script runs
anywhere. ``--transport grpc`` puts the parameter server behind gRPC
(``parallel/ps_grpc.py``), which needs ``grpcio`` and raises ImportError
naming it otherwise.

Run: python examples/torch/resnet_imagenet.py [--image-size 96] [--steps 20] [--device cpu]
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="resnet18", choices=["resnet18", "resnet50"])
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--transport", default="inprocess", choices=["inprocess", "grpc"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    n = args.steps * args.batch_size * args.workers
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, args.image_size, args.image_size, 3)).astype(np.float32)
    y = rng.integers(0, args.classes, size=n).astype(np.float32)
    ds = dk.Dataset.from_arrays(features=x, label=y)

    model = (dk.resnet18 if args.arch == "resnet18" else dk.resnet50)(
        num_classes=args.classes, image_size=args.image_size)
    trainer = dk.AEASGD(
        model, worker_optimizer="momentum", learning_rate=0.05,
        loss="categorical_crossentropy",
        num_workers=args.workers, batch_size=args.batch_size, num_epoch=1,
        communication_window=8, rho=2.0, transport=args.transport, device=args.device,
    )
    t0 = time.time()
    trainer.train(ds)
    hist = trainer.get_history()
    wall = time.time() - t0
    sps = len(hist) * args.batch_size / wall
    print(f"aeasgd {args.arch}: steps={len(hist)} "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"samples/sec={sps:.1f} wall={wall:.1f}s")
    return {"steps": len(hist), "commits": trainer.parameter_server.num_commits}


if __name__ == "__main__":
    main()

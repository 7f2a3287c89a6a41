"""Streaming inference on the PyTorch port (the reference's Kafka example:
a producer plus a streaming-inference notebook).

A producer thread streams framed micro-batches over TCP into a
:class:`~distkeras_tpu_torch.data.streaming.SocketSource`; swap it for
``KafkaSource`` against a real broker and nothing else changes.
``StreamingPredictor`` pads each micro-batch to one fixed batch and runs
the model on the device its weights live on.

Run: python examples/torch/streaming_inference.py [--batches 20] [--device cpu]
"""

import argparse
import os
import socket
import sys
import threading
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
if os.path.isdir(os.path.join(ROOT, "distkeras_tpu_torch")):
    sys.path.insert(0, ROOT)

import distkeras_tpu_torch as dk  # noqa: E402
from distkeras_tpu_torch.data.streaming import (  # noqa: E402
    SocketSource,
    StreamingPredictor,
    send_stream_batch,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--rows", type=int, default=2048, help="training rows")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # Train a small model first (stands in for loading a saved one).
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(args.rows, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=args.rows).astype(np.float32)
    ds = dk.Dataset.from_arrays(features=x, label=y)
    trained = dk.SingleTrainer(dk.mnist_mlp(), worker_optimizer="adam", batch_size=128,
                               num_epoch=1, device=args.device).train(ds)

    src = SocketSource(port=0)

    def tcp_producer():
        s = socket.create_connection((src.host, src.port))
        rng2 = np.random.default_rng(1)
        for _ in range(args.batches):
            send_stream_batch(
                s, rng2.uniform(0, 1, size=(args.batch_size, 784)).astype(np.float32))
            time.sleep(0.01)  # simulated arrival cadence
        send_stream_batch(s, None)
        s.close()

    t = threading.Thread(target=tcp_producer, daemon=True)
    t.start()

    def sink(x, preds):
        _ = preds.argmax(-1)  # the notebook's LabelIndex step

    stats = StreamingPredictor(trained, max_batch=args.batch_size).run(src, sink)
    t.join(timeout=30)
    print(f"streamed {stats['batches']} micro-batches ({stats['rows']} rows) "
          f"in {stats['wall_s']:.2f}s over TCP on {trained.device.type}; "
          f"{stats['rows_per_sec']:.0f} rows/s")
    return stats


if __name__ == "__main__":
    main()

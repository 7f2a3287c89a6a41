"""Streaming micro-batch sources and streaming inference.

Counterpart of ``distkeras_tpu/data/streaming.py``. The source is an
abstraction, so the same consumer loop runs against:

- :class:`QueueSource`     — an in-process ``queue.Queue`` (tests, demos);
- :class:`SocketSource`    — TCP length-prefixed npz frames (the pickle-free
  wire format of :mod:`distkeras_tpu_torch.utils.pytree`, byte for byte the
  reference's, so a producer of either package feeds a source of the other)
  from any producer process;
- :class:`GeneratorSource` — any Python iterable;
- :class:`KafkaSource`     — a Kafka consumer when ``kafka-python`` is
  installed (the import is gated; the rest of the module works without it).

:class:`StreamingPredictor` runs a trained model over the stream on the
device its weights live on: each micro-batch is padded to one fixed batch
(``max_batch`` rows), so every forward runs at one shape, and the
predictions go to a sink callback together with the input batch.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from collections.abc import Iterable, Iterator
from typing import Any, Callable

import numpy as np
import torch

from distkeras_tpu_torch.utils.device import resolve_device
from distkeras_tpu_torch.utils.pytree import deserialize_pytree, serialize_pytree

__all__ = [
    "StreamSource",
    "QueueSource",
    "SocketSource",
    "GeneratorSource",
    "KafkaSource",
    "send_stream_batch",
    "StreamingPredictor",
    "producer_thread",
]


class StreamSource:
    """Iterable of micro-batches (numpy arrays or dicts of arrays); a
    ``None``/exhaustion ends the stream."""

    def __iter__(self) -> Iterator[Any]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class QueueSource(StreamSource):
    """Micro-batches from an in-process queue; ``None`` is end-of-stream.
    ``timeout`` bounds the wait for the next batch (a stalled producer ends
    the stream instead of hanging the consumer)."""

    def __init__(self, q: queue.Queue | None = None, timeout: float | None = None):
        self.queue = q if q is not None else queue.Queue()
        self.timeout = timeout

    def put(self, batch) -> None:
        self.queue.put(batch)

    def end(self) -> None:
        self.queue.put(None)

    def __iter__(self):
        while True:
            try:
                item = self.queue.get(timeout=self.timeout)
            except queue.Empty:
                return
            if item is None:
                return
            yield item


class GeneratorSource(StreamSource):
    """Adapt any iterable of micro-batches."""

    def __init__(self, iterable: Iterable[Any]):
        self._iterable = iterable

    def __iter__(self):
        yield from self._iterable


# -- TCP socket source -------------------------------------------------------
# Frame: u32 magic "dkS1" | u64 payload length | npz PyTree payload.
# Zero-length payload = end-of-stream.

_MAGIC = b"dkS1"


def send_stream_batch(sock: socket.socket, batch: Any | None) -> None:
    """Producer-side helper: write one framed micro-batch (``None`` ends
    the stream)."""
    payload = b"" if batch is None else serialize_pytree(batch)
    sock.sendall(_MAGIC + struct.pack("<Q", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class SocketSource(StreamSource):
    """Micro-batches over TCP — the broker-less stand-in for the
    reference's Kafka topic: any producer process connects and streams
    length-prefixed npz frames (safe to accept from the network, unlike the
    reference's pickles).

    Listens on ``host:port`` and consumes ONE producer connection.
    ``port=0`` picks a free port (see ``.port``).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        accept_timeout: float = 30.0,
        recv_timeout: float = 60.0,
    ):
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(1)
        self._server.settimeout(accept_timeout)
        self._recv_timeout = recv_timeout
        self.host, self.port = self._server.getsockname()
        self._conn: socket.socket | None = None

    def __iter__(self):
        self._conn, _ = self._server.accept()
        self._conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # A stalled (still-connected) producer ends the stream rather than
        # hanging the consumer forever — same contract as QueueSource.
        self._conn.settimeout(self._recv_timeout)
        try:
            while True:
                header = _recv_exact(self._conn, 12)
                if header is None:
                    return
                if header[:4] != _MAGIC:
                    raise ValueError("bad stream frame magic")
                (length,) = struct.unpack("<Q", header[4:])
                if length == 0:
                    return
                payload = _recv_exact(self._conn, length)
                if payload is None:
                    return
                yield deserialize_pytree(payload)
        except TimeoutError:
            return  # stalled producer: end of stream
        finally:
            self.close()

    def close(self) -> None:
        for s in (self._conn, self._server):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._conn = None


class KafkaSource(StreamSource):
    """Consume a Kafka topic (requires ``kafka-python``, not bundled here;
    the import is gated so the rest of the module works without it).
    ``value_fn`` maps each raw message value to a micro-batch."""

    def __init__(
        self,
        topic: str,
        bootstrap_servers: str = "localhost:9092",
        value_fn: Callable[[bytes], Any] | None = None,
        **consumer_kwargs,
    ):
        try:
            from kafka import KafkaConsumer  # type: ignore[import-not-found]
        except ImportError as e:
            raise ImportError(
                "KafkaSource requires the kafka-python package; install it "
                "or use SocketSource/QueueSource"
            ) from e
        self._consumer = KafkaConsumer(topic, bootstrap_servers=bootstrap_servers,
                                       **consumer_kwargs)
        self._value_fn = value_fn or deserialize_pytree

    def __iter__(self):
        for msg in self._consumer:
            yield self._value_fn(msg.value)

    def close(self) -> None:
        self._consumer.close()


class StreamingPredictor:
    """Run a trained model over a micro-batch stream.

    Each micro-batch is padded with zero rows to ``max_batch`` rows, so the
    model runs at ONE batch shape whatever the arrival sizes (the padded
    rows are computed and dropped, as
    :class:`~distkeras_tpu_torch.inference.predictors.ModelPredictor` pads
    its last batch); a micro-batch above ``max_batch`` rows is cut into
    pieces of ``max_batch``. The forward runs on the device the trained
    model's weights live on (:attr:`TrainedModel.device`): the card, unless
    the weights are on the CPU.
    """

    def __init__(self, trained_model, max_batch: int = 1024):
        self._trained = trained_model
        self.max_batch = int(max_batch)
        self.device = resolve_device(trained_model.device)
        self.batches = 0
        self.rows = 0

    @torch.inference_mode()
    def _predict(self, padded: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(padded, device=self.device)
        out = self._trained.model.apply(self._trained.variables, x, train=False)[0]
        return out.float().cpu().numpy()

    def _one(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        if n > self.max_batch:
            return np.concatenate(
                [self._one(x[i : i + self.max_batch]) for i in range(0, n, self.max_batch)]
            )
        padded = np.zeros((self.max_batch, *x.shape[1:]), x.dtype)
        padded[:n] = x
        return self._predict(padded)[:n]

    def run(
        self,
        source: StreamSource,
        sink: Callable[[np.ndarray, np.ndarray], None],
    ) -> dict:
        """Consume the stream until exhaustion; ``sink(batch, predictions)``
        per micro-batch. Returns throughput stats for THIS run (the counters
        are reset; the device is synchronized before the wall clock is
        read)."""
        self.batches = 0
        self.rows = 0
        t0 = time.time()
        for batch in source:
            x = np.asarray(batch["features"] if isinstance(batch, dict) else batch)
            preds = self._one(x)
            sink(x, preds)
            self.batches += 1
            self.rows += x.shape[0]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        return {
            "batches": self.batches,
            "rows": self.rows,
            "wall_s": wall,
            "rows_per_sec": self.rows / wall if wall > 0 else float("inf"),
        }


def producer_thread(source: QueueSource, batches: Iterable[Any], delay_s: float = 0.0):
    """Convenience: feed a QueueSource from another thread (demo/test)."""

    def run():
        for b in batches:
            source.put(b)
            if delay_s:
                time.sleep(delay_s)
        source.end()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t

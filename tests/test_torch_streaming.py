"""Streaming sources and ``StreamingPredictor``, against the reference.

- The queue, generator and socket sources carry the same micro-batches,
  sent by the reference's producer or by the port's (``producer_thread``,
  ``send_stream_batch``): the frames are byte-equal, so each package's
  ``SocketSource`` reads the other's producer.
- ``KafkaSource`` runs through the reference test's fake ``kafka`` module
  (default npz value_fn, a custom one, kwargs, close) and refuses with the
  reference's ``ImportError`` without ``kafka-python``.
- ``StreamingPredictor`` over a bridged ``mnist_mlp`` and a bridged
  ``bert_tiny_mlm`` (float32 on both sides) equals the reference's
  ``StreamingPredictor`` within 1e-5 absolute, padded and oversize
  micro-batches included: float32 products in another order.
"""

import dataclasses
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.data import streaming as ref_streaming
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.models.core import Model as RefModel
from distkeras_tpu.models.core import TrainedModel as RefTrainedModel
from distkeras_tpu.models.mlp import MLP as RefMLP
from distkeras_tpu.utils.pytree import serialize_pytree as ref_serialize
from distkeras_tpu_torch.data import streaming
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.utils.bridge import params_from_jax
from distkeras_tpu_torch.utils.pytree import serialize_pytree
from torch_time_limit import time_limited

ATOL = 1e-5
PACKAGES = {"ref": ref_streaming, "port": streaming}


def _bridge(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def mlp_pair():
    """mnist_mlp's architecture at float32 (784 -> 64 -> 32 -> 10), the
    reference's seed-0 weights bridged to the port."""
    ref = RefModel.from_flax(RefMLP(features=(64, 32), num_classes=10,
                                    compute_dtype=jnp.float32), input_shape=(784,))
    params = ref.init(0)["params"]
    port = Model(lambda: MLP(784, (64, 32), 10, compute_dtype=torch.float32),
                 input_shape=(784,))
    return RefTrainedModel(ref, {"params": params}), TrainedModel(port, _bridge(params))


@pytest.fixture(scope="module")
def bert_pair():
    ref = ref_bert.bert_tiny_mlm(seq_len=16, vocab_size=64)
    ref = ref_bert._make(dataclasses.replace(ref.config, dtype=jnp.float32), 16, "bert_tiny_mlm")
    port = port_bert.bert_tiny_mlm(seq_len=16, vocab_size=64)
    port = port_bert._make(dataclasses.replace(port.config, dtype=torch.float32), 16,
                           "bert_tiny_mlm")
    params = ref.init(0)["params"]
    return RefTrainedModel(ref, {"params": params}), TrainedModel(port, _bridge(params))


def _rows(sizes, width=784, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, width)).astype(np.float32) for n in sizes]


def _run(pkg, trained, source, max_batch):
    outs = []
    stats = PACKAGES[pkg].StreamingPredictor(trained, max_batch=max_batch).run(
        source, lambda x, p: outs.append((np.asarray(x), p)))
    return stats, outs


def _socket_feed(producer_pkg, src, batches):
    def produce():
        s = socket.create_connection((src.host, src.port))
        for b in batches:
            PACKAGES[producer_pkg].send_stream_batch(s, b)
        PACKAGES[producer_pkg].send_stream_batch(s, None)
        s.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    return t


def test_frames_are_byte_equal():
    batches = [np.arange(6, dtype=np.float32).reshape(2, 3),
               {"features": np.ones((1, 3), np.float32), "id": np.arange(1)}, None]
    for b in batches:
        frames = []
        for pkg in PACKAGES:
            a, c = socket.socketpair()
            PACKAGES[pkg].send_stream_batch(a, b)
            a.close()
            frames.append(b"".join(iter(lambda c=c: c.recv(65536), b"")))
            c.close()
        assert frames[0] == frames[1]
    assert serialize_pytree({"x": batches[0]}) == ref_serialize({"x": batches[0]})


@pytest.mark.parametrize("producer", ["ref", "port"])
@time_limited(timeout=60)
def test_queue_source(mlp_pair, producer):
    ref_trained, trained = mlp_pair
    batches = _rows([40, 3, 64])
    src = streaming.QueueSource(timeout=10.0)
    PACKAGES[producer].producer_thread(src, batches)
    stats, outs = _run("port", trained, src, 64)
    assert stats["batches"] == 3 and stats["rows"] == 107
    assert set(stats) == {"batches", "rows", "wall_s", "rows_per_sec"}
    for (x, p), b in zip(outs, batches):
        np.testing.assert_array_equal(x, b)
        np.testing.assert_allclose(p, ref_trained.predict(b), atol=ATOL, rtol=0)
        np.testing.assert_allclose(p, trained.predict(b), atol=ATOL, rtol=0)


@time_limited(timeout=60)
def test_queue_source_ends_on_a_stalled_producer():
    src = streaming.QueueSource(timeout=0.05)
    src.put(np.zeros((1, 2), np.float32))
    assert len(list(src)) == 1  # no end marker: the timeout ends the stream


@pytest.mark.parametrize("producer,consumer", [("ref", "port"), ("port", "ref"),
                                               ("port", "port")])
@time_limited(timeout=60)
def test_socket_source_crosses_packages(mlp_pair, producer, consumer):
    ref_trained, trained = mlp_pair
    batches = [{"features": b} for b in _rows([24, 1, 32, 7], seed=2)]
    src = PACKAGES[consumer].SocketSource(port=0)
    t = _socket_feed(producer, src, batches)
    stats, outs = _run(consumer, ref_trained if consumer == "ref" else trained, src, 32)
    t.join(timeout=10)
    assert stats["batches"] == 4 and stats["rows"] == 64
    for (x, p), b in zip(outs, batches):
        np.testing.assert_array_equal(x, b["features"])
        np.testing.assert_allclose(p, ref_trained.predict(b["features"]), atol=ATOL, rtol=0)


@time_limited(timeout=60)
def test_socket_source_rejects_bad_magic():
    src = streaming.SocketSource(port=0)

    def produce():
        s = socket.create_connection((src.host, src.port))
        s.sendall(b"XXXX" + (0).to_bytes(8, "little"))
        s.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    with pytest.raises(ValueError, match="magic"):
        list(src)
    t.join(timeout=10)


@time_limited(timeout=60)
def test_generator_source_padded_and_oversize_match_reference(mlp_pair):
    """150 rows at max_batch 64 (cut 64 + 64 + 22, the last padded) and a
    5-row batch padded to 64: the port's predictions equal the reference's
    StreamingPredictor's."""
    ref_trained, trained = mlp_pair
    batches = _rows([150, 5], seed=3)
    got_stats, got = _run("port", trained, streaming.GeneratorSource(batches), 64)
    want_stats, want = _run("ref", ref_trained, ref_streaming.GeneratorSource(batches), 64)
    assert got_stats["rows"] == want_stats["rows"] == 155
    assert got_stats["batches"] == want_stats["batches"] == 2
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@time_limited(timeout=120)
def test_bert_tiny_streaming_matches_reference(bert_pair):
    """bert_tiny_mlm over token micro-batches of 1, 5, 8 and 11 rows at
    max_batch 8 (the 11 is cut in two): logits equal to the reference's."""
    ref_trained, trained = bert_pair
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 64, size=(n, 16)).astype(np.int32) for n in (1, 5, 8, 11)]
    got_stats, got = _run("port", trained, streaming.GeneratorSource(batches), 8)
    _, want = _run("ref", ref_trained, ref_streaming.GeneratorSource(batches), 8)
    assert got_stats["rows"] == 25
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape == (g.shape[0], 16, 64)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_kafka_source_gated(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "kafka", None)
    for pkg in PACKAGES.values():
        with pytest.raises(ImportError, match="kafka-python"):
            pkg.KafkaSource("topic")


class _FakeKafkaMessage:
    def __init__(self, value: bytes):
        self.value = value


class _FakeKafkaConsumer:
    """The reference test's in-process stand-in for kafka.KafkaConsumer."""

    messages_by_topic: dict = {}
    instances: list = []

    def __init__(self, topic, bootstrap_servers=None, **kwargs):
        self.topic = topic
        self.bootstrap_servers = bootstrap_servers
        self.kwargs = kwargs
        self.closed = False
        self._msgs = list(self.messages_by_topic.get(topic, []))
        _FakeKafkaConsumer.instances.append(self)

    def __iter__(self):
        for m in self._msgs:
            yield _FakeKafkaMessage(m)

    def close(self):
        self.closed = True


@pytest.fixture
def fake_kafka(monkeypatch):
    import sys
    import types

    mod = types.ModuleType("kafka")
    mod.KafkaConsumer = _FakeKafkaConsumer
    _FakeKafkaConsumer.messages_by_topic = {}
    _FakeKafkaConsumer.instances = []
    monkeypatch.setitem(sys.modules, "kafka", mod)
    return _FakeKafkaConsumer


@pytest.mark.parametrize("codec", ["ref", "port"])
def test_kafka_source_default_value_fn(fake_kafka, codec):
    """Frames from either package's ``serialize_pytree`` decode through the
    port's default value_fn (``deserialize_pytree``)."""
    batches = [{"x": np.arange(6, dtype=np.float32).reshape(2, 3)},
               {"x": np.ones((1, 3), np.float32)}]
    encode = ref_serialize if codec == "ref" else serialize_pytree
    fake_kafka.messages_by_topic["feats"] = [encode(b) for b in batches]
    src = streaming.KafkaSource("feats", bootstrap_servers="broker:9092", group_id="g1")
    got = list(src)
    assert len(got) == 2
    for g, b in zip(got, batches):
        np.testing.assert_array_equal(np.asarray(g["x"]), b["x"])
    consumer = fake_kafka.instances[-1]
    assert consumer.bootstrap_servers == "broker:9092"
    assert consumer.kwargs["group_id"] == "g1"
    src.close()
    assert consumer.closed


def test_kafka_source_custom_value_fn_feeds_predictor(fake_kafka, mlp_pair):
    ref_trained, trained = mlp_pair
    raw = _rows([5, 5, 5], seed=7)
    fake_kafka.messages_by_topic["rows"] = [a.tobytes() for a in raw]
    src = streaming.KafkaSource(
        "rows", value_fn=lambda b: np.frombuffer(b, np.float32).reshape(-1, 784))
    stats, outs = _run("port", trained, src, 8)
    assert stats["rows"] == 15 and stats["batches"] == 3
    np.testing.assert_allclose(np.concatenate([p for _, p in outs]),
                               ref_trained.predict(np.concatenate(raw)), atol=ATOL, rtol=0)


def test_predictor_runs_where_the_weights_live(mlp_pair):
    _, trained = mlp_pair
    assert streaming.StreamingPredictor(trained).device == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        streaming.StreamingPredictor(TrainedModel(trained.model, {
            k: v.to("meta") for k, v in trained.variables.items()}))

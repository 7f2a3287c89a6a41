"""The port's gRPC parameter-server transport against the reference's.

The reference's ``tests/test_ps_grpc.py`` and ``tests/test_multiprocess_ps.py``
cases on the port, plus cross-package checks on the wire: a reference
``GrpcClient`` against a port ``GrpcParameterServer`` and the other way
round, and a commit frame byte-equal to the reference's for the same
arrays. Servers bind port 0, so parallel test processes never collide, and
every test runs under ``time_limited``: a client waits up to its RPC
deadline, and a hang must fail the test, not the run.
"""

import os
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu_torch as dk
from distkeras_tpu.parallel import protocols as ref_protocols
from distkeras_tpu.parallel import ps_grpc as ref_grpc
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.parallel import ps_grpc
from distkeras_tpu_torch.parallel.protocols import (
    ADAGProtocol,
    AEASGDProtocol,
    DynSGDProtocol,
)
from distkeras_tpu_torch.parallel.ps_grpc import (
    GrpcClient,
    GrpcParameterServer,
    determine_host_address,
)
from torch_time_limit import time_limited

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _w(value=0.0, n=4):
    return {"w": torch.full((n,), float(value))}


def _server(protocol=None, center=None, num_workers=2):
    ps = GrpcParameterServer(protocol or ADAGProtocol(), center or _w(), num_workers, port=0)
    return ps, ps.start()


def test_determine_host_address():
    addr = determine_host_address()
    assert isinstance(addr, str) and addr.count(".") == 3


@time_limited(timeout=60)
def test_pull_commit_over_wire():
    ps, port = _server()
    try:
        client = GrpcClient("127.0.0.1", port)
        center, n = client.pull()
        assert torch.equal(center["w"], torch.zeros(4)) and n == 0
        client.commit({"delta": {"w": torch.full((4,), 8.0)}})
        center, n = client.pull()
        # ADAG normalization: 8 / num_workers(2) = 4
        assert torch.equal(center["w"], torch.full((4,), 4.0)) and n == 1
        center, n = client.commit_pull({"delta": {"w": torch.full((4,), 2.0)}})
        assert torch.equal(center["w"], torch.full((4,), 5.0)) and n == 2
        assert center["w"].dtype == torch.float32
        client.close()
    finally:
        ps.stop()


@time_limited(timeout=60)
def test_dynsgd_counter_over_wire():
    ps, port = _server(DynSGDProtocol(), _w(n=2))
    try:
        c = GrpcClient("127.0.0.1", port)
        _, last = c.pull()
        c.commit({"delta": {"w": torch.ones(2)}, "last_update": last})
        center, n = c.pull()
        assert n == 1 and torch.equal(center["w"], torch.ones(2))  # staleness 0
        # A stale commit: the server at 1, last_update 0 -> delta / 2.
        c.commit({"delta": {"w": torch.ones(2)}, "last_update": 0})
        center, _ = c.pull()
        assert torch.equal(center["w"], torch.full((2,), 1.5))
        c.close()
    finally:
        ps.stop()


@time_limited(timeout=120)
def test_concurrent_grpc_clients():
    ps, port = _server()
    try:
        def worker():
            c = GrpcClient("127.0.0.1", port)
            for _ in range(25):
                c.commit({"delta": {"w": torch.ones(4)}})
            c.pull()
            c.close()

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert ps.service.num_commits == 100
        # ADAG: each delta scaled by 1/2 -> 100 * 1 / 2 = 50
        assert torch.equal(ps.get_model()["w"], torch.full((4,), 50.0))
    finally:
        ps.stop()


@time_limited(timeout=60)
def test_nested_tree_over_wire():
    """Without ``like`` a reply's structure comes from the frame's key paths
    (nested dicts rebuilt); with it, the leaves fill the given structure.
    bf16 and integer leaves of a served center cross as they are."""
    nested = {"enc": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                      "b": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)},
              "step": torch.tensor(3, dtype=torch.int32)}
    frame = ps_grpc._encode_pull_reply(nested, 7)
    got, n = ps_grpc._decode_pull_reply(frame)
    assert n == 7 and set(got) == {"enc", "step"} and set(got["enc"]) == {"w", "b"}
    assert got["enc"]["b"].dtype == torch.bfloat16 and torch.equal(got["enc"]["b"],
                                                                   nested["enc"]["b"])
    like = {"step": 0, "enc": {"w": 0, "b": 0}}
    got, _ = ps_grpc._decode_pull_reply(frame, like=like)
    assert list(got) == ["step", "enc"] and torch.equal(got["enc"]["w"], nested["enc"]["w"])
    assert frame == ref_grpc._encode_pull_reply(
        {"enc": {"w": nested["enc"]["w"].numpy(),
                 "b": jax.numpy.asarray([1.5, -2.0], jax.numpy.bfloat16)},
         "step": np.asarray(3, np.int32)}, 7)
    center = {"w": torch.ones(3), "b": torch.tensor([0.5], dtype=torch.bfloat16),
              "n": torch.tensor([4], dtype=torch.int64)}
    ps, port = _server(center=center)
    try:
        client = GrpcClient("127.0.0.1", port)
        got, _ = client.pull()
        assert set(got) == set(center)
        for k in center:
            assert got[k].dtype == center[k].dtype and torch.equal(got[k], center[k])
        client.close()
    finally:
        ps.stop()


@time_limited(timeout=60)
def test_grpc_health_rpc():
    ps, port = _server()
    try:
        client = GrpcClient("127.0.0.1", port)
        h = client.health()
        assert h["running"] is True and h["num_commits"] == 0
        client.commit({"delta": {"w": torch.ones(4)}})
        client.pull()
        assert client.health()["num_commits"] == 1
        client.close()
    finally:
        ps.stop()


@pytest.mark.parametrize("payload", [
    {"delta": {"w": np.arange(4, dtype=np.float32)}},
    {"delta": {"b": np.ones((2, 3), np.float32), "a": np.zeros(2, np.float32)},
     "commit_id": "w0:7", "last_update": 12},
    {"local": {"w": np.linspace(0, 1, 5, dtype=np.float32)}, "worker_id": "abc",
     "commit_id": "w1:1", "last_update": 3},
    {"elastic_diff": {"w": np.linspace(-1, 1, 7, dtype=np.float32)}, "worker_id": "xyz",
     "last_update": 9},
], ids=["delta", "stamped", "local", "elastic_bf16"])
def test_commit_bytes_equal_the_reference(payload):
    """The same arrays give the same commit frame in both packages (bf16
    cast by torch on the port's side, by ml_dtypes on the reference's)."""
    port_payload = {k: ({n: torch.from_numpy(a) for n, a in v.items()}
                        if isinstance(v, dict) else v) for k, v in payload.items()}
    ref_payload = dict(payload)
    if "elastic_diff" in payload:
        port_payload["elastic_diff"] = {n: t.to(torch.bfloat16)
                                        for n, t in port_payload["elastic_diff"].items()}
        ref_payload["elastic_diff"] = {n: jax.numpy.asarray(a, jax.numpy.bfloat16)
                                       for n, a in payload["elastic_diff"].items()}
    assert ps_grpc._encode_commit(port_payload) == ref_grpc._encode_commit(ref_payload)
    decoded = ps_grpc._decode_commit(ps_grpc._encode_commit(port_payload))
    want = ref_grpc._decode_commit(ref_grpc._encode_commit(ref_payload))
    assert set(decoded) == set(want)
    for key in decoded:
        if isinstance(decoded[key], dict):
            for n, t in decoded[key].items():
                assert np.array_equal(t.float().numpy(), np.asarray(want[key][n], np.float32))
        else:
            assert decoded[key] == want[key]


@time_limited(timeout=120)
def test_reference_client_against_port_server():
    ps, port = _server()
    try:
        c = ref_grpc.GrpcClient("127.0.0.1", port)
        center, n = c.pull()
        assert isinstance(center["w"], np.ndarray) and n == 0
        c.commit({"delta": {"w": np.full(4, 8.0, np.float32)}, "commit_id": "r:1"})
        c.commit({"delta": {"w": np.full(4, 8.0, np.float32)}, "commit_id": "r:1"})  # deduped
        center, n = c.commit_pull({"delta": {"w": np.full(4, 2.0, np.float32)}})
        np.testing.assert_array_equal(center["w"], np.full(4, 5.0, np.float32))
        assert n == 2 and ps.service.num_duplicates == 1
        assert c.health()["num_commits"] == 2
        c.close()
    finally:
        ps.stop()


@time_limited(timeout=120)
def test_port_client_against_reference_server():
    ps = ref_grpc.GrpcParameterServer(ref_protocols.DynSGDProtocol(),
                                      {"w": np.zeros(3, np.float32)}, 2, port=0)
    port = ps.start()
    try:
        c = GrpcClient("127.0.0.1", port)
        center, last = c.pull()
        assert center["w"].dtype == torch.float32 and last == 0
        c.commit({"delta": {"w": torch.ones(3)}, "last_update": last, "commit_id": "p:1"})
        center, n = c.commit_pull({"delta": {"w": torch.ones(3)}, "last_update": 0})
        # The second commit is stale by one: damped by 1/2.
        assert torch.equal(center["w"], torch.full((3,), 1.5)) and n == 2
        assert c.health()["num_commits"] == 2
        c.close()
        np.testing.assert_array_equal(ps.get_model()["w"], np.full(3, 1.5, np.float32))
    finally:
        ps.stop()


@time_limited(timeout=120)
def test_elastic_fused_wire_bytes_drop_2x():
    """AEASGD's fused exchange costs at most half the raw float32 bytes per
    steady-state window on real gRPC frames (reference
    ``test_elastic_fused_wire_bytes_drop_2x``)."""
    n_params = 32768
    center = {"w": torch.zeros(n_params), "b": torch.zeros(512)}
    proto = AEASGDProtocol(rho=5.0, learning_rate=0.1)
    ps, port = _server(proto, center, num_workers=1)
    try:
        client = GrpcClient("127.0.0.1", port, like=center)
        up_bytes, down_bytes = [], []
        orig = client._commit_pull

        def recording(req, timeout=None):
            up_bytes.append(len(req))
            rep = orig(req, timeout=timeout)
            down_bytes.append(len(rep))
            return rep

        client._commit_pull = recording
        gen = torch.Generator().manual_seed(0)
        params, carry = proto.worker_begin(client, None)
        for _ in range(3):
            params = {k: v + 1e-3 * torch.randn(v.shape, generator=gen) for k, v in params.items()}
            params, carry = proto.worker_window(params, carry, client)
        client.close()
        raw_up = len(ps_grpc._encode_commit(
            {"local": params, "worker_id": carry.worker_id, "last_update": 0}))
        raw_round_trip = raw_up + len(ps_grpc._encode_pull_reply(params, 0))
        steady = up_bytes[-1] + down_bytes[-1]
        assert up_bytes[0] + down_bytes[0] >= raw_round_trip * 0.9  # bootstrap
        assert steady * 2 <= raw_round_trip * 1.05, (steady, raw_round_trip)
    finally:
        ps.stop()


WORKER = textwrap.dedent(
    """
    import sys
    import torch
    from distkeras_tpu_torch.parallel.ps_grpc import GrpcClient

    port = int(sys.argv[1])
    c = GrpcClient("127.0.0.1", port)
    center, n = c.pull()
    assert torch.equal(center["w"], torch.zeros(4)), center
    for i in range(10):
        c.commit({"delta": {"w": torch.ones(4)}, "commit_id": f"sub:{i}"})
    # A replayed commit is deduped by the server.
    c.commit({"delta": {"w": torch.ones(4)}, "commit_id": "sub:0"})
    center, n = c.pull()
    print("WORKER_OK", n, float(center["w"][0]))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "distkeras_tpu"))
    print("IMPORTED", bad)
    """
)


@time_limited(timeout=150)
def test_worker_subprocess_commits_over_grpc():
    """A worker in another process commits over loopback: no shared memory
    anywhere (reference ``tests/test_multiprocess_ps.py``)."""
    ps, port = _server()
    try:
        r = subprocess.run([sys.executable, "-c", WORKER, str(port)], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "WORKER_OK 10 5.0" in r.stdout and "IMPORTED []" in r.stdout, r.stdout
        assert ps.service.num_commits == 10 and ps.service.num_duplicates == 1
        assert torch.equal(ps.get_model()["w"], torch.full((4,), 5.0))  # ADAG: 10 / 2
    finally:
        ps.stop()


D = 8


def _toy(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    return x, (x[:, 0] > 0).astype(np.float32)


def _mlp(hidden=16):
    return Model(lambda: MLP(D, (hidden,), 2, compute_dtype=torch.float32),
                 input_shape=(D,), output_dim=2)


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@time_limited(timeout=120)
def test_adag_one_worker_grpc_equals_inprocess(overlap):
    """The wire is lossless: one ADAG worker ends on bitwise the same
    center over gRPC as over the in-process queue."""
    x, y = _toy()
    data = dk.Dataset.from_arrays(features=x, label=y)
    out = {}
    for transport in ("inprocess", "grpc"):
        tr = dk.ADAG(_mlp(), worker_optimizer="adam", learning_rate=0.01, num_workers=1,
                     batch_size=16, num_epoch=2, communication_window=4,
                     overlap_window=overlap, transport=transport, device="cpu")
        out[transport] = (tr.train(data), tr)
    grpc_tr = out["grpc"][1]
    assert grpc_tr.master_host == "127.0.0.1" and grpc_tr.master_port > 0
    assert grpc_tr._grpc_ps is None  # stopped
    assert grpc_tr.parameter_server.num_commits == out["inprocess"][1].parameter_server.num_commits
    want, got = out["inprocess"][0].variables, out["grpc"][0].variables
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k


@time_limited(timeout=180)
def test_async_trainer_over_grpc_transport():
    """DOWNPOUR with 2 workers and the PS behind gRPC learns the toy task
    (the reference test's bar, accuracy > 0.85)."""
    x, y = _toy()
    tr = dk.DOWNPOUR(_mlp(), worker_optimizer="adam", learning_rate=0.01, num_workers=2,
                     batch_size=16, num_epoch=4, communication_window=4, transport="grpc",
                     device="cpu")
    trained = tr.train(dk.Dataset.from_arrays(features=x, label=y))
    assert tr.parameter_server.num_commits > 0
    acc = float(np.mean(np.argmax(trained.predict(x), -1) == y))
    assert acc > 0.85, acc

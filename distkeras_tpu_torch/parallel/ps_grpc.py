"""Cross-host parameter-server transport over gRPC.

Counterpart of ``distkeras_tpu/parallel/ps_grpc.py``, with the same wire:

- frames are the pickle-free npz tree encoding
  (:func:`distkeras_tpu_torch.utils.pytree.serialize_pytree`), byte for byte
  the reference's, so a reference ``GrpcClient`` talks to a port
  :class:`GrpcParameterServer` and a port :class:`GrpcClient` to a
  reference server;
- the server is a thin gRPC front that forwards pull/commit messages into
  the same single-owner :class:`ParameterServerService` loop used
  in-process, so protocol semantics (DynSGD's update counter included) do
  not depend on the transport. Decoded leaves are torch CPU tensors
  (bfloat16 rebuilt from its ``uint16`` bits), the trees the service's
  protocols work on.

grpcio is used without generated stubs (``GenericRpcHandler`` and raw
method handlers), and is imported only inside the constructors: importing
this module, or the package, never needs it.
"""

from __future__ import annotations

import json
import socket
import struct
from concurrent import futures
from typing import Any

import numpy as np

from distkeras_tpu_torch.parallel.ps import ParameterServerService
from distkeras_tpu_torch.utils.pytree import deserialize_pytree, serialize_pytree

__all__ = [
    "determine_host_address",
    "GrpcParameterServer",
    "GrpcClient",
    "DEFAULT_PORT",
]

DEFAULT_PORT = 50515
_SERVICE = "distkeras_tpu.ParameterServer"


def _import_grpc():
    try:
        import grpc
    except ImportError as e:
        raise ImportError("the gRPC parameter-server transport needs the grpcio "
                          "package, which is not installed") from e
    return grpc


def determine_host_address() -> str:
    """Best-effort routable address of this host (reference
    ``distkeras/networking.py`` § ``determine_host_address``)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        # No packets are sent; connect() on UDP only resolves the route.
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())
    finally:
        s.close()


# -- wire format -------------------------------------------------------------
# pull request:        b""            -> reply: u64 num_updates | npz(center)
# commit request:      u64 last_update | npz(delta)  -> reply: b"\x01"
# commit_pull request: same frame as commit -> reply: same frame as pull reply
#
# The commit tree may be wrapped in a dict carrying out-of-band markers as
# extra npz leaves: "__commit_id__" (dedupe stamp), "__local__" (the tree is
# the worker's local params for a fused elastic exchange, not a delta),
# "__elastic_diff__" (the tree is a bf16 delta against the worker's shared
# mirror: AEASGD's steady state), and "__worker_id__" (keys the PS-side
# mirror of the elastic family).

_MARKERS = ("__commit_id__", "__local__", "__elastic_diff__", "__worker_id__")


def _encode_pull_reply(center: Any, num_updates: int) -> bytes:
    return struct.pack("<Q", num_updates) + serialize_pytree(center)


def _decode_pull_reply(data: bytes, like: Any = None) -> tuple[Any, int]:
    (num_updates,) = struct.unpack("<Q", data[:8])
    return deserialize_pytree(data[8:], like=like), num_updates


def _encode_commit(payload: dict) -> bytes:
    """The commit frame of a client payload (keys: ``delta``, ``local`` or
    ``elastic_diff``; optional ``commit_id``, ``worker_id``,
    ``last_update``). Leaves may be tensors on any device or numpy arrays;
    bfloat16 tensors travel as their bits, as the reference writes them."""
    key = (
        "local" if "local" in payload
        else "elastic_diff" if "elastic_diff" in payload
        else "delta"
    )
    tree = payload[key]
    markers = {}
    if "commit_id" in payload:
        markers["__commit_id__"] = _id_to_array(payload["commit_id"])
    if "worker_id" in payload:
        markers["__worker_id__"] = _id_to_array(payload["worker_id"])
    if key == "local":
        markers["__local__"] = np.ones((1,), np.uint8)
    elif key == "elastic_diff":
        markers["__elastic_diff__"] = np.ones((1,), np.uint8)
    if markers:
        tree = {"d": tree, **markers}
    return struct.pack("<Q", int(payload.get("last_update", 0))) + serialize_pytree(tree)


def _decode_commit(data: bytes) -> dict:
    (last_update,) = struct.unpack("<Q", data[:8])
    tree = deserialize_pytree(data[8:])
    out = {"last_update": int(last_update)}
    key = "delta"
    if isinstance(tree, dict) and any(m in tree for m in _MARKERS):
        if "__commit_id__" in tree:
            out["commit_id"] = _array_to_id(tree["__commit_id__"])
        if "__worker_id__" in tree:
            out["worker_id"] = _array_to_id(tree["__worker_id__"])
        if "__local__" in tree:
            key = "local"
        elif "__elastic_diff__" in tree:
            key = "elastic_diff"
        tree = tree["d"]
    out[key] = tree
    return out


class GrpcParameterServer:
    """gRPC front end around a :class:`ParameterServerService`.

    Lifecycle as the reference's::

        ps = GrpcParameterServer(protocol, center, num_workers, port=0)
        port = ps.start()          # also starts the single-owner loop
        ...
        final = ps.get_model(); ps.stop()
    """

    def __init__(
        self,
        protocol,
        center,
        num_workers,
        host: str = "127.0.0.1",
        port: int = DEFAULT_PORT,
        max_message_mb: int = 1024,
        registry=None,
        health=None,
    ):
        """``host`` defaults to loopback: the PS speaks an unauthenticated
        protocol, so exposing it beyond the host must be an explicit choice
        (``host="0.0.0.0"``) made only on an isolated, trusted network.
        ``max_message_mb`` bounds a frame's size. ``registry``/``health``
        go to the wrapped :class:`ParameterServerService`."""
        self._grpc = _import_grpc()
        self.service = ParameterServerService(
            protocol, center, num_workers, registry=registry, health=health)
        self._host = host
        self._port = port
        self._max_message_bytes = int(max_message_mb) * 1024 * 1024
        self._server = None

    def _handle(self, method: str):
        inproc = self.service.client()

        def pull(request: bytes, context) -> bytes:
            center, num_updates = inproc.pull()
            return _encode_pull_reply(center, num_updates)

        def commit(request: bytes, context) -> bytes:
            inproc.commit(_decode_commit(request))
            return b"\x01"

        def commit_pull(request: bytes, context) -> bytes:
            tree, num_updates = inproc.commit_pull(_decode_commit(request))
            return _encode_pull_reply(tree, num_updates)

        def health(request: bytes, context) -> bytes:
            return json.dumps(self.service.health()).encode()

        fn = {
            "pull": pull,
            "commit": commit,
            "commit_pull": commit_pull,
            "health": health,
        }.get(method)
        if fn is None:
            return None
        return self._grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )

    def start(self) -> int:
        grpc = self._grpc
        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                name = handler_call_details.method.rsplit("/", 1)[-1]
                return outer._handle(name)

        self.service.start()
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            options=[
                ("grpc.max_receive_message_length", self._max_message_bytes),
                ("grpc.max_send_message_length", self._max_message_bytes),
            ],
        )
        self._server.add_generic_rpc_handlers((Handler(),))
        self._port = self._server.add_insecure_port(f"{self._host}:{self._port}")
        self._server.start()
        return self._port

    @property
    def port(self) -> int:
        return self._port

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=1).wait()
            self._server = None
        self.service.stop()

    def get_model(self):
        return self.service.get_model()


class GrpcClient:
    """Worker-side client with the ``pull``/``commit``/``commit_pull``
    surface of :class:`~distkeras_tpu_torch.parallel.ps.InProcessClient`,
    so the trainers do not depend on the transport. Replies are CPU
    tensor trees."""

    def __init__(
        self,
        host: str,
        port: int = DEFAULT_PORT,
        like: Any = None,
        rpc_timeout_s: float = 120.0,
        max_message_mb: int = 1024,
    ):
        # Every RPC carries a deadline: a wedged but live PS surfaces as an
        # error the retry layer can act on, not as an endless wait.
        self._rpc_timeout_s = float(rpc_timeout_s)
        grpc = _import_grpc()
        max_bytes = int(max_message_mb) * 1024 * 1024
        self._channel = grpc.insecure_channel(
            f"{host}:{port}",
            options=[
                ("grpc.max_receive_message_length", max_bytes),
                ("grpc.max_send_message_length", max_bytes),
            ],
        )

        def method(name):
            return self._channel.unary_unary(
                f"/{_SERVICE}/{name}",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )

        self._pull = method("pull")
        self._commit = method("commit")
        self._commit_pull = method("commit_pull")
        self._health = method("health")
        self._like = like

    def pull(self) -> tuple[Any, int]:
        return _decode_pull_reply(self._pull(b"", timeout=self._rpc_timeout_s),
                                  like=self._like)

    def commit(self, payload: dict) -> None:
        self._commit(_encode_commit(payload), timeout=self._rpc_timeout_s)

    def commit_pull(self, payload: dict) -> tuple[Any, int]:
        """Fused commit and pull: one round trip per window."""
        reply = self._commit_pull(_encode_commit(payload), timeout=self._rpc_timeout_s)
        return _decode_pull_reply(reply, like=self._like)

    def health(self, timeout: float = 5.0) -> dict:
        return json.loads(self._health(b"", timeout=timeout).decode())

    def close(self) -> None:
        self._channel.close()


def _id_to_array(cid: str) -> np.ndarray:
    return np.frombuffer(str(cid).encode("utf-8"), dtype=np.uint8).copy()


def _array_to_id(arr) -> str:
    return bytes(np.asarray(arr, dtype=np.uint8)).decode("utf-8")

"""The async protocols, the parameter server and its HA clients, against the
reference.

The same scripted windows go through the reference's protocols (numpy host
trees, ``ml_dtypes`` wire casts) and the port's (torch CPU trees, torch wire
casts): every center, counter, reply and new set of params must be
bit-equal, and AEASGD's wire bytes and mirrors too. Both packages do the
same float32 operations in the same order, and both round bf16 to nearest
even. The EAMSGD optimizer reads the base optimizer's update back from the
weights, so it is held against optax at a float32 tolerance instead.
"""

import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.parallel import ha as ref_ha
from distkeras_tpu.parallel import protocols as ref_protocols
from distkeras_tpu.parallel.ps import ParameterServerService as RefPS
from distkeras_tpu.telemetry.training_health import TrainingHealth as RefHealth
from distkeras_tpu_torch.ops.losses import get_optimizer
from distkeras_tpu_torch.parallel import protocols
from distkeras_tpu_torch.parallel.ha import (
    CompressingClient,
    ParameterServerUnavailable,
    RetryingClient,
    StampingClient,
    watchdog,
)
from distkeras_tpu_torch.parallel.ps import ParameterServerService
from distkeras_tpu_torch.telemetry.registry import MetricsRegistry
from distkeras_tpu_torch.telemetry.spans import Tracer, disable_tracing, enable_tracing, span
from distkeras_tpu_torch.telemetry.training_health import TrainingHealth
from distkeras_tpu_torch.utils import pytree
from torch_time_limit import time_limited

PROTOCOLS = ["DOWNPOURProtocol", "ADAGProtocol", "AEASGDProtocol", "EAMSGDProtocol",
             "DynSGDProtocol"]
ELASTIC = {"rho": 2.0, "learning_rate": 0.05}
REBOOT = 1 << 63


def _pair(name, **kw):
    if name in ("AEASGDProtocol", "EAMSGDProtocol"):
        kw = {**ELASTIC, **kw}
    return getattr(ref_protocols, name)(**kw), getattr(protocols, name)(**kw)


def _to_torch(tree):
    out = {}
    for k, v in tree.items():
        a = np.asarray(v)
        if a.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(a))
    return out


def _bits(x):
    """The raw bytes of a leaf of either package, as a numpy array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_bit_equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.normal(size=64)).astype(np.float32),
            "b": (scale * rng.normal(size=(2, 4))).astype(np.float32)}


class _FakePS:
    """The protocol's own server hooks against a center it owns, behind a
    client with ``commit_pull`` (``fused``), the same on an in-process wire
    (``local``), or with pull and commit only (``unfused``). Records every
    payload it receives."""

    def __init__(self, protocol, center, wire, num_workers=2):
        self.protocol, self.center, self.num_updates = protocol, center, 0
        self.num_workers, self.payloads = num_workers, []
        if wire != "unfused":
            self.commit_pull = self._commit_pull
        self.wire_is_local = wire == "local"

    def pull(self):
        return self.center, self.num_updates

    def commit(self, payload):
        self.payloads.append(payload)
        self.center, self.num_updates = self.protocol.server_commit(
            self.center, self.num_updates, payload, self.num_workers)

    def _commit_pull(self, payload):
        self.payloads.append(payload)
        self.center, self.num_updates, reply = self.protocol.server_commit_pull(
            self.center, self.num_updates, payload, self.num_workers)
        return reply


@pytest.mark.parametrize("wire", ["fused", "local", "unfused"])
@pytest.mark.parametrize("name", PROTOCOLS)
def test_scripted_windows_match_reference(name, wire):
    """Two workers take turns for four windows each (so DynSGD sees
    staleness); each window drifts the params by the same seeded noise in
    both packages. Every window's new params, carry, center, counter and
    payload bytes agree bit for bit."""
    ref_p, port_p = _pair(name)
    center = _tree(0)
    ref_ps = _FakePS(ref_p, center, wire)
    port_ps = _FakePS(port_p, _to_torch(center), wire)
    workers = []
    for _ in range(2):
        rp, rc = ref_p.worker_begin(ref_ps, None)
        pp, pc = port_p.worker_begin(port_ps, None)
        workers.append([rp, rc, pp, pc])
    for step in range(8):
        w = workers[step % 2]
        drift = _tree(100 + step, scale=1e-2)
        w[0] = {k: np.asarray(v) + drift[k] for k, v in w[0].items()}
        w[2] = {k: v + torch.from_numpy(drift[k]) for k, v in w[2].items()}
        w[0], w[1] = ref_p.worker_window(w[0], w[1], ref_ps)
        w[2], w[3] = port_p.worker_window(w[2], w[3], port_ps)
        what = f"{name} {wire} window {step}"
        _assert_bit_equal(w[2], w[0], what + " params")
        _assert_bit_equal(w[3].window_start, w[1].window_start, what + " window_start")
        assert w[3].last_update == w[1].last_update, what
        assert bool(w[3].mirror) == bool(w[1].mirror), what
        if w[1].mirror is not None:
            _assert_bit_equal(w[3].mirror, w[1].mirror, what + " mirror")
        _assert_bit_equal(port_ps.center, ref_ps.center, what + " center")
        assert port_ps.num_updates == ref_ps.num_updates, what
        for key in ("delta", "local", "elastic_diff"):
            if key in ref_ps.payloads[-1]:
                _assert_bit_equal(port_ps.payloads[-1][key], ref_ps.payloads[-1][key],
                                  what + " " + key)
    assert port_ps.num_updates == 8


@pytest.mark.parametrize("name", PROTOCOLS)
def test_commit_stats_match_reference(name):
    """Health accounting of one commit against the pre-commit state:
    staleness, damping, update norm (float64 sums in another order) and,
    for the elastic family, divergence."""
    ref_p, port_p = _pair(name)
    center, delta = _tree(1), _tree(2, scale=0.1)
    for payload in ({"delta": delta, "last_update": 3},
                    {"local": _tree(3), "last_update": 5}):
        want = ref_p.commit_stats(center, 7, payload, 4)
        got = port_p.commit_stats(_to_torch(center), 7,
                                  {k: _to_torch(v) if isinstance(v, dict) else v
                                   for k, v in payload.items()}, 4)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), (name, k)


def test_server_commit_rules():
    """The five rules at a glance, as in the reference's unit cases."""
    c = {"w": torch.zeros(4)}
    d = {"w": torch.full((4,), 8.0)}
    assert torch.equal(protocols.DOWNPOURProtocol().server_commit(c, 0, {"delta": d}, 4)[0]["w"],
                       d["w"])
    assert torch.equal(protocols.ADAGProtocol().server_commit(c, 0, {"delta": d}, 4)[0]["w"],
                       torch.full((4,), 2.0))
    center, n = protocols.DynSGDProtocol().server_commit(
        c, 5, {"delta": d, "last_update": 3}, 2)  # staleness 2 -> /3
    assert n == 6 and torch.allclose(center["w"], torch.full((4,), 8.0 / 3))
    assert protocols.ADAGProtocol().communication_window == 12
    assert protocols.AEASGDProtocol().communication_window == 32


# -- AEASGD's fused exchange --------------------------------------------------


def _drift(tree, seed):
    noise = _tree(seed, scale=1e-3)
    return {k: v + torch.from_numpy(noise[k]) for k, v in tree.items()}


def test_aeasgd_rebootstrap_after_mirror_loss():
    """A PS that lost the worker's mirror answers with the re-bootstrap flag:
    the worker skips the window, then re-sends full params."""
    _, p = _pair("AEASGDProtocol")
    ps = _FakePS(p, _to_torch(_tree(0)), "fused")
    params, carry = p.worker_begin(ps, None)
    params, carry = p.worker_window(_drift(params, 0), carry, ps)
    assert carry.mirror is not None
    p._mirrors.clear()
    before, n_before = {k: v.clone() for k, v in params.items()}, ps.num_updates
    params, carry = p.worker_window(params, carry, ps)
    assert carry.mirror is None and ps.num_updates == n_before
    _assert_bit_equal(params, before, "no-op window")
    params, carry = p.worker_window(_drift(params, 1), carry, ps)
    assert carry.mirror is not None and carry.worker_id in p._mirrors


def test_aeasgd_duplicate_replies():
    """A deduped retry replays the recorded reply verbatim; a flagged
    exchange replays the flag and a zero tree, even with the record gone."""
    _, p = _pair("AEASGDProtocol")
    center = {"w": torch.zeros(16)}
    payload = {"local": {"w": torch.full((16,), 2.0)}, "worker_id": "w0", "last_update": 0}
    center, n, reply = p.server_commit_pull(center, 0, payload, 2)
    replay, counter = p.server_duplicate_reply(center, n, payload)
    assert counter == reply[1] and torch.equal(replay["w"], reply[0]["w"])

    lost = {"elastic_diff": {"w": torch.zeros(8, dtype=torch.bfloat16)},
            "worker_id": "w-lost", "last_update": 0}
    c2, n2, (_, counter) = p.server_commit_pull({"w": torch.full((8,), 7.0)}, 5, lost, 2)
    assert counter & REBOOT
    for _ in range(2):
        replay, dup = p.server_duplicate_reply(c2, n2, lost)
        assert dup & REBOOT and torch.equal(replay["w"].float(), torch.zeros(8))
        p._last_reply.clear()


def test_aeasgd_state_bounded_under_churn():
    """Mirrors are LRU-bounded at 2N, replies at 4N; an evicted worker's
    next diff is flagged; a reply outlives its mirror's eviction; ghosts
    that never bootstrap leave nothing behind."""
    _, p = _pair("AEASGDProtocol")
    center, nw = {"w": torch.zeros(16)}, 3
    for i in range(20):
        center, _, _ = p.server_commit_pull(
            center, i, {"local": {"w": torch.full((16,), float(i))}, "worker_id": f"w{i}",
                        "last_update": 0}, nw)
    assert len(p._mirrors) <= 2 * nw and len(p._last_reply) <= 4 * nw
    diff = {"w": torch.zeros(16, dtype=torch.bfloat16)}
    _, _, (_, counter) = p.server_commit_pull(
        center, 20, {"elastic_diff": diff, "worker_id": "w0", "last_update": 0}, nw)
    assert counter & REBOOT

    _, q = _pair("AEASGDProtocol")
    payload = {"local": {"w": torch.full((16,), 2.0)}, "worker_id": "w0", "last_update": 0}
    c, n, reply = q.server_commit_pull({"w": torch.zeros(16)}, 0, payload, 2)
    for i in range(5):  # past the mirror bound (4), not the reply bound (8)
        c, n, _ = q.server_commit_pull(
            c, n, {"local": {"w": torch.full((16,), float(i))}, "worker_id": f"o{i}",
                   "last_update": 0}, 2)
    assert "w0" not in q._mirrors
    replay, counter = q.server_duplicate_reply(c, n, payload)
    assert counter == reply[1] and torch.equal(replay["w"], reply[0]["w"])

    _, g = _pair("AEASGDProtocol")
    for i in range(50):
        g.server_commit_pull({"w": torch.zeros(16)}, i,
                             {"elastic_diff": diff, "worker_id": f"ghost{i}",
                              "last_update": 0}, 2)
    assert not g._mirrors and not g._last_reply


def test_aeasgd_host_state_within_budget():
    n_params, nw = 1024, 3
    _, p = _pair("AEASGDProtocol")
    center = {"w": torch.zeros(n_params)}
    gen = torch.Generator().manual_seed(0)
    for i in range(12):
        center, _, _ = p.server_commit_pull(
            center, i, {"local": {"w": torch.randn(n_params, generator=gen)},
                        "worker_id": f"w{i % nw}", "last_update": 0}, nw)
    mirror_bytes = sum(m["w"].numel() * m["w"].element_size() for m in p._mirrors.values())
    reply_bytes = sum(r[0]["w"].numel() * r[0]["w"].element_size()
                      for r in p._last_reply.values())
    assert mirror_bytes == len(p._mirrors) * 2 * n_params  # stored bf16
    assert mirror_bytes + reply_bytes <= p.host_state_budget(n_params, nw)
    assert p.host_state_budget(n_params, nw) == _pair("AEASGDProtocol")[0].host_state_budget(
        n_params, nw)
    _, p32 = _pair("AEASGDProtocol", mirror_dtype="float32")
    p32.server_commit_pull({"w": torch.zeros(4)}, 0,
                           {"local": {"w": torch.ones(4)}, "worker_id": "a",
                            "last_update": 0}, 1)
    assert p32._mirrors["a"]["w"].dtype == torch.float32


@time_limited
def test_aeasgd_local_transport_skips_mirror_machinery():
    """Through the in-process client the exchange ships full-precision params
    with no worker id: no mirror on either side, and every exchange applies."""
    _, p = _pair("AEASGDProtocol")
    svc = ParameterServerService(p, _to_torch(_tree(0)), 1)
    svc.start()
    try:
        client = svc.client()
        assert client.wire_is_local
        params, carry = p.worker_begin(client, None)
        for i in range(3):
            params, carry = p.worker_window(_drift(params, i), carry, client)
        assert carry.mirror is None and not carry.worker_id
        assert not p._mirrors and not p._last_reply
        assert svc.num_commits == 3
    finally:
        svc.stop()


def test_wire_casts_round_like_ml_dtypes():
    """The torch host cast gives the bytes ml_dtypes gives, ties to even
    included, and the widening is exact."""
    x = np.concatenate([np.random.default_rng(0).normal(size=4096).astype(np.float32),
                        np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 3.0e38, 1e-40],
                                 np.float32)])
    got = protocols._wire_bf16({"x": torch.from_numpy(x), "i": torch.arange(3)})
    want = ref_protocols._wire_bf16({"x": x, "i": np.arange(3)})
    _assert_bit_equal(got, {"x": want["x"], "i": np.arange(3)}, "bf16")
    _assert_bit_equal(protocols._wire_f32(got), ref_protocols._wire_f32(want), "f32")


# -- the parameter server and its clients -------------------------------------


def _ps(protocol=None, center=None, nw=2, **kw):
    ps = ParameterServerService(protocol or protocols.DOWNPOURProtocol(),
                                center or {"w": torch.zeros(2)}, nw, **kw)
    ps.start()
    return ps


@time_limited
def test_ps_dedupes_stamped_commits():
    """A stamped commit sent twice (a retry after a lost reply) applies
    once; the fused retry still gets an answer."""
    ps = _ps()
    try:
        inner = ps.client()

        class Twice:
            def pull(self):
                return inner.pull()

            def commit(self, payload):
                inner.commit(payload)
                inner.commit(payload)

            def commit_pull(self, payload):
                inner.commit_pull(payload)
                return inner.commit_pull(payload)

        client = StampingClient(Twice(), worker_id=3)
        client.commit({"delta": {"w": torch.ones(2)}})
        center, n = client.commit_pull({"delta": {"w": torch.ones(2)}, "last_update": 1})
        assert n == 2 and torch.equal(center["w"], torch.full((2,), 2.0))
        assert ps.num_commits == 2 and ps.num_duplicates == 2
        assert ps.health()["running"]
    finally:
        ps.stop()
    assert torch.equal(ps.get_model()["w"], torch.full((2,), 2.0))


@time_limited
def test_replies_are_the_receivers_own_copies():
    """Every reply (pull, fused exchange, get_model) is a copy the receiver
    may change: the PS's center does not move with it."""
    ps = _ps()
    try:
        client = ps.client()
        pulled, _ = client.pull()
        pulled["w"].fill_(7.0)
        center, n = client.commit_pull({"delta": {"w": torch.ones(2)}, "last_update": 0})
        center["w"].fill_(9.0)
        model = ps.get_model()
        assert n == 1 and torch.equal(model["w"], torch.ones(2))
        model["w"].fill_(5.0)
        assert torch.equal(client.pull()[0]["w"], torch.ones(2))
    finally:
        ps.stop()


@time_limited
def test_retrying_client_recovers_and_gives_up():
    ps = _ps()
    try:
        inner, fails = ps.client(), {"pull": 2, "commit": 2}

        class Flaky:
            def pull(self):
                if fails["pull"]:
                    fails["pull"] -= 1
                    raise ConnectionError("flaky")
                return inner.pull()

            def commit(self, payload):
                if fails["commit"]:
                    fails["commit"] -= 1
                    raise ConnectionError("flaky")
                return inner.commit(payload)

        registry = MetricsRegistry()
        client = RetryingClient(Flaky(), base_delay=0.001, registry=registry)
        assert client.pull()[1] == 0
        client.commit({"delta": {"w": torch.ones(2)}})
        center, n = client.pull()
        assert n == 1 and torch.equal(center["w"], torch.ones(2))
        assert registry.counter("ps_client_retries_total", op="any").value == 4
    finally:
        ps.stop()

    class Down:
        def pull(self):
            raise ConnectionError("down")

    with pytest.raises(ParameterServerUnavailable):
        RetryingClient(Down(), max_retries=2, base_delay=0.001).pull()


def test_compressing_client_bytes_match_reference():
    """CompressingClient's bf16 deltas are the reference's bytes (its
    cast runs through XLA; the port's is a torch cast)."""
    delta = _tree(5)
    sent = {}

    class Sink:
        def commit_pull(self, payload):
            sent.update(payload)
            return None

        def commit(self, payload):
            sent.update(payload)

    CompressingClient(Sink()).commit_pull({"delta": _to_torch(delta), "last_update": 0})
    want = ref_ha.CompressingClient._bf16(delta)
    _assert_bit_equal(sent["delta"], want, "compressed delta")
    assert sent["last_update"] == 0
    local = _to_torch(_tree(6))
    CompressingClient(Sink()).commit_pull({"local": local})
    assert sent["local"] is local  # absolute weights stay full precision


def test_watchdog_fires_on_stall():
    """No commit progress for ``stall_after`` checks fires the callback once
    per stall; the thread stops when asked."""
    fired = []
    registry = MetricsRegistry()
    t = watchdog(lambda: {"running": True, "num_commits": 7}, fired.append,
                 interval=0.01, stall_after=2, registry=registry)
    deadline = time.time() + 10
    while not fired and time.time() < deadline:
        time.sleep(0.01)
    t.stop_event.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert fired and fired[0]["num_commits"] == 7
    assert registry.counter("ps_watchdog_stalls_total").value >= 1


@time_limited
def test_dynsgd_damps_a_stale_worker_through_the_ps():
    ps = _ps(protocols.DynSGDProtocol(), {"w": torch.zeros(1, dtype=torch.float64)})
    try:
        fresh, stale = ps.client(), ps.client()
        for _ in range(5):
            _, last = fresh.pull()
            fresh.commit({"delta": {"w": torch.ones(1, dtype=torch.float64)},
                          "last_update": last})
        assert fresh.pull()[1] == 5
        before = ps.get_model()["w"].item()
        stale.commit({"delta": {"w": torch.full((1,), 6.0, dtype=torch.float64)},
                      "last_update": 0})
        stale.pull()
        assert ps.get_model()["w"].item() - before == pytest.approx(1.0)  # 6 / (5 + 1)
    finally:
        ps.stop()


@time_limited
def test_concurrent_commits_land_once():
    """Eight threads commit at once under a short switch interval: every
    commit lands exactly once."""
    import sys

    ps = _ps(center={"w": torch.zeros(1, dtype=torch.float64)}, nw=8)
    per_thread, n_threads = 100, 8

    def hammer():
        c = ps.client()
        for i in range(per_thread):
            c.commit({"delta": {"w": torch.ones(1, dtype=torch.float64)}})
            if i % 25 == 0:
                c.pull()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    ps.client().pull()
    ps.stop()
    assert ps.num_commits == per_thread * n_threads
    assert ps.get_model()["w"].item() == per_thread * n_threads


@time_limited
def test_training_health_matches_reference():
    """The same stamped DynSGD commits through both packages' PS with health
    attached: the same per-worker table, staleness percentiles and goodput."""
    tables = []
    for PS, proto, health, conv in (
        (RefPS, ref_protocols.DynSGDProtocol(), RefHealth(num_workers=2, protocol="dynsgd"),
         lambda t: t),
        (ParameterServerService, protocols.DynSGDProtocol(),
         TrainingHealth(MetricsRegistry(), num_workers=2, protocol="dynsgd"), _to_torch),
    ):
        ps = PS(proto, conv(_tree(0)), 2, health=health)
        ps.start()
        try:
            clients = [StampingClient(ps.client(), w) for w in range(2)]
            for i in range(6):
                w = i % 2
                clients[w].commit_pull({"delta": conv(_tree(10 + i)), "last_update": i // 3})
            health.record_window(0, 5)
        finally:
            ps.stop()
        s = health.statusz()
        tables.append(([{k: v for k, v in row.items() if "age" not in k and "rate" not in k}
                        for row in s["workers"]], s["staleness"], s["goodput"]))
    (rw, rs, rg), (pw, pstale, pg) = tables
    assert pw == rw and pstale == rs
    assert pg["ratio"] == pytest.approx(rg["ratio"], rel=1e-9)


def test_pytree_helpers():
    a = {"w": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0], dtype=torch.bfloat16)}
    assert pytree.l2(a) == 5.0
    m = pytree.mean([a, pytree.scale(a, 3.0)])
    assert torch.equal(m["w"], torch.tensor([6.0, 8.0])) and m["b"].dtype == torch.bfloat16
    mixed = pytree.add({"w": torch.ones(2)}, {"w": torch.ones(2, dtype=torch.bfloat16)})
    assert mixed["w"].dtype == torch.float32
    host = pytree.to_host(a)
    assert host["w"].data_ptr() == a["w"].data_ptr()
    with pytest.raises(ValueError):
        pytree.mean([])


def test_spans_record_matched_events():
    tracer = enable_tracing(Tracer())
    try:
        with span("outer", worker=0):
            with span("inner"):
                pass
    finally:
        disable_tracing()
    events = tracer.chrome_trace()["traceEvents"]
    names = [(e["ph"], e["name"]) for e in events if e["ph"] in "BE"]
    assert names == [("B", "outer"), ("B", "inner"), ("E", "inner"), ("E", "outer")]
    assert span("off") is span("off")  # the shared no-op while disabled


# -- EAMSGD's local optimizer ---------------------------------------------------


@pytest.mark.parametrize("base", ["sgd", "adam", "adagrad"])
def test_eamsgd_optimizer_matches_optax(base):
    """``optax.chain(base, trace(0.9, nesterov=True))`` against the port's
    NesterovTrace over the same gradients, five steps. The trace follows the
    base update (not the gradient), so under adam the steps grow to ~10x the
    first. Tolerance: the update is read back from float32 weights of
    magnitude ~1, so it carries ~1e-7 of absolute error a step."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(3, 5)).astype(np.float32)
    grads = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(5)]
    ref_p, port_p = _pair("EAMSGDProtocol", momentum=0.9)
    from distkeras_tpu.ops.losses import get_optimizer as ref_get_optimizer

    tx = ref_p.local_optimizer(ref_get_optimizer(base))
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)
    p = torch.from_numpy(w0.copy()).requires_grad_()
    opt = port_p.local_optimizer(get_optimizer(base))([p])
    assert opt.param_groups[0]["params"][0] is p
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        opt.zero_grad(set_to_none=True)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]), rtol=0,
                                   atol=1e-6)
    assert not np.allclose(w0, p.detach().numpy())

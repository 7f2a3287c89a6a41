"""Multi-device async islands (``devices_per_worker``) against the reference.

The reference makes each async worker an island: its state replicated over a
``{"dp": n}`` sub-mesh of its devices (8 virtual CPU devices here), each
window's batch of ``batch_size · n`` rows split over them, one XLA step over
the island (reference ``trainers.py:1002-1063``). The port runs a replica a
thread, each on one of the listed devices (``"cpu"`` repeated here), joined
by an in-process group (``parallel/island.py``).

Cases: DOWNPOUR and ADAG with 2 workers x 2 devices, their commits forced
into one round-robin order in both packages (as
``tests/test_torch_real_data.py`` forces DOWNPOUR's four workers); an island
of ResNet-18 at width 8 (BatchNorm's moments over the island's whole
batch); an MoE model in an island (the routing takes the island's whole
batch) against one device on that batch; the reference's kitchen sink
(``tests/test_ha.py:185-215``: ADAG, 2 x 2 islands, gRPC, bf16 commit
deltas, PS checkpoints, then a resumed run); the device count's message.

Tolerances: the multi-rank float32 ones (``tests/test_torch_data_parallel.py``):
each step's loss to 1e-5 relative, accuracy to 1e-6, the center to 2e-6
absolute, on the float32 MLP with adagrad (adam's normalisation carries
the last bits of the gradients' summation order into every weight, past
that bound within a few steps). ResNet's weights and running statistics to 1e-4 of each tensor's
largest magnitude, as that file holds resnet18's data-parallel steps.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as ref
import distkeras_tpu_torch as dk
from distkeras_tpu.models import resnet as ref_resnet
from distkeras_tpu.models.core import Model as RefModel
from distkeras_tpu.models.mlp import MLP as RefMLP
from distkeras_tpu.parallel import protocols as ref_protocols
from distkeras_tpu_torch.models import resnet
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.parallel import protocols as port_protocols
from distkeras_tpu_torch.parallel.island import IslandGroup
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_time_limit import time_limited

LOSS_RTOL, ACC_ATOL, CENTER_ATOL, RESNET_RTOL = 1e-5, 1e-6, 2e-6, 1e-4
D = 16


def _toy(n=256, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(D,))
    x = rng.normal(size=(n, D)).astype(np.float32)
    return x, (x @ w > 0).astype(np.float32)


def _bridge(variables) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, variables), device="cpu")


@pytest.fixture(scope="module")
def mlp_pair():
    """The reference's float32 MLP and the port's, whose init returns the
    reference's weights for seed 0, bridged."""
    ref_model = RefModel.from_flax(RefMLP(features=(32,), num_classes=2,
                                          compute_dtype=jnp.float32),
                                   input_shape=(D,), output_dim=2)
    start = _bridge(ref_model.init(jax.random.split(jax.random.PRNGKey(0))[0])["params"])
    port = Model(lambda: MLP(D, (32,), 2, compute_dtype=torch.float32), input_shape=(D,),
                 output_dim=2)
    port.init = lambda seed=0, device=None: {k: v.clone() for k, v in start.items()}
    return ref_model, port, start


def _round_robin(monkeypatch, num_workers: int) -> None:
    """In both packages: the workers' fused exchanges reach the PS in the
    order 0, 1, ..., N-1, 0, ... (each worker runs the same number of
    windows)."""
    for module in (ref_protocols, port_protocols):
        cond, turn = threading.Condition(), [0]
        window = module._DeltaWindowMixin.worker_window

        def ordered(self, params, carry, client, cond=cond, turn=turn, window=window):
            wid = client._worker_id
            with cond:
                assert cond.wait_for(lambda: turn[0] == wid, timeout=60), "round robin stalled"
            try:
                return window(self, params, carry, client)
            finally:
                with cond:
                    turn[0] = (turn[0] + 1) % num_workers
                    cond.notify_all()

        monkeypatch.setattr(module._DeltaWindowMixin, "worker_window", ordered)


def _assert_histories(got, want, rtol=LOSS_RTOL):
    """Each worker's steps, in order: loss and accuracy."""
    assert len(got) == len(want) > 0
    for w in {h["worker"] for h in want}:
        g = [h for h in got if h["worker"] == w]
        r = [h for h in want if h["worker"] == w]
        assert len(g) == len(r) > 0
        for a, b in zip(g, r):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=rtol)
            assert a["accuracy"] == pytest.approx(b["accuracy"], abs=ACC_ATOL)


def _assert_center(got: dict, want: dict, atol=CENTER_ATOL, start=None):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0,
                                   err_msg=k)
    if start is not None:  # the center trained
        assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-2


@pytest.mark.parametrize("name", ["DOWNPOUR", "ADAG"])
@time_limited(timeout=180)
def test_two_islands_match_reference_in_one_commit_order(monkeypatch, mlp_pair, name):
    """2 workers x 2 devices, overlapped exchange, commits round robin: each
    worker's per-step loss and accuracy and the final center."""
    _round_robin(monkeypatch, 2)
    ref_model, port, start = mlp_pair
    x, y = _toy()
    kwargs = dict(worker_optimizer="adagrad", learning_rate=0.1, num_workers=2,
                  devices_per_worker=2, batch_size=16, num_epoch=2, seed=0,
                  communication_window=4)
    want_tr = getattr(ref, name)(ref_model, **kwargs)
    want = want_tr.train(ref.Dataset.from_arrays(features=x, label=y), shuffle=True)
    tr = getattr(dk, name)(port, device=["cpu"] * 4, **kwargs)
    got = tr.train(dk.Dataset.from_arrays(features=x, label=y), shuffle=True)
    assert tr.parameter_server.num_commits == want_tr.parameter_server.num_commits == 4
    # 256 rows over 2 workers, 32-row island batches: 4 steps an epoch
    assert len(tr.history) == 2 * 2 * 4
    _assert_histories(tr.history, want_tr.history)
    _assert_center(got.variables, _bridge(want.params), start=start)


@time_limited(timeout=180)
def test_an_island_equals_one_device_on_its_whole_batch(mlp_pair):
    """One worker: the island of 2 devices at batch 16 a replica against the
    port on one device at batch 32 (the same rows), DynSGD without the
    overlapped exchange."""
    _, port, _ = mlp_pair
    x, y = _toy()
    kwargs = dict(worker_optimizer="adagrad", learning_rate=0.1, num_workers=1, num_epoch=2,
                  seed=0, communication_window=3, overlap_window=False)
    island = dk.DynSGD(port, device=["cpu", "cpu"], devices_per_worker=2, batch_size=16,
                       **kwargs)
    got = island.train(dk.Dataset.from_arrays(features=x, label=y), shuffle=True)
    one = dk.DynSGD(port, device="cpu", batch_size=32, **kwargs)
    want = one.train(dk.Dataset.from_arrays(features=x, label=y), shuffle=True)
    _assert_histories(island.history, one.history)
    _assert_center(got.variables, want.variables)
    assert island.parameter_server.num_commits == one.parameter_server.num_commits


@time_limited(timeout=180)
def test_moe_island_routes_the_island_batch():
    """An MoE model (bert_tiny_moe_mlm at top-2, float32, dropout 0) in one
    island of 2 devices routes the island's whole batch, as the
    reference's sub-mesh routes its global batch: the island against the
    port on one device at twice the batch (the same rows), each step's
    loss and the final center."""
    import dataclasses

    from distkeras_tpu_torch.models import bert

    base = bert.bert_tiny_moe_mlm(seq_len=16, vocab_size=64, top_k=2)
    model = bert._make(dataclasses.replace(base.config, dtype=torch.float32,
                                           dropout_rate=0.0), 16, base.name)
    start = model.init(0, device="cpu")
    model.init = lambda seed=0, device=None: {k: v.clone() for k, v in start.items()}
    ids = np.random.default_rng(4).integers(0, 64, size=(64, 16)).astype(np.int32)
    data = dict(features=ids, label=ids)
    kwargs = dict(loss="fused_categorical_crossentropy", num_workers=1, num_epoch=1, seed=0,
                  communication_window=2, overlap_window=False)
    island = dk.DOWNPOUR(model, device=["cpu", "cpu"], devices_per_worker=2, batch_size=8,
                         **kwargs)
    got = island.train(dk.Dataset.from_arrays(**data))
    one = dk.DOWNPOUR(model, device="cpu", batch_size=16, **kwargs)
    want = one.train(dk.Dataset.from_arrays(**data))
    _assert_histories(island.history, one.history)
    _assert_center(got.variables, want.variables)


def _resnets(width=8, classes=10, size=32):
    ref_model = RefModel.from_flax(
        ref_resnet.ResNet(stage_sizes=(2, 2, 2, 2), block_cls=ref_resnet.BasicBlock,
                          num_classes=classes, width=width, dtype=jnp.float32),
        input_shape=(size, size, 3), output_dim=classes)
    start = _bridge(ref_model.init(jax.random.split(jax.random.PRNGKey(0))[0]))
    port = Model(lambda: resnet.ResNet((2, 2, 2, 2), resnet.BasicBlock, classes, width=width,
                                       dtype=torch.float32),
                 input_shape=(size, size, 3), output_dim=classes)
    port.init = lambda seed=0, device=None: {k: v.clone() for k, v in start.items()}
    return ref_model, port, start


@time_limited(timeout=240)
def test_resnet_island_takes_the_island_batch_moments():
    """ResNet-18 at width 8, one worker over 2 devices, 8 rows a replica:
    BatchNorm's moments are the island's 16 rows'. Per-step loss, the center
    and the running statistics (the worker's, returned with the center)
    against the reference's island."""
    ref_model, port, start = _resnets()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(64,)).astype(np.int32)
    kwargs = dict(loss="sparse_categorical_crossentropy", worker_optimizer="adagrad",
                  num_workers=1, devices_per_worker=2, batch_size=8, num_epoch=1, seed=0,
                  communication_window=2, overlap_window=False)
    want_tr = ref.DOWNPOUR(ref_model, **kwargs)
    want = want_tr.train(ref.Dataset.from_arrays(features=x, label=y))
    tr = dk.DOWNPOUR(port, device=["cpu", "cpu"], **kwargs)
    got = tr.train(dk.Dataset.from_arrays(features=x, label=y))
    _assert_histories(tr.history, want_tr.history)
    want_v = _bridge(want.variables)
    assert got.variables.keys() == want_v.keys()
    stats = [k for k in want_v if k.endswith((".mean", ".var"))]
    assert len(stats) == 2 * 20
    for k in want_v:
        atol = RESNET_RTOL * max(float(want_v[k].abs().max()), 1e-6)
        np.testing.assert_allclose(got.variables[k].numpy(), want_v[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)
    assert all(not torch.equal(want_v[k], start[k]) for k in stats)


@time_limited(timeout=240)
def test_islands_kitchen_sink_matches_reference(monkeypatch, tmp_path, mlp_pair):
    """The reference's kitchen sink (tests/test_ha.py:185-215) in one commit
    order: ADAG with 2 x 2 islands, the gRPC transport, bf16 commit deltas
    and PS checkpoints, then a resumed run from the checkpointed center.
    Both runs' centers and per-step losses against the reference's, and
    the reference test's own acceptance (accuracy above 0.85, commits)."""
    pytest.importorskip("grpc")
    _round_robin(monkeypatch, 2)
    ref_model, port, start = mlp_pair
    x, y = _toy()
    kwargs = dict(worker_optimizer="adagrad", learning_rate=0.1, num_workers=2,
                  devices_per_worker=2, batch_size=8, communication_window=3,
                  transport="grpc", compress_deltas=True)
    out = {}
    for pkg, model, extra in ((ref, ref_model, {}), (dk, port, {"device": ["cpu"] * 4})):
        ck = str(tmp_path / pkg.__name__)
        first = pkg.ADAG(model, num_epoch=4, checkpoint_dir=ck, **kwargs, **extra)
        trained = first.train(pkg.Dataset.from_arrays(features=x, label=y))
        again = pkg.ADAG(model, num_epoch=1, checkpoint_dir=ck, resume=True, **kwargs, **extra)
        resumed = again.train(pkg.Dataset.from_arrays(features=x, label=y))
        out[pkg] = (first, trained, again, resumed)
    (rf, rt, ra, rr), (pf, pt, pa, pr) = out[ref], out[dk]
    for a, b in ((pf, rf), (pa, ra)):
        assert a.parameter_server.num_commits == b.parameter_server.num_commits > 0
        _assert_histories(a.history, b.history)
    _assert_center(pt.variables, _bridge(rt.params), start=start)
    _assert_center(pr.variables, _bridge(rr.params))
    preds = dk.ModelPredictor(pt, device="cpu").predict(
        dk.Dataset.from_arrays(features=x))["prediction"]
    assert float(np.mean(np.argmax(np.asarray(preds), -1) == y)) > 0.85


@pytest.mark.parametrize("pkg", [ref, dk], ids=["reference", "port"])
def test_too_few_devices_raise_the_reference_message(mlp_pair, pkg):
    """2 workers x 8 devices over the 8 devices there are (the reference's
    virtual devices; the port's list of 8)."""
    ref_model, port, _ = mlp_pair
    x, y = _toy(32)
    model, extra = (ref_model, {}) if pkg is ref else (port, {"device": ["cpu"] * 8})
    tr = pkg.ADAG(model, num_workers=2, devices_per_worker=8, **extra)
    with pytest.raises(ValueError, match=r"2 workers x 8 devices_per_worker > 8 attached "
                                         r"devices"):
        tr.train(pkg.Dataset.from_arrays(features=x, label=y))


def test_a_failing_replica_breaks_the_island_barrier():
    """A replica that fails aborts the group: the other replica's wait
    raises instead of hanging."""
    group = IslandGroup(2)
    member = group.member(0)
    group.abort()
    with pytest.raises(threading.BrokenBarrierError):
        member.sum(torch.ones(3))


def test_island_sums_are_equal_on_every_replica():
    """Three replicas' sums, each added in rank order on its own thread,
    are the same bits on every replica, and the gathered stack is in rank
    order."""
    group = IslandGroup(3)
    xs = [torch.randn(1000, generator=torch.Generator().manual_seed(r)) for r in range(3)]
    out = [None] * 3

    def run(r):
        m = group.member(r)
        out[r] = (m.sum(xs[r]), m.gather(xs[r]))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for total, stacked in out:
        assert torch.equal(total, out[0][0])
        assert torch.equal(stacked, torch.stack(xs))
    assert torch.equal(out[0][0], (xs[0] + xs[1]) + xs[2])

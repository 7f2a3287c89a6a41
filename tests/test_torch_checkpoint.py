"""Weight files, provenance and step checkpoints against the reference.

- The serializer writes the reference's npz member for member: the same
  seeded tree (bfloat16 leaf included) gives byte-identical ``leaf_i`` and
  ``__treedef__`` members in both packages, and each package reads the
  other's bytes bit for bit (tolerance 0).
- A weight file saved by either package loads in the other bitwise, dtypes
  included, and each reads the other's stamp (version, digest, saved_at).
- The reference's provenance cases (``tests/test_provenance.py:50-113``)
  and checkpoint cases (``tests/test_checkpoint.py``) that need no serving
  and no orbax, on the port's own step layout.
- A synchronous run resumed from a checkpoint equals the uninterrupted run
  bitwise on the CPU; an async run resumed from one starts its PS from the
  saved center bitwise.
"""

import io
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as ref
import distkeras_tpu_torch as dk
from distkeras_tpu.checkpoint import load_weights_file as ref_load_weights_file
from distkeras_tpu.checkpoint import load_weights_meta as ref_load_weights_meta
from distkeras_tpu.checkpoint import save_weights_file as ref_save_weights_file
from distkeras_tpu.checkpoint import weights_provenance as ref_weights_provenance
from distkeras_tpu.models.core import Model as RefModel
from distkeras_tpu.models.mlp import MLP as RefMLP
from distkeras_tpu.utils.pytree import deserialize_pytree as ref_deserialize
from distkeras_tpu.utils.pytree import serialize_pytree as ref_serialize
from distkeras_tpu_torch.checkpoint import (
    CheckpointManager,
    load_weights_file,
    load_weights_file_with_provenance,
    load_weights_meta,
    publish_weights,
    read_manifest,
    save_weights_file,
    weights_digest,
    weights_provenance,
)
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.ops.losses import get_optimizer
from distkeras_tpu_torch.training.step import TrainState, make_train_step
from distkeras_tpu_torch.training.trainers import _StepCheckpointer
from distkeras_tpu_torch.utils.bridge import params_from_jax
from distkeras_tpu_torch.utils.pytree import deserialize_pytree, serialize_pytree
from torch_time_limit import time_limited

D = 8


def _trees(seed=0):
    """The same tree in the reference's leaves (numpy, ml_dtypes bfloat16)
    and the port's (tensors, a number)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    k = rng.integers(-9, 9, size=(3,)).astype(np.int32)
    b16 = np.asarray(jnp.asarray(b, jnp.bfloat16))
    ref_tree = {"params": {"w": w, "b": b16, "inner": {"k": k}}, "seq": [w, np.float32(2.5)],
                "n": np.asarray(7)}
    port_tree = {"params": {"w": torch.from_numpy(w), "b": torch.from_numpy(b).bfloat16(),
                            "inner": {"k": torch.from_numpy(k)}},
                 "seq": [torch.from_numpy(w), np.float32(2.5)], "n": 7}
    return ref_tree, port_tree


def _members(data: bytes) -> dict:
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        return {n: z.read(n) for n in z.namelist()}


def _bits(x) -> np.ndarray:
    """A leaf of either package as comparable bits (bfloat16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_same_leaves(port_tree, ref_tree):
    got = jax.tree_util.tree_leaves_with_path(port_tree)
    want = jax.tree_util.tree_leaves_with_path(ref_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_serializer_writes_the_reference_members():
    ref_tree, port_tree = _trees()
    want, got = _members(ref_serialize(ref_tree)), _members(serialize_pytree(port_tree))
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    # Deterministic: the same tree gives the same bytes.
    assert serialize_pytree(port_tree) == serialize_pytree(port_tree)


def test_serializer_reads_across_packages():
    ref_tree, port_tree = _trees(1)
    back = deserialize_pytree(ref_serialize(ref_tree))
    assert back["params"]["b"].dtype == torch.bfloat16
    assert isinstance(back["seq"], list) and len(back["seq"]) == 2
    _assert_same_leaves(back, ref_tree)
    _assert_same_leaves(ref_deserialize(serialize_pytree(port_tree)), ref_tree)


def test_deserialize_like_and_rebuild():
    _, port_tree = _trees(2)
    data = serialize_pytree(port_tree)
    like = {"seq": (0, 0, 0), "params": {"inner": {"k": 0}, "w": 0, "b": 0}, "n": 0}
    with pytest.raises(ValueError, match="7 leaves"):  # one leaf more than the file's
        deserialize_pytree(data, like=like)
    like["seq"] = (None, 0, 0)  # None is an empty node, as in jax
    got = deserialize_pytree(data, like=like)
    assert list(got) == ["seq", "params", "n"] and got["seq"][0] is None
    assert torch.equal(got["params"]["w"], port_tree["params"]["w"])
    assert got["params"]["b"].dtype == torch.bfloat16
    # Digit keys of a dict stay a dict; a list comes back a list.
    tree = {"layers": [{"0": torch.ones(1)}, {"1": torch.zeros(2)}], "bare": {}}
    back = deserialize_pytree(serialize_pytree(tree))
    assert isinstance(back["layers"], list) and list(back["layers"][1]) == ["1"]
    assert torch.equal(deserialize_pytree(serialize_pytree(torch.arange(3))), torch.arange(3))


@pytest.fixture(scope="module")
def mlp_pair():
    ref_model = RefModel.from_flax(RefMLP(features=(16,), num_classes=4,
                                          compute_dtype=jnp.float32), input_shape=(D,))
    variables = jax.tree.map(np.asarray, ref_model.init(0))
    port_model = Model(lambda: MLP(D, (16,), 4, compute_dtype=torch.float32), input_shape=(D,),
                       output_dim=4)
    return ref_model, variables, port_model


@time_limited
def test_weight_files_cross_both_ways(tmp_path, mlp_pair):
    ref_model, variables, port_model = mlp_pair
    # Port writes, reference reads: the same leaves bit for bit and the stamp.
    port_path = str(tmp_path / "port.npz")
    TrainedModel(port_model, params_from_jax(variables, device="cpu")).save_weights(port_path)
    _assert_same_leaves(ref_load_weights_file(port_path), variables)
    stamp = ref_load_weights_meta(port_path)
    assert stamp["version"] == 1 and stamp["saved_at"] > 0
    assert ref_weights_provenance(port_path)["digest"] == weights_provenance(port_path)["digest"]
    assert stamp["digest"] == load_weights_meta(port_path)["digest"]
    # Reference writes, port reads.
    ref_path = str(tmp_path / "ref.npz")
    ref_save_weights_file(ref_path, variables, meta={"step": 12})
    trained = TrainedModel(port_model, port_model.init(0, device="cpu"))
    trained.load_weights(ref_path)
    want = params_from_jax(variables, device="cpu")
    assert trained.variables.keys() == want.keys()
    for k in want:
        assert trained.variables[k].dtype == want[k].dtype and torch.equal(trained.variables[k],
                                                                            want[k]), k
    mine = load_weights_meta(ref_path)
    assert mine == ref_load_weights_meta(ref_path) and mine["step"] == 12
    assert weights_provenance(ref_path)["version"] == 1


def test_bf16_weight_files_cross_both_ways(tmp_path):
    ref_tree, port_tree = _trees(3)
    save_weights_file(str(tmp_path / "p.npz"), port_tree, version=5)
    _assert_same_leaves(ref_load_weights_file(str(tmp_path / "p.npz")), ref_tree)
    assert ref_load_weights_meta(str(tmp_path / "p.npz"))["version"] == 5
    ref_save_weights_file(str(tmp_path / "r.npz"), ref_tree)
    back, prov = load_weights_file_with_provenance(str(tmp_path / "r.npz"))
    _assert_same_leaves(back, ref_tree)
    assert prov == {**ref_weights_provenance(str(tmp_path / "r.npz"))}
    # The stamp's digest is the digest of the tree's bytes in both packages.
    assert load_weights_meta(str(tmp_path / "p.npz"))["digest"] == weights_digest(
        serialize_pytree(port_tree))


# -- the reference's provenance cases (tests/test_provenance.py:50-113) ------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))}}


def test_save_weights_file_stamps_monotonic_version_and_digest(tmp_path):
    path = str(tmp_path / "w.npz")
    save_weights_file(path, _tree(0))
    m1 = load_weights_meta(path)
    assert m1["version"] == 1 and len(m1["digest"]) == 16 and m1["saved_at"] > 0
    save_weights_file(path, _tree(0))
    m2 = load_weights_meta(path)
    assert m2["version"] == 2 and m2["digest"] == m1["digest"]
    save_weights_file(path, _tree(1))
    m3 = load_weights_meta(path)
    assert m3["version"] == 3 and m3["digest"] != m1["digest"]
    tree = load_weights_file(path)
    assert torch.equal(tree["params"]["w"], _tree(1)["params"]["w"])
    loaded, prov = load_weights_file_with_provenance(path)
    assert prov["version"] == 3 and prov["digest"] == m3["digest"]
    assert prov["path"] == os.path.abspath(path)
    assert torch.equal(loaded["params"]["w"], _tree(1)["params"]["w"])
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


def test_legacy_unstamped_file_gets_the_same_digest(tmp_path):
    tree = _tree(2)
    data = serialize_pytree(tree)
    legacy = tmp_path / "legacy.npz"
    legacy.write_bytes(data)
    assert load_weights_meta(str(legacy)) is None
    prov = weights_provenance(str(legacy))
    assert prov["version"] == 0 and prov["digest"] == weights_digest(data)
    assert ref_weights_provenance(str(legacy))["digest"] == prov["digest"]
    stamped = str(tmp_path / "stamped.npz")
    save_weights_file(stamped, tree)
    assert load_weights_meta(stamped)["digest"] == prov["digest"]


def test_explicit_version_and_meta_ride_the_stamp(tmp_path):
    path = str(tmp_path / "w.npz")
    save_weights_file(path, _tree(0), version=41, meta={"step": 1000})
    m = load_weights_meta(path)
    assert m["version"] == 41 and m["step"] == 1000
    ref_save_weights_file(path, jax.tree.map(np.asarray, _tree(0)))  # monotonic across packages
    assert load_weights_meta(path)["version"] == 42
    save_weights_file(path, _tree(0))
    assert ref_load_weights_meta(path)["version"] == 43


def test_trained_model_save_weights_is_stamped(tmp_path, mlp_pair):
    _, _, port_model = mlp_pair
    path = str(tmp_path / "trained.npz")
    TrainedModel(port_model, port_model.init(0, device="cpu")).save_weights(path)
    assert load_weights_meta(path)["version"] == 1


def test_publish_directory(tmp_path):
    d = str(tmp_path / "pub")
    assert read_manifest(d) is None
    for i in range(4):
        manifest = publish_weights(d, _tree(i), meta={"step": i}, keep=2)
    assert manifest["version"] == 4 and manifest["step"] == 3
    assert read_manifest(d)["path"] == manifest["path"] == os.path.join(d, "weights-v00000004.npz")
    assert sorted(n for n in os.listdir(d) if n.endswith(".npz")) == [
        "weights-v00000003.npz", "weights-v00000004.npz"]
    assert weights_provenance(manifest["path"])["digest"] == manifest["digest"]
    with pytest.raises(ValueError, match="keep"):
        publish_weights(d, _tree(0), keep=1)


# -- the reference's checkpoint cases (tests/test_checkpoint.py) --------------

def _state(seed=0):
    model = Model(lambda: MLP(4, (8,), 2, compute_dtype=torch.float32), input_shape=(4,))
    return model, TrainState.create(model, get_optimizer("adam", 1e-2), seed, "cpu")


def _batch():
    rng = np.random.default_rng(0)
    return {"features": torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32)),
            "label": torch.from_numpy((rng.normal(size=(16,)) > 0).astype(np.float32))}


@time_limited
def test_save_restore_roundtrip(tmp_path):
    model, state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(0, state=state, meta={"note": "t"})
    assert mgr.latest_step() == 0
    _, fresh = _state(seed=5)
    restored = mgr.restore(0, like={"state": fresh})
    assert restored["state"] is fresh and restored["meta"] == {"note": "t"}
    for k in state.params:
        assert torch.equal(fresh.params[k], state.params[k])
    # As orbax's manager: a step at or below the latest is skipped.
    assert mgr.save(0, state=state) is False and mgr.all_steps() == [0]
    mgr.close()


@time_limited
def test_resume_continues_training(tmp_path):
    """Restored into a fresh state, the optimizer's moments and step land
    in the optimizer's own tensors, and the next step equals the
    uninterrupted one bitwise."""
    model, state = _state()
    step_fn = make_train_step(model, "categorical_crossentropy")
    batch = _batch()
    for _ in range(3):
        state, _ = step_fn(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state=state, ps_center=state.params, ps_num_updates=7)
    _, fresh = _state(seed=9)
    fresh_params = list(fresh.params.values())
    restored = mgr.restore(3, like={"state": fresh, "ps": {"center": dict(state.params),
                                                           "num_updates": 0}})
    assert restored["state"].step == 3 and restored["ps"]["num_updates"] == 7
    assert all(p is q for p, q in zip(fresh_params, fresh.optimizer.param_groups[0]["params"]))
    assert all(a is b for a, b in zip(fresh_params, fresh.params.values()))
    for k in state.params:
        assert torch.equal(restored["ps"]["center"][k], state.params[k].detach())
    cont, _ = step_fn(restored["state"], batch)
    direct, _ = step_fn(state, batch)
    for k in direct.params:
        assert torch.equal(cont.params[k], direct.params[k]), k
    raw = mgr.restore(3)
    # The MLP has no buffers: an empty model_state has no leaves to store.
    assert set(raw["state"]) == {"params", "opt_state", "step", "seed"}
    assert int(raw["state"]["step"]) == 3
    mgr.close()


def test_max_to_keep(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (0, 1, 2, 3):
        mgr.save(s, state=state)
    assert mgr.latest_step() == 3 and mgr.all_steps() == [2, 3]
    mgr.close()


@time_limited
def test_background_save_counts_as_latest(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(4, state=state, wait=False)
    assert mgr.latest_step() == 4  # in flight or written, it is the latest
    mgr.wait_until_finished()
    assert os.path.isdir(tmp_path / "ckpt" / "4")
    assert not [n for n in os.listdir(tmp_path / "ckpt") if n.startswith(".tmp")]
    mgr.close()


@time_limited
def test_finalize_after_interval_save_same_step(tmp_path):
    """A zero interval makes maybe_save save the final step just before
    finalize sees it; finalize waits for that write instead of saving again."""
    _, state = _state()
    ck = _StepCheckpointer(str(tmp_path / "ck"), 0.0, False, like=state)
    for step in (1, 2, 3):
        ck.maybe_save(step, state)
    ck.finalize(3, state)
    ck.close()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() == 3
    mgr.close()


# -- trainers -----------------------------------------------------------------

def _toy(n=256):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = rng.integers(0, 4, size=(n,)).astype(np.int32)
    return dk.Dataset.from_arrays(features=x, label=y)


def _mlp():
    return Model(lambda: MLP(D, (16,), 4, compute_dtype=torch.float32), input_shape=(D,),
                 output_dim=4)


@time_limited
def test_sync_trainer_resume_matches_uninterrupted(tmp_path):
    """The reference's A/B/C case: A runs 2 epochs, B 1 epoch with
    checkpoints, C resumes B for 2 epochs and lands on A bitwise."""
    ds = _toy()
    kwargs = dict(worker_optimizer="adam", learning_rate=1e-2, batch_size=8, seed=0,
                  device="cpu")
    a = dk.SynchronousDistributedTrainer(_mlp(), num_epoch=2, **kwargs)
    trained_a = a.train(ds, shuffle=True)
    ck = str(tmp_path / "sync_ck")
    b = dk.SynchronousDistributedTrainer(_mlp(), num_epoch=1, checkpoint_dir=ck, **kwargs)
    b.train(ds, shuffle=True)
    c = dk.SynchronousDistributedTrainer(_mlp(), num_epoch=2, checkpoint_dir=ck, resume=True,
                                         **kwargs)
    trained_c = c.train(ds, shuffle=True)
    assert len(c.history) == len(a.history) - len(b.history) == 32
    assert c.history == a.history[len(b.history):]
    for k in trained_a.variables:
        assert torch.equal(trained_c.variables[k], trained_a.variables[k]), k
    assert CheckpointManager(ck).all_steps() == [32, 64]


@time_limited
def test_async_resume_restores_the_center(tmp_path):
    """DynSGD with a short snapshot interval: the snapshots never fail, the
    last checkpoint is the returned center, and a resumed run's PS starts
    from it bitwise (its update count restarts at 0, as the reference's)."""
    ds = _toy()
    ck = str(tmp_path / "async_ck")
    kwargs = dict(worker_optimizer="adam", learning_rate=1e-2, batch_size=8, num_workers=1,
                  communication_window=4, seed=0, device="cpu", checkpoint_dir=ck)
    first = dk.DynSGD(_mlp(), checkpoint_interval_s=0.005, **kwargs)
    trained = first.train(ds)
    ps = first.parameter_server
    assert ps.snapshot_failures == 0 and ps.num_commits == 8
    mgr = CheckpointManager(ck)
    saved = mgr.restore()
    assert mgr.latest_step() == 8 and saved["meta"] == {"weight_version": 8}
    assert saved["ps"]["num_updates"] == ps.num_updates
    for k, v in saved["ps"]["center"].items():
        assert torch.equal(v, trained.variables[k]), k
    second = dk.DynSGD(_mlp(), resume=True, **kwargs)
    started = {}
    service = second.service

    def recording_service(center):
        started.update({k: v.clone() for k, v in center.items()})
        return service(center)

    second.service = recording_service
    second.train(ds)
    for k, v in saved["ps"]["center"].items():
        assert torch.equal(started[k], v), k
    assert CheckpointManager(ck).latest_step() == 8  # the same step: not saved again
    mgr.close()


def test_snapshot_failures_are_counted_not_raised(tmp_path):
    class Broken(CheckpointManager):
        def save(self, *args, **kwargs):
            raise OSError("disk full")

    ps = type("PS", (), {"num_commits": 1, "num_updates": 1, "snapshot_failures": 0,
                         "get_model": lambda self: {}})()
    import threading

    tr = dk.DynSGD(_mlp(), device="cpu", checkpoint_interval_s=0.001)
    stop = threading.Event()
    t = threading.Thread(target=tr._periodic_checkpoint,
                         args=(Broken(str(tmp_path / "b")), ps, stop))
    t.start()
    while ps.snapshot_failures < 3:
        stop.wait(0.001)
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive() and ps.snapshot_failures >= 3


def test_save_center_counts_a_saved_step_zero(tmp_path):
    """A saved step 0 is the latest step: with no commit since, no center
    is pulled from the PS; after a commit the PS's own copy is saved."""
    mgr = CheckpointManager(str(tmp_path / "z"))
    mgr.save(0, ps_center={"w": torch.zeros(3)}, ps_num_updates=0)

    def no_pull(self):
        raise AssertionError("center pulled with no commit since the last save")

    idle = type("PS", (), {"num_commits": 0, "num_updates": 0, "get_model": no_pull})()
    dk.DynSGD._save_center(mgr, idle)
    center = {"w": torch.arange(3.0)}
    busy = type("PS", (), {"num_commits": 1, "num_updates": 2,
                           "get_model": lambda self: center})()
    dk.DynSGD._save_center(mgr, busy)
    saved = mgr.restore()
    assert mgr.latest_step() == 1 and saved["meta"] == {"weight_version": 1}
    assert torch.equal(saved["ps"]["center"]["w"], center["w"])
    assert saved["ps"]["num_updates"] == 2
    mgr.close()


@time_limited
def test_async_train_stops_its_threads_when_it_raises(tmp_path):
    """A failure after the ``ps-checkpoint`` thread started (here in
    partitioning the data) leaves no snapshot thread or PS loop running."""
    import threading

    ds = _toy()

    def broken_partitions(n):
        raise RuntimeError("partitions failed")

    ds.partitions = broken_partitions
    tr = dk.DynSGD(_mlp(), device="cpu", num_workers=1, batch_size=8,
                   checkpoint_dir=str(tmp_path / "r"), checkpoint_interval_s=60.0)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="partitions failed"):
        tr.train(ds)
    assert [t.name for t in set(threading.enumerate()) - before if t.is_alive()] == []


def test_reference_and_port_trainers_share_the_checkpoint_surface():
    for name in ("SynchronousDistributedTrainer", "DynSGD"):
        port = getattr(dk, name)(_mlp(), device="cpu", checkpoint_dir="unused", resume=True)
        want = getattr(ref, name)(RefModel.from_flax(RefMLP(features=(4,), num_classes=2),
                                                     input_shape=(D,)),
                                  checkpoint_dir="unused", resume=True)
        assert (port.checkpoint_dir, port.checkpoint_interval_s, port.resume) == (
            want.checkpoint_dir, want.checkpoint_interval_s, want.resume)

"""The port's meshes and sharding rules against the reference's, on 1, 2, 4
and 8 of the harness's virtual devices (the port's meshes over as many
ranks, ``devices=range(n)``, no process group): axis names, shapes, the
rank at each mesh position, partition specs, and every error message.

A port placement (``Shard(d)``/``Replicate()`` per mesh axis) is held
against the reference's ``NamedSharding`` by what each device holds: the
index range of every tensor dimension on each rank, worked out from the
placements as DTensor shards (mesh axes in order, each splitting the range
the axes before it left), against ``devices_indices_map``.
"""

import jax
import numpy as np
import pytest
from flax import linen as nn
from jax.sharding import NamedSharding as RefNamedSharding

from distkeras_tpu.parallel import mesh as ref_mesh
from distkeras_tpu.parallel import sharding as ref_sharding
from distkeras_tpu_torch.parallel import mesh, sharding

COUNTS = (1, 2, 4, 8)
# (axis sizes, device counts it is built on)
MAKE = [
    (None, COUNTS),
    ({"dp": 1}, (1,)),
    ({"tp": 2}, (2, 4, 8)),
    ({"dp": 2, "tp": 2}, (4, 8)),
    ({"tp": 2, "sp": 2}, (4, 8)),
    ({"pp": 2, "tp": 2, "dp": 2}, (8,)),
    ({"fsdp": 2}, (2, 4, 8)),
    ({"dp": 2, "fsdp": 2, "tp": 2}, (8,)),
    ({"ep": 2, "custom": 2}, (4, 8)),
    ({"tp": 3}, COUNTS),
    ({"dp": 1, "tp": 2}, (4, 8)),
    ({"tp": 4, "pp": 2}, (2, 4)),
]
MAKE_CASES = [(sizes, n) for sizes, ns in MAKE for n in ns]


def _ref_devices(n):
    return jax.devices()[:n]


def _outcome(fn):
    """(result, None) or (None, the ValueError's message)."""
    try:
        return fn(), None
    except ValueError as e:
        return None, str(e)


def _same_mesh(got, want):
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)
    assert got.size == want.devices.size


def _same_outcome(got, want):
    assert got[1] == want[1]
    if want[1] is None:
        _same_mesh(got[0], want[0])


@pytest.mark.parametrize("sizes, n", MAKE_CASES)
def test_make_mesh(sizes, n):
    _same_outcome(_outcome(lambda: mesh.make_mesh(sizes, devices=list(range(n)))),
                  _outcome(lambda: ref_mesh.make_mesh(sizes, devices=_ref_devices(n))))


@pytest.mark.parametrize("num", [None, 1, 2, 4, 8, 9])
def test_best_mesh(num, monkeypatch):
    """Over a process group of 8 ranks, the reference over its 8 devices."""
    monkeypatch.setattr(mesh, "_world_ranks", lambda: list(range(8)))
    _same_outcome(_outcome(lambda: mesh.best_mesh(num)),
                  _outcome(lambda: ref_mesh.best_mesh(num)))


def test_best_mesh_without_a_process_group():
    assert mesh.best_mesh().shape == {"dp": 1}
    assert mesh.make_mesh().devices.tolist() == [0]
    assert mesh.best_mesh().group("dp") is None
    with pytest.raises(ValueError, match="requested 2 devices but only 1 are attached"):
        mesh.best_mesh(2)


@pytest.mark.parametrize("spec", [
    "tp=2", "tp=2,dp=1", " 4 ", "tp=2, pp=2", "", "   ", "tp", "tp=x", "=2", "tp=2,tp=4",
    "tp=0", "tp=-1", "dp=1,custom=3",
])
def test_parse_mesh_shape(spec):
    assert _outcome(lambda: mesh.parse_mesh_shape(spec)) == _outcome(
        lambda: ref_mesh.parse_mesh_shape(spec))


@pytest.mark.parametrize("shape", [
    None, {"tp": 1}, {"tp": 2}, {"tp": 2, "pp": 2}, {"pp": 2, "tp": 1}, {"pp": 2},
    {"tp": 2, "dp": 2}, {"tp": 2, "dp": 1}, {"tp": 3}, {"tp": 16},
])
@pytest.mark.parametrize("n", COUNTS)
def test_serving_mesh(shape, n):
    _same_outcome(_outcome(lambda: mesh.serving_mesh(shape, devices=list(range(n)))),
                  _outcome(lambda: ref_mesh.serving_mesh(shape, devices=_ref_devices(n))))


def test_serving_mesh_with_no_devices():
    assert _outcome(lambda: mesh.serving_mesh(None, devices=[])) == _outcome(
        lambda: ref_mesh.serving_mesh(None, devices=[]))


@pytest.mark.parametrize("sizes, n", [({"tp": 2, "pp": 2}, 4), ({"pp": 4}, 4),
                                      ({"tp": 2}, 2), ({"tp": 4, "pp": 2}, 8)])
def test_pp_stages_and_stage_submesh(sizes, n):
    got = mesh.make_mesh(sizes, devices=list(range(n)))
    want = ref_mesh.make_mesh(sizes, devices=_ref_devices(n))
    assert mesh.pp_stages(got) == ref_mesh.pp_stages(want)
    assert mesh.pp_stages(None) == ref_mesh.pp_stages(None) == 1
    for stage in (-1, 0, 1, 2, 4):
        _same_outcome(_outcome(lambda: mesh.stage_submesh(got, stage)),
                      _outcome(lambda: ref_mesh.stage_submesh(want, stage)))


def _ref_index(sharding, shape, device):
    out = []
    for s, size in zip(sharding.devices_indices_map(shape)[device], shape):
        lo, hi, _ = s.indices(size)
        out.append((lo, hi))
    return out


def _port_index(m, placements, shape, rank):
    coord = dict(zip(m.axis_names, np.argwhere(m.devices == rank)[0]))
    index = [(0, size) for size in shape]
    for axis, placement in zip(m.axis_names, placements):
        if placement.is_shard():
            lo, hi = index[placement.dim]
            step = (hi - lo) // m.shape[axis]
            index[placement.dim] = (lo + int(coord[axis]) * step,
                                    lo + (int(coord[axis]) + 1) * step)
    return index


def _same_placement(got, want, shape):
    """Port NamedSharding against the reference's: the same spec (trailing
    unsharded dimensions aside) and the same index ranges on every device."""
    strip = lambda spec: tuple(spec)[:max([i + 1 for i, e in enumerate(spec) if e] or [0])]
    assert strip(got.spec) == strip(tuple(want.spec))
    placements = got.placements
    assert len(placements) == len(got.mesh.axis_names)
    for device in want.mesh.devices.reshape(-1):
        assert _port_index(got.mesh, placements, shape, device.id) == _ref_index(
            want, shape, device), device


def _meshes(n):
    for sizes, ns in MAKE:
        if n in ns and _outcome(lambda: ref_mesh.make_mesh(sizes, _ref_devices(n)))[1] is None:
            yield (mesh.make_mesh(sizes, devices=list(range(n))),
                   ref_mesh.make_mesh(sizes, devices=_ref_devices(n)))


@pytest.mark.parametrize("n", COUNTS)
def test_shard_batch_spec_and_data_parallel_shardings(n):
    for got_mesh, want_mesh in _meshes(n):
        assert mesh.shard_batch_spec(got_mesh) == tuple(ref_mesh.shard_batch_spec(want_mesh))
        for got, want in zip(mesh.data_parallel_shardings(got_mesh),
                             ref_mesh.data_parallel_shardings(want_mesh)):
            _same_placement(got, want, (8 * n, 3))
        _same_placement(sharding.replicated(got_mesh), ref_sharding.replicated(want_mesh),
                        (4, 2))


OVERRIDES = [None, (("embed", "tp"),), (("batch", "fsdp"), ("mlp", None)),
             (("heads", "sp"), ("custom", "dp"))]
LOGICAL = [("batch", "seq", "embed"), ("embed", "mlp"), ("batch", "seq", "heads", "kv"),
           ("vocab", "embed"), ("expert", "embed", "mlp"), (None, "heads"), ("batch", "embed"),
           ("custom", "mlp")]


@pytest.mark.parametrize("overrides", OVERRIDES)
@pytest.mark.parametrize("n", COUNTS)
def test_logical_axis_rules_and_shardings(n, overrides):
    for got_mesh, want_mesh in _meshes(n):
        rules = sharding.logical_axis_rules(got_mesh, overrides)
        want_rules = ref_sharding.logical_axis_rules(want_mesh, overrides)
        assert rules == want_rules
        for axes in LOGICAL:
            want = RefNamedSharding(want_mesh, nn.logical_to_mesh_axes(axes, want_rules))
            shape = tuple(8 * n for _ in axes)
            _same_placement(sharding.logical_sharding(got_mesh, axes, overrides), want, shape)


def test_logical_sharding_refuses_repeated_axes():
    m = mesh.make_mesh({"tp": 1}, devices=[0])
    want = _outcome(lambda: nn.logical_to_mesh_axes(("embed", "mlp", "embed"), ()))
    assert _outcome(lambda: sharding.logical_sharding(m, ("embed", "mlp", "embed")))[1] == want[1]
    assert sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES


def test_infer_variable_shardings_names_its_item():
    """A split leaf that does not divide names the leaf, its size and the
    config field behind it; a leaf without axes is replicated."""
    m = mesh.make_mesh({"tp": 2}, devices=[0, 1])
    axes = {"w": ("mlp", "embed"), "b": None}.get
    got = sharding.infer_variable_shardings(m, {"w": np.zeros((4, 3)), "b": np.zeros(3)}, axes)
    assert got["w"].spec == ("tp", None) and got["b"].is_replicated
    with pytest.raises(ValueError, match=r"^w: its 'mlp' dimension 0 has size 5 \(mlp_dim\)"):
        sharding.infer_variable_shardings(m, {"w": np.zeros((5, 3))}, axes)


KV_TREE = {
    "cache": {"k": (2, 16, 4, 8), "v": (2, 16, 4, 8), "index": (2,)},
    "prefill": [(1, 16, 6, 8), (1, 16, 2, 8)],
    "pool": (32, 4, 8, 16),
    "pos": (),
}


def _shapes(tree, leaf):
    if isinstance(tree, dict):
        return {k: _shapes(v, leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v, leaf) for v in tree]
    return leaf(tree)


@pytest.mark.parametrize("axis", ["tp", "dp"])
@pytest.mark.parametrize("n", COUNTS)
def test_kv_pytree_shardings(n, axis):
    for sizes in ({"tp": n}, {"tp": n // 2, "pp": 2} if n > 1 else {"tp": 1}):
        got_mesh = mesh.serving_mesh(sizes, devices=list(range(n)))
        want_mesh = ref_mesh.serving_mesh(sizes, devices=_ref_devices(n))
        got = sharding.kv_pytree_shardings(
            got_mesh, _shapes(KV_TREE, lambda s: np.zeros(s, np.float32)), axis=axis)
        want = ref_sharding.kv_pytree_shardings(
            want_mesh, _shapes(KV_TREE, lambda s: jax.ShapeDtypeStruct(s, np.float32)),
            axis=axis)
        flat_got = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(
            x, mesh.NamedSharding))
        flat_want = jax.tree_util.tree_leaves(want)
        flat_shapes = jax.tree_util.tree_leaves(_shapes(KV_TREE, lambda s: [s]),
                                                is_leaf=lambda x: isinstance(x, tuple))
        assert len(flat_got) == len(flat_want) == len(flat_shapes) == 7
        for g, w, shape in zip(flat_got, flat_want, flat_shapes):
            _same_placement(g, w, shape)

"""The port's sequence-parallel attention over gloo ranks on the CPU, against
the reference's on as many of its 8 virtual devices: ``ring_flash_attention``
(the flash kernels' plain versions per hop, against the reference's Pallas
kernels in interpret mode) at p = 2 and 4, non-causal, causal and striped,
in float32 and bfloat16; the dense ``ring_self_attention`` in the same three
layouts; ``ulysses_self_attention`` with dense and with flash local
attention; ``stripe_shard``/``stripe_unshard``; and the reference's
``ValueError``s.

Two spawns for the module (``tests/torch_dp_worker.py``, runner
``sp_attention``), of 2 ranks and of 4, each rank holding its columns of
the whole ``[B, S, H, D]`` inputs; the ranks' outputs and the gradients of
their columns under one cotangent are put back together here and held,
whole, against the reference's output and ``jax.vjp``. The striped cases
take their inputs through the reference's ``stripe_shard`` and compare in
the striped layout.

Tolerances (absolute; outputs O(1), gradients up to ~3), those of
``tests/test_torch_flash_attention.py`` for the flash kernels alone:
float32 2e-5 (summation order: the ring merges the shards' partials in
another order than one kernel sums the whole row); bfloat16 2e-2 for
outputs (P rounded to bfloat16 against different running maxima) and 3e-2
for gradients (the port rounds P for Pᵀ·dO where the reference keeps it in
float32, one bfloat16 ulp of each weight).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops import attention as ref_attention
from distkeras_tpu.ops import ring_flash as ref_ring_flash
from distkeras_tpu.ops import ulysses as ref_ulysses
from distkeras_tpu.ops.pallas.flash_attention import flash_attention as ref_flash_attention
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
from distkeras_tpu_torch.models import bert
from distkeras_tpu_torch.ops import attention, ring_flash, ulysses
from distkeras_tpu_torch.parallel.mesh import make_mesh
from torch_time_limit import time_limited

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
F32_TOL = 2e-5
BF16_TOL = 2e-2
BF16_BWD_TOL = 3e-2
B, S, H, D = 2, 32, 4, 8


def _case(fn, p, mode, dtype="float32"):
    return {"fn": fn, "p": p, "causal": mode != "full", "stripe": mode == "striped",
            "dtype": dtype}


# name -> the case; mode: "full" (non-causal), "causal" or "striped" (causal)
CASES = {}
for _p in (2, 4):
    for _mode in ("full", "causal", "striped"):
        for _dtype in ("float32", "bfloat16"):
            CASES[f"ring_flash-p{_p}-{_mode}-{_dtype}"] = _case("ring_flash", _p, _mode, _dtype)
        CASES[f"ring-p{_p}-{_mode}"] = _case("ring", _p, _mode)
    for _fn in ("ulysses", "ulysses_flash"):
        for _mode in ("full", "causal"):
            CASES[f"{_fn}-p{_p}-{_mode}"] = _case(_fn, _p, _mode)


def _inputs(name: str) -> dict:
    """The whole q, k, v and cotangent of a case, seeded by its name, in
    the layout the function takes (striped through the reference's
    ``stripe_shard``)."""
    c = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = {x: rng.normal(size=(B, S, H, D)).astype(np.float32) for x in ("q", "k", "v", "cot")}
    if c["stripe"]:
        arrays = {x: np.array(ref_ring_flash.stripe_shard(a, c["p"])) for x, a in arrays.items()}
    if c["dtype"] == "bfloat16":  # the values both sides see
        arrays = {x: torch.from_numpy(a).bfloat16().float().numpy() for x, a in arrays.items()}
    return arrays


@time_limited(timeout=300)
def _spawn_ranks(workdir: str, world: int) -> list[dict]:
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, WORKER, workdir, str(r), str(world)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=280)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"result-{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's whole output and q/k/v gradients, from the ranks' columns."""
    out = {}
    for world in (2, 4):
        cases = {name: {**c, **_inputs(name)} for name, c in CASES.items() if c["p"] == world}
        workdir = str(tmp_path_factory.mktemp(f"sp{world}"))
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump({"attention": {"kind": "sp_attention", "cases": cases}}, f)
        ranks = _spawn_ranks(workdir, world)
        for name in cases:
            parts = [r["attention"][name] for r in ranks]
            out[name] = (np.concatenate([p["out"] for p in parts], axis=1),
                         [np.concatenate([p["grads"][i] for p in parts], axis=1)
                          for i in range(3)])
    return out


def _reference(name: str):
    """The reference's output and ``jax.vjp`` gradients on a mesh of p of its
    virtual devices."""
    c = CASES[name]
    a = _inputs(name)
    dtype = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
    mesh = ref_make_mesh({"sp": c["p"]}, devices=jax.devices()[:c["p"]])
    kwargs = {"stripe": True} if c["stripe"] else {}
    fn = {"ring_flash": ref_ring_flash.ring_flash_attention,
          "ring": ref_attention.ring_self_attention,
          "ulysses": ref_ulysses.ulysses_self_attention,
          "ulysses_flash": lambda *x, **kw: ref_ulysses.ulysses_self_attention(
              *x, attn_fn=ref_flash_attention, **kw)}[c["fn"]]

    @jax.jit
    def run(q, k, v, cot):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, seq_axis="sp",
                                              causal=c["causal"], **kwargs), q, k, v)
        return out, vjp(cot)

    out, grads = run(*(jnp.asarray(a[x], dtype) for x in ("q", "k", "v", "cot")))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference(runs, name):
    """Output and q/k/v gradients, whole, against the reference's."""
    c = CASES[name]
    got_out, got_grads = runs[name]
    want_out, want_grads = _reference(name)
    bf16 = c["dtype"] == "bfloat16"
    np.testing.assert_allclose(got_out, want_out, atol=BF16_TOL if bf16 else F32_TOL, rtol=0)
    for x, got, want in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(got, want, atol=BF16_BWD_TOL if bf16 else F32_TOL, rtol=0,
                                   err_msg=f"d{x}")


@pytest.mark.parametrize("shape, p, axis", [((2, 12, 3), 4, 1), ((2, 12, 3), 3, 1),
                                            ((3, 8), 2, 1), ((2, 4, 6, 2), 6, 2)])
def test_stripe_shard_equals_the_reference(shape, p, axis):
    """stripe_shard and stripe_unshard bit for bit against the reference's,
    on numpy arrays and torch tensors; not divisible raises its message."""
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = np.asarray(ref_ring_flash.stripe_shard(x, p, axis))
    np.testing.assert_array_equal(ring_flash.stripe_shard(x, p, axis), want)
    np.testing.assert_array_equal(ring_flash.stripe_shard(torch.from_numpy(x), p, axis).numpy(),
                                  want)
    np.testing.assert_array_equal(ring_flash.stripe_unshard(want, p, axis),
                                  np.asarray(ref_ring_flash.stripe_unshard(want, p, axis)))
    np.testing.assert_array_equal(ring_flash.stripe_unshard(want, p, axis), x)
    with pytest.raises(ValueError, match="not divisible by 5 stripes"):
        ring_flash.stripe_shard(x, 5, axis)


def test_hop_modes_are_the_references():
    """The contiguous ring's three cases and the striped ring's two, as the
    reference's ``hop_mode`` picks them."""
    modes = {(src, my): ring_flash.hop_mode(src, my, True) for src in range(4) for my in range(4)}
    assert all(m == (ring_flash.CAUSAL if s == my else ring_flash.FULL if s < my
                     else ring_flash.SKIP) for (s, my), m in modes.items())
    assert {ring_flash.hop_mode(s, my, True, stripe=True) for s in range(4) for my in range(s)} \
        == {ring_flash.STRICT}
    assert {ring_flash.hop_mode(s, my, False) for s in range(4) for my in range(4)} \
        == {ring_flash.FULL}


def test_value_errors_are_the_references():
    """The reference's refusals, message for message, before any process
    group is needed (tests/test_ring_flash.py:198-230, tests/test_ulysses.py:54)."""
    q = torch.zeros(1, 4, 3, 4)
    mesh = make_mesh({"sp": 2}, devices=[0, 1])
    ref_mesh = ref_make_mesh({"sp": 2}, devices=jax.devices()[:2])
    qj = np.zeros((1, 8, 3, 4), np.float32)
    for port, ref in (
        (lambda: ring_flash.ring_flash_attention(q, q, q, mesh, causal=False, stripe=True),
         lambda: ref_ring_flash.ring_flash_attention(qj, qj, qj, ref_mesh, causal=False,
                                                     stripe=True)),
        (lambda: attention.ring_attention(q, q, q, None, causal=False, stripe=True),
         lambda: ref_attention.ring_attention(qj, qj, qj, axis_name="sp", causal=False,
                                              stripe=True)),
        (lambda: attention.ring_self_attention(q, q, q, mesh, causal=False, stripe=True),
         lambda: ref_attention.ring_self_attention(qj, qj, qj, ref_mesh, causal=False,
                                                   stripe=True)),
        (lambda: ulysses.ulysses_self_attention(q, q, q, mesh),
         lambda: ref_ulysses.ulysses_self_attention(qj, qj, qj, ref_mesh)),
    ):
        with pytest.raises(ValueError) as want:
            ref()
        with pytest.raises(ValueError) as got:
            port()
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sp_impl, causal, match", [
    ("ring_stripe", False, "sp_impl='ring_stripe' is causal-only"),
    ("zigzag", True, "unknown sp_impl 'zigzag'"),
])
def test_model_refusals(sp_impl, causal, match):
    """The bert family's sequence-parallel dispatch refuses what the
    reference's does (reference ``bert.py:262-280``)."""
    cfg = bert.BertConfig(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2, mlp_dim=32,
                          max_seq_len=8, dtype=torch.float32, causal=causal,
                          ring_mesh=make_mesh({"sp": 1}, devices=[0]), sp_impl=sp_impl)
    model = bert._make(cfg, 8, "refused")
    with pytest.raises(ValueError, match=match):
        model.apply(model.init(0, device="cpu"), torch.zeros(1, 8, dtype=torch.long))


def test_an_sp_mesh_needs_a_process_group():
    """Above one rank the ring needs a process group over the mesh's ranks;
    at one rank it needs none and is the flash kernel with an exact merge."""
    q = torch.randn(1, 4, 2, 8)
    with pytest.raises(RuntimeError, match="needs a process group"):
        ring_flash.ring_flash_attention(q, q, q, make_mesh({"sp": 2}, devices=[0, 1]))
    from distkeras_tpu_torch.ops.flash_attention import flash_attention

    one = ring_flash.ring_flash_attention(q, q, q, make_mesh({"sp": 1}, devices=[0]),
                                          causal=True)
    assert torch.equal(one, flash_attention(q, q, q, causal=True))

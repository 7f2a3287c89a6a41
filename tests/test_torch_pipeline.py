"""The port's pipeline engines against the reference's, over gloo ranks on the
CPU: ``parallel/pipeline.py`` (GPipe and interleaved virtual stages,
``pipeline_apply``) and ``parallel/pipeline_1f1b.py``
(``pipeline_1f1b_value_and_grad``), against ``distkeras_tpu.parallel.pipeline``
and ``pipeline_1f1b`` on as many of its 8 virtual devices, under
``jax.jit`` of their vjp.

Two spawns for the module (``tests/torch_dp_worker.py``, runner
``pp_engine``): 2 ranks, then 4. The stages are ``tanh(x @ w + b)`` on
8 features; the 1F1B last stage adds a linear head and a squared-error loss.
Each rank takes its chunks of the same logical stages (``rank_stages``) and
its dp slice of the same microbatches; the outputs, the stage gradients
(summed over dp slices: ``pipeline_apply`` returns a slice's share), the
microbatches' gradients, and 1F1B's loss, aux, head gradients and
``cot_out`` are held against the reference's in float32 to 2e-6 absolute
(every value O(1); float32 summation order over a few microbatches).
The 1F1B case with dropout is held against one plain autograd pass with the
same per-(microbatch, stage) seeds: 1e-6. The 1F1B MoE cases
(``stage_aux_seed``) give every stage the differentiated aux ``mean(y²)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from distkeras_tpu.parallel import pipeline as ref_pipeline
from distkeras_tpu.parallel import pipeline_1f1b as ref_1f1b
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
from distkeras_tpu_torch.parallel import pipeline, pipeline_1f1b
from distkeras_tpu_torch.parallel.mesh import make_mesh
from distkeras_tpu_torch.utils.rng import fold_in
from torch_dp_worker import pp_last, pp_stage, spawn_ranks
from torch_time_limit import time_limited

ATOL = 2e-6
PLAIN_ATOL = 1e-6
D, ROWS = 8, 4

# name -> (engine, mesh, V, M, extra)
TWO = {
    "gpipe_p2_m3": ("gpipe", {"pp": 2}, 1, 3, {}),
    "inter_p2_v2_m2": ("gpipe", {"pp": 2}, 2, 2, {}),
    "inter_p2_v4_m6": ("gpipe", {"pp": 2}, 4, 6, {}),
    "aux_p2_v2_m3": ("gpipe", {"pp": 2}, 2, 3, {"aux_cot": 0.7}),
    "1f1b_p2_m3": ("1f1b", {"pp": 2}, 1, 3, {"with_aux": True}),
    "1f1b_p2_dropout": ("1f1b", {"pp": 2}, 1, 3, {"rng": 11}),
    "1f1b_moe_p2_m3": ("1f1b", {"pp": 2}, 1, 3, {"with_aux": True, "moe_seed": 0.3}),
}
FOUR = {
    "gpipe_p4_m4": ("gpipe", {"pp": 4}, 1, 4, {}),
    "gpipe_p4_m8": ("gpipe", {"pp": 4}, 1, 8, {}),
    "inter_p4_v2_m5": ("gpipe", {"pp": 4}, 2, 5, {}),
    "1f1b_p4_m1": ("1f1b", {"pp": 4}, 1, 1, {}),
    "1f1b_p4_m2": ("1f1b", {"pp": 4}, 1, 2, {"with_aux": True}),
    "1f1b_p4_m4": ("1f1b", {"pp": 4}, 1, 4, {}),
    "1f1b_p4_m6": ("1f1b", {"pp": 4}, 1, 6, {"with_aux": True}),
    "gpipe_dp2_pp2": ("gpipe", {"dp": 2, "pp": 2}, 1, 4, {}),
    "inter_dp2_pp2": ("gpipe", {"dp": 2, "pp": 2}, 2, 3, {"aux_cot": -0.4}),
    "1f1b_dp2_pp2": ("1f1b", {"dp": 2, "pp": 2}, 1, 3, {"with_aux": True}),
    "1f1b_moe_p4_m5": ("1f1b", {"pp": 4}, 1, 5, {"with_aux": True, "moe_seed": 0.5}),
    "1f1b_moe_dp2_pp2": ("1f1b", {"dp": 2, "pp": 2}, 1, 3, {"moe_seed": -0.2}),
}
ALL = {**TWO, **FOUR}
# Each case's data seed: its place among the sorted names of the cases
# without MoE, then the MoE cases in order (a new case moves no other's data).
_MOE = [k for k, v in ALL.items() if "moe_seed" in v[4]]
_SEEDS = {n: i for i, n in enumerate(sorted(set(ALL) - set(_MOE)) + _MOE)}


def _case(name) -> dict:
    engine, mesh, V, M, extra = ALL[name]
    P, dp = mesh["pp"], mesh.get("dp", 1)
    g = np.random.default_rng(_SEEDS[name])
    f32 = np.float32
    c = {"engine": engine, "mesh": mesh, "V": V,
         "w": (g.normal(size=(V * P, D, D)) / np.sqrt(D)).astype(f32),
         "b": (0.1 * g.normal(size=(V * P, D))).astype(f32),
         "mb": g.normal(size=(M, ROWS * dp, D)).astype(f32), **extra}
    if engine == "gpipe":
        c["cot"] = g.normal(size=c["mb"].shape).astype(f32)
    else:
        c["hw"] = (g.normal(size=(D, 3)) / np.sqrt(D)).astype(f32)
        c["hb"] = (0.1 * g.normal(size=3)).astype(f32)
        c["labels"] = g.normal(size=(M, ROWS * dp, 3)).astype(f32)
        c.setdefault("with_aux", False)
    return c


@time_limited(timeout=300)
def _spawn(workdir, world, names):
    return spawn_ranks(workdir, world, {"engines": {"kind": "pp_engine", "cases": {
        n: _case(n) for n in names}}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {2: _spawn(str(tmp_path_factory.mktemp("pp2")), 2, TWO),
            4: _spawn(str(tmp_path_factory.mktemp("pp4")), 4, FOUR)}


def _ranks(runs, name):
    world = 2 if name in TWO else 4
    return [r["engines"][name] for r in runs[world]]


def _ref_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return ref_make_mesh(axes, devices=jax.devices()[:n])


def _ref_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _ref_gpipe(c):
    """The reference's outputs, aux, stacked-stage and microbatch gradients."""
    mesh, V = _ref_mesh(c["mesh"]), c["V"]
    stacked = ref_pipeline.stack_stage_params(
        [{"w": w, "b": b} for w, b in zip(c["w"], c["b"])], virtual_stages=V)
    aux = c.get("aux_cot") is not None

    def stage(p, x):
        y = _ref_stage(p, x)
        return (y, jnp.mean(y * y)) if aux else y

    def f(sp, mb):
        return ref_pipeline.pipeline_apply(stage, sp, mb, mesh, virtual_stages=V, with_aux=aux)

    @jax.jit
    def run(sp, mb, cot):
        out, vjp = jax.vjp(f, sp, mb)
        g_sp, g_mb = vjp((cot, jnp.float32(c["aux_cot"])) if aux else cot)
        return out, g_sp, g_mb

    out, g_sp, g_mb = run(stacked, c["mb"], c["cot"])
    y, a = out if aux else (out, None)
    return np.asarray(y), a, jax.tree.map(np.asarray, g_sp), np.asarray(g_mb)


def _ref_1f1b(c):
    """The reference's (values, stacked stage grads, head grads, cot_out)."""
    mesh = _ref_mesh(c["mesh"])
    stacked = ref_pipeline.stack_stage_params([{"w": w, "b": b} for w, b in zip(c["w"], c["b"])])
    head = {"w": c["hw"], "b": c["hb"]}

    moe = c.get("moe_seed") is not None

    def stage(p, x):
        y = _ref_stage(p, x)
        return (y, jnp.mean(y * y)) if moe else y

    def last(p, hp, x, yl):
        y = _ref_stage(p, x)
        loss = jnp.mean((y @ hp["w"] + hp["b"] - yl) ** 2)
        out = (loss,) + ((jnp.mean(y * y),) if moe else ()) + (
            (jnp.mean(y),) if c["with_aux"] else ())
        return out if len(out) > 1 else loss

    io = JP(None, "dp") if "dp" in c["mesh"] else JP()
    out = jax.jit(lambda sp, hp, mb, yl: ref_1f1b.pipeline_1f1b_value_and_grad(
        stage, last, sp, hp, mb, yl, mesh, with_aux=c["with_aux"], io_spec=io,
        stage_aux_seed=c.get("moe_seed")))(stacked, head, c["mb"], c["labels"])
    out = jax.tree.map(np.asarray, out)
    *values, g_sp, g_head, cot = out
    return values, g_sp, g_head, cot


def test_every_rank_joined(runs):
    assert [(r["world"], r["rank"]) for r in runs[2]] == [(2, 0), (2, 1)]
    assert [(r["world"], r["rank"]) for r in runs[4]] == [(4, r) for r in range(4)]


@pytest.mark.parametrize("P, V, M", [(p, v, m) for p in (1, 2, 3, 4) for v in (1, 2, 3)
                                     for m in (1, 2, 3, 4, 5, 8)])
def test_tick_algebra_and_layout_match_reference(P, V, M):
    """schedule_ticks, ticks_1f1b, and the round-robin layout: the stacked
    order and each rank's chunks."""
    assert pipeline.schedule_ticks(M, P, V) == ref_pipeline.schedule_ticks(M, P, V)
    assert pipeline_1f1b.ticks_1f1b(M, P) == ref_1f1b.ticks_1f1b(M, P)
    stages = [np.float32(s) for s in range(P * V)]
    want = np.asarray(ref_pipeline.stack_stage_params(stages, virtual_stages=V)).tolist()
    got = pipeline.stack_stage_params([torch.tensor(s) for s in stages], V).tolist()
    assert got == want
    assert [s for d in range(P) for s in pipeline.rank_stages(P, V, d)] == want


def test_tick_maps_cover_every_application_once():
    """The chunk/microbatch maps (reference ``_pipeline_local``): every
    (logical stage, microbatch) pair runs exactly once, a microbatch's
    stages in order, each the tick after the previous one."""
    for P, V, M in [(2, 1, 3), (2, 2, 2), (2, 4, 6), (4, 2, 5), (3, 3, 7), (1, 3, 4)]:
        ticks = pipeline._Ticks(M, P, V)
        seen = {}
        for t in range(pipeline.schedule_ticks(M, P, V)):
            for d in range(P):
                a = ticks.app(t, d)
                if a is not None:
                    v, m = a
                    assert (v * P + d, m) not in seen
                    seen[(v * P + d, m)] = t
        assert len(seen) == P * V * M
        for m in range(M):
            assert [seen[(s + 1, m)] - seen[(s, m)] for s in range(P * V - 1)] == [1] * (
                P * V - 1)


def test_specs_and_shardings_match_reference():
    stacked = {"w": np.zeros((2, 3)), "b": np.zeros(2)}
    want = ref_pipeline.stage_param_specs(stacked)
    assert {k: tuple(v) for k, v in want.items()} == pipeline.stage_param_specs(stacked)
    for axes in ({"pp": 2}, {"dp": 2, "pp": 2}, {"dp": 1, "pp": 4}):
        n = int(np.prod(list(axes.values())))
        ref = ref_pipeline.pipeline_shardings(_ref_mesh(axes))
        got = pipeline.pipeline_shardings(make_mesh(axes, devices=range(n)))
        assert [tuple(s.spec) for s in ref] == [s.spec for s in got]
    # The ep branch: the expert weights of an MoE stage over ("pp", "ep"),
    # the router and the rest over pp alone; the port's chunks key a
    # layer's leaves by their dotted names.
    moe = {"sub_0": {"moe_mlp": {k: np.zeros(2) for k in ("router", "w_in", "w_out")},
                     "ln_mlp": {"scale": np.zeros(2)}}}
    flat = {"sub_0": {"moe_mlp.router": 0, "moe_mlp.w_in": 0, "moe_mlp.w_out": 0,
                      "ln_mlp.weight": 0}}
    for ep in (1, 2):
        want = {f"{a}.{b}": tuple(s) for a, t in ref_pipeline.stage_param_specs(
            moe, ep)["sub_0"].items() for b, s in t.items()}
        got = pipeline.stage_param_specs(flat, ep)["sub_0"]
        assert got == {k.replace("scale", "weight"): v for k, v in want.items()}
        assert pipeline.stage_param_specs(moe, ep)["sub_0"]["moe_mlp"] == {
            k: tuple(v) for k, v in ref_pipeline.stage_param_specs(moe, ep)["sub_0"][
                "moe_mlp"].items()}


def test_refusals_match_reference_messages():
    """The engines' shape checks raise the reference's messages."""
    mb = np.zeros((2, ROWS, D), np.float32)
    chunk = {"w": np.zeros((D, D), np.float32), "b": np.zeros(D, np.float32)}
    ref_mesh, mesh = _ref_mesh({"pp": 2}), make_mesh({"pp": 2}, devices=[0, 1])
    stacked4 = ref_pipeline.stack_stage_params([chunk] * 4)
    stacked2 = ref_pipeline.stack_stage_params([chunk] * 2)
    t_chunk = {k: torch.tensor(v) for k, v in chunk.items()}
    cases = [
        (lambda: ref_pipeline.pipeline_apply(_ref_stage, stacked4, mb, ref_mesh),
         lambda: pipeline.pipeline_apply(pp_stage, [t_chunk] * 2, torch.tensor(mb), mesh)),
        (lambda: ref_pipeline.pipeline_apply(_ref_stage, stacked2, mb, ref_mesh,
                                             virtual_stages=2),
         lambda: pipeline.pipeline_apply(pp_stage, [t_chunk], torch.tensor(mb), mesh,
                                         virtual_stages=2)),
        (lambda: ref_pipeline.pipeline_apply(_ref_stage, stacked2, mb[:0], ref_mesh),
         lambda: pipeline.pipeline_apply(pp_stage, [t_chunk], torch.tensor(mb[:0]), mesh)),
        (lambda: ref_1f1b.pipeline_1f1b_value_and_grad(
            _ref_stage, None, stacked4, {}, mb, mb, ref_mesh),
         lambda: pipeline_1f1b.pipeline_1f1b_value_and_grad(
             pp_stage, None, [t_chunk] * 2, {}, torch.tensor(mb), torch.tensor(mb), mesh)),
    ]
    for ref_call, port_call in cases:
        with pytest.raises(ValueError) as want:
            ref_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(want.value)


def test_one_rank_pipeline_is_the_stage_sequence():
    """At pp=1 (no process group) the pipe of V chunks is the chunks in
    order, forward and backward (each microbatch on its own: 1e-6, the
    float32 order of the batched products)."""
    g = np.random.default_rng(3)
    chunks = [{"w": torch.tensor(g.normal(size=(D, D)) / 3, dtype=torch.float32,
                                 requires_grad=True),
               "b": torch.zeros(D, requires_grad=True)} for _ in range(3)]
    mb = torch.tensor(g.normal(size=(4, ROWS, D)), dtype=torch.float32, requires_grad=True)
    out = pipeline.pipeline_apply(pp_stage, chunks, mb, make_mesh({"pp": 1}, devices=[0]),
                                  virtual_stages=3)
    out.sum().backward()
    got = [mb.grad.clone()] + [c["w"].grad.clone() for c in chunks]
    for t in [mb] + [c["w"] for c in chunks]:
        t.grad = None
    x = mb
    for c in chunks:
        x = pp_stage(c, x)
    x.sum().backward()
    torch.testing.assert_close(out, x.detach(), rtol=0, atol=PLAIN_ATOL)
    for a, b in zip(got, [mb.grad] + [c["w"].grad for c in chunks]):
        torch.testing.assert_close(a, b, rtol=0, atol=PLAIN_ATOL)


@pytest.mark.parametrize("name", sorted(k for k, v in ALL.items() if v[0] == "gpipe"))
def test_pipeline_apply_matches_reference(runs, name):
    c = _case(name)
    y, aux, g_sp, g_mb = _ref_gpipe(c)
    P, V = c["mesh"]["pp"], c["V"]
    rows = ROWS
    got_w = {}
    for rep in _ranks(runs, name):
        mine = slice(rep["k"] * rows, (rep["k"] + 1) * rows)
        np.testing.assert_allclose(rep["out"], y[:, mine], atol=ATOL, rtol=0)
        if rep["d"] == 0:  # the microbatches are read on the first stage alone
            np.testing.assert_allclose(rep["g_mb"], g_mb[:, mine], atol=ATOL, rtol=0)
        else:
            assert not rep["g_mb"].any()
        if aux is not None:
            assert rep["aux"] == pytest.approx(float(aux), abs=ATOL)
        for v, grads in enumerate(rep["grads"]):
            pos = rep["d"] * V + v  # the stacked layout's position of this chunk
            for k, g in grads.items():
                got_w.setdefault((pos, k), []).append(g)
    for (pos, k), parts in got_w.items():
        np.testing.assert_allclose(np.sum(parts, axis=0), g_sp[k][pos], atol=ATOL, rtol=0,
                                   err_msg=f"{name} {pos} {k}")
    assert len(got_w) == 2 * P * V


@pytest.mark.parametrize("name", sorted(k for k, v in ALL.items()
                                        if v[0] == "1f1b" and "rng" not in v[4]))
def test_1f1b_matches_reference(runs, name):
    c = _case(name)
    values, g_sp, g_head, cot = _ref_1f1b(c)
    for rep in _ranks(runs, name):
        mine = slice(rep["k"] * ROWS, (rep["k"] + 1) * ROWS)
        np.testing.assert_allclose(rep["values"], values, atol=ATOL, rtol=0)
        for k, g in rep["grads"][0].items():
            np.testing.assert_allclose(g, g_sp[k][rep["d"]], atol=ATOL, rtol=0, err_msg=k)
        for k, g in rep["head"].items():
            np.testing.assert_allclose(g, g_head[k], atol=ATOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(rep["cot"], cot[:, mine], atol=ATOL, rtol=0)


def test_1f1b_dropout_equals_one_autograd_pass(runs):
    """With ``rng`` each (microbatch, stage) application draws its masks
    from ``fold_in(fold_in(rng, m), d)``; the 1F1B recompute at the B tick
    draws the same ones, so the engine's loss and gradients equal one
    autograd pass through the same masks."""
    c = _case("1f1b_p2_dropout")
    P, M = c["mesh"]["pp"], c["mb"].shape[0]
    ws = [{"w": torch.tensor(c["w"][d]).requires_grad_(),
           "b": torch.tensor(c["b"][d]).requires_grad_()} for d in range(P)]
    head = {"w": torch.tensor(c["hw"]).requires_grad_(),
            "b": torch.tensor(c["hb"]).requires_grad_()}
    mb = torch.tensor(c["mb"]).requires_grad_()
    loss = 0.0
    for m in range(M):
        x = mb[m]
        for d in range(P - 1):
            x = pp_stage(ws[d], x, fold_in(fold_in(c["rng"], m), d))
        loss = loss + pp_last(ws[-1], head, x, torch.tensor(c["labels"][m]),
                              fold_in(fold_in(c["rng"], m), P - 1))
    loss.backward()
    ranks = _ranks(runs, "1f1b_p2_dropout")
    for rep in ranks:
        assert rep["values"][0] == pytest.approx(loss.item(), abs=PLAIN_ATOL)
        for k, g in rep["grads"][0].items():
            np.testing.assert_allclose(g, ws[rep["d"]][k].grad.numpy(), atol=PLAIN_ATOL,
                                       rtol=0, err_msg=k)
        for k, g in rep["head"].items():
            np.testing.assert_allclose(g, head[k].grad.numpy(), atol=PLAIN_ATOL, rtol=0)
        np.testing.assert_allclose(rep["cot"], mb.grad.numpy(), atol=PLAIN_ATOL, rtol=0)
    # the masks are real: without them the loss differs
    c2 = dict(c, rng=None)
    plain = sum(pp_last(ws[-1], head, pp_stage(ws[0], torch.tensor(c2["mb"][m])),
                        torch.tensor(c["labels"][m])).item() for m in range(M))
    assert abs(plain - loss.item()) > 1e-3


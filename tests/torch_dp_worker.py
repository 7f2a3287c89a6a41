"""One rank of the port's multi-rank (data- and model-parallel) runs on the CPU.

    python tests/torch_dp_worker.py WORKDIR RANK WORLD

``tests/test_torch_data_parallel.py``, ``tests/test_torch_model_parallel.py``,
``tests/test_torch_sequence_parallel.py``, ``tests/test_torch_ring_attention.py``,
``tests/test_torch_pipeline.py``, ``tests/test_torch_pipeline_trainer.py``,
``tests/test_torch_sharded_serving.py``, ``tests/test_torch_pp_serving.py``,
``tests/test_torch_moe_ep.py`` and ``tests/test_torch_moe_tp_sp.py`` start
WORLD of these. They join one gloo process group through a file store in
WORKDIR, read the scenarios' inputs from ``WORKDIR/inputs.pkl``
(weights bridged from the reference's init, and the data), run every
scenario in order and write what each produced to
``WORKDIR/result-RANK.pkl``. The worker imports the port and torch only.
"""

import dataclasses
import os
import pickle
import sys
import traceback

import numpy as np
import torch

import distkeras_tpu_torch as dk
from distkeras_tpu_torch.models import bert
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.models.resnet import resnet18
from distkeras_tpu_torch.parallel import distributed
from distkeras_tpu_torch.parallel.mesh import best_mesh, make_mesh
from distkeras_tpu_torch.telemetry.spans import Tracer, disable_tracing, enable_tracing


def bert_model(cfg: dict) -> Model:
    base = getattr(bert, cfg["name"])(seq_len=cfg["seq"], vocab_size=cfg["vocab"])
    return bert._make(dataclasses.replace(
        base.config, use_flash_attention=True, dtype=torch.float32, dropout_rate=0.0),
        cfg["seq"], cfg["name"])


def mlp_model(cfg: dict) -> Model:
    hidden = tuple(cfg.get("hidden", (32,)))
    return Model(lambda: MLP(cfg["dim"], hidden, 2, compute_dtype=torch.float32),
                 input_shape=(cfg["dim"],), output_dim=2)


def resnet_model(cfg: dict) -> Model:
    return resnet18(cfg["classes"], cfg["size"], dtype=torch.float32)


def sp_model(cfg: dict) -> Model:
    """A small bert-family model whose attention runs over the ``sp`` axis
    of ``make_mesh(cfg["ring_mesh"])`` by ``cfg["sp_impl"]`` (the plain
    model when ``cfg["ring_mesh"]`` is None); flash attention unless
    ``cfg["flash"]`` is False."""
    config = bert.BertConfig(
        vocab_size=cfg["vocab"], hidden_size=cfg["hidden"], num_layers=2,
        num_heads=cfg["heads"], mlp_dim=2 * cfg["hidden"], max_seq_len=cfg["max_seq_len"],
        dropout_rate=0.0, causal=cfg["causal"], dtype=getattr(torch, cfg["dtype"]),
        use_flash_attention=cfg.get("flash", True),
        ring_mesh=make_mesh(cfg["ring_mesh"]) if cfg["ring_mesh"] else None,
        sp_impl=cfg["sp_impl"])
    return bert._make(config, cfg["seq"], "bert_sp")


def pp_model(cfg: dict) -> Model:
    """A small bert-family model of ``cfg``'s widths and depth (flash on,
    dropout ``cfg.get("dropout", 0)``), for the pipeline trainer."""
    config = bert.BertConfig(
        vocab_size=cfg["vocab"], hidden_size=cfg["hidden"], num_layers=cfg["layers"],
        num_heads=cfg["heads"], mlp_dim=2 * cfg["hidden"], max_seq_len=cfg["seq"],
        dropout_rate=cfg.get("dropout", 0.0), dtype=getattr(torch, cfg["dtype"]),
        use_flash_attention=True)
    return bert._make(config, cfg["seq"], "bert_pp")


def moe_model(cfg: dict) -> Model:
    """:func:`pp_model`'s bert-family model with every MLP an MoE block of
    ``cfg["experts"]`` experts, top ``cfg["top_k"]``; causal with
    ``cfg["causal"]``, and with ``cfg["ring_mesh"]`` its attention over the
    ``sp`` axis of ``make_mesh(cfg["ring_mesh"])`` by ``cfg["sp_impl"]``."""
    ring = cfg.get("ring_mesh")
    config = dataclasses.replace(pp_model(cfg).config, moe_experts=cfg["experts"],
                                 moe_top_k=cfg["top_k"], causal=cfg.get("causal", False),
                                 ring_mesh=make_mesh(ring) if ring else None,
                                 sp_impl=cfg.get("sp_impl", "ring"))
    return bert._make(config, cfg["seq"], "bert_moe")


MODELS = {"bert": bert_model, "mlp": mlp_model, "resnet": resnet_model, "sp": sp_model,
          "pp": pp_model, "moe": moe_model}


def with_weights(model: Model, weights: dict) -> Model:
    """The model, its ``init`` returning ``weights`` (the reference's init,
    bridged) for any seed."""
    model.init = lambda seed=0, device=None: {k: torch.as_tensor(v).clone()
                                              for k, v in weights.items()}
    return model


def host(variables: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in variables.items()}


def train(case: dict, workdir: str) -> dict:
    model = with_weights(MODELS[case["model"]](case["config"]), case["weights"])
    data = dk.Dataset.from_arrays(**case["data"])
    kwargs = dict(case["kwargs"])
    if "checkpoint_dir" in kwargs:
        kwargs["checkpoint_dir"] = os.path.join(workdir, kwargs["checkpoint_dir"])
    trainer = dk.SynchronousDistributedTrainer(model, device="cpu", **kwargs)
    tracer = enable_tracing(Tracer()) if case.get("trace") else None
    try:
        trained = trainer.train(data, shuffle=case.get("shuffle", False))
    finally:
        if tracer is not None:
            disable_tracing()
    out = {"history": trainer.history, "weights": host(trained.variables)}
    if tracer is not None:  # how many times each span opened
        names = [e[1] for e in tracer.events() if e[0] == "B"]
        out["spans"] = {n: names.count(n) for n in set(names)}
    if "checkpoint_dir" in kwargs:
        out["saved_steps"] = sorted(int(n) for n in os.listdir(kwargs["checkpoint_dir"])
                                    if n.isdigit())
    return out


def predict(case: dict, workdir: str) -> dict:
    model = with_weights(MODELS[case["model"]](case["config"]), case["weights"])
    trained = TrainedModel(model, model.init())
    data = dk.Dataset.from_arrays(features=case["features"])
    out = {}
    mesh = make_mesh(case["mesh"]) if "mesh" in case else best_mesh()
    runs = (("mesh", mesh), ("plain", None)) if case.get("plain", True) else (("mesh", mesh),)
    for name, mesh in runs:
        pred = dk.ModelPredictor(trained, batch_size=case["batch_size"], mesh=mesh,
                                 device="cpu")
        out[name] = np.asarray(pred.predict(data)["prediction"])
    return out


def refuse(case: dict, workdir: str) -> dict:
    model = with_weights(MODELS[case["model"]](case["config"]), case["weights"])
    try:
        dk.SynchronousDistributedTrainer(model, device="cpu", **case["kwargs"]).train(
            dk.Dataset.from_arrays(**case["data"]))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def groups(case: dict, workdir: str) -> dict:
    """The groups of a dp=2, tp=1 mesh: dp the default group, tp this rank's
    own group of the mesh's ``DeviceMesh``; each axis's sum of rank + 1."""
    m = make_mesh({"dp": 2, "tp": 1})
    out = {"device_mesh": m.device_mesh.mesh.tolist()}
    for axis in m.axis_names:
        group = m.group(axis)
        t = torch.tensor([distributed.process_index() + 1.0])
        torch.distributed.all_reduce(t, group=group)
        out[axis] = [torch.distributed.get_world_size(group), t.item()]
    return out


def sharded_init(case: dict, workdir: str) -> dict:
    """``sharded_train_state`` from ``Model.init`` (seed 3) on a model-axes
    mesh: the state gathered whole, and each weight's part on this rank
    before and after one step."""
    from distkeras_tpu_torch.ops.losses import get_optimizer
    from distkeras_tpu_torch.parallel import gspmd

    model = MODELS[case["model"]](case["config"])
    mesh = make_mesh(case["mesh"])
    state, shardings = gspmd.sharded_train_state(model, get_optimizer("adam"), mesh, seed=3,
                                                 device="cpu")
    before = {k: tuple(v.shape) for k, v in state.params.items()}
    whole = host(gspmd.gather_whole({k: v.detach() for k, v in state.params.items()},
                                    shardings))
    step = gspmd.make_sharded_train_step(model, case["loss"], mesh)
    batch = gspmd.shard_batch(mesh, case["batch"], device="cpu")
    state, _ = step(state, batch)
    return {"whole": whole, "init": host(model.init(3, device="cpu")), "before": before,
            "after": {k: tuple(v.shape) for k, v in state.params.items()},
            "specs": {k: s.spec for k, s in shardings.items()}}


def tp_decode(case: dict, workdir: str) -> dict:
    """gpt_tiny's decode mode with ``tp_mesh``: a prefill, then greedy
    one-token steps; every step's last-position logits, the tokens and the
    K/V leaves' shapes."""
    from distkeras_tpu_torch.inference.generate import greedy_ids
    from distkeras_tpu_torch.parallel.gspmd import place_sharded
    from distkeras_tpu_torch.parallel.sharding import infer_variable_shardings

    mesh = make_mesh(case["mesh"])
    base = bert.gpt_tiny(seq_len=case["seq"], vocab_size=case["vocab"])
    cfg = dataclasses.replace(base.config, dtype=torch.float32, decode=True, tp_mesh=mesh)
    model = bert._make(cfg, case["seq"], "gpt_tiny")
    whole = {k: torch.as_tensor(v) for k, v in case["weights"].items()}
    weights = place_sharded(whole, infer_variable_shardings(mesh, whole, bert.param_axes), "cpu")
    tokens = torch.as_tensor(case["prompt"])
    logits, cache = model.apply(weights, tokens)
    steps, out = [logits[:, -1]], []
    for _ in range(case["steps"]):
        tok = greedy_ids(logits[:, -1])
        out.append(tok)
        logits, cache = model.apply({**weights, **cache}, tok[:, None])
        steps.append(logits[:, -1])
    return {"logits": torch.stack(steps).numpy(), "tokens": torch.stack(out, 1).numpy(),
            "kv": {k: tuple(v.shape) for k, v in cache.items() if v.ndim == 4}}


def joint_group(case: dict, workdir: str) -> dict:
    """The group of several mesh axes: its size and the sum of its ranks'
    rank + 1."""
    group = make_mesh(case["mesh"]).group(tuple(case["axes"]))
    t = torch.tensor([distributed.process_index() + 1.0])
    torch.distributed.all_reduce(t, group=group)
    return [torch.distributed.get_world_size(group), t.item()]


def _sp_attention_fns() -> dict:
    import functools

    from distkeras_tpu_torch.ops.attention import ring_self_attention
    from distkeras_tpu_torch.ops.flash_attention import flash_attention
    from distkeras_tpu_torch.ops.ring_flash import ring_flash_attention
    from distkeras_tpu_torch.ops.ulysses import ulysses_self_attention

    return {"ring_flash": ring_flash_attention, "ring": ring_self_attention,
            "ulysses": ulysses_self_attention,
            "ulysses_flash": functools.partial(ulysses_self_attention, attn_fn=flash_attention)}


def sp_attention(case: dict, workdir: str) -> dict:
    """Each sequence-parallel attention case over ``{"sp": world}``: this
    rank's columns of the whole ``q``, ``k``, ``v`` (already in the layout
    the function takes), its output and the gradients of its columns under
    the cotangent ``cot``."""
    fns = _sp_attention_fns()
    mesh = make_mesh({"sp": distributed.process_count()})
    rank, world = distributed.process_index(), distributed.process_count()
    out = {}
    for name, c in case["cases"].items():
        dtype = getattr(torch, c["dtype"])
        s = c["q"].shape[1] // world
        mine = slice(rank * s, (rank + 1) * s)
        q, k, v = (torch.as_tensor(c[x][:, mine]).to(dtype).requires_grad_() for x in "qkv")
        kwargs = {"stripe": True} if c["stripe"] else {}
        o = fns[c["fn"]](q, k, v, mesh, "sp", causal=c["causal"], **kwargs)
        o.backward(torch.as_tensor(c["cot"][:, mine]).to(dtype))
        out[name] = {"out": o.detach().float().numpy(),
                     "grads": [t.grad.float().numpy() for t in (q, k, v)]}
    return out


def sp_forward(case: dict, workdir: str) -> dict:
    """The sequence-parallel model on this rank's columns of the token ids
    (``gspmd.shard_batch``, striped under ``ring_stripe``): its logits,
    gathered whole in natural order (``gspmd.gather_sequence``)."""
    from distkeras_tpu_torch.parallel import gspmd

    out = {}
    for name, c in case["cases"].items():
        model = with_weights(sp_model(c["config"]), case["weights"])
        mesh = model.config.ring_mesh
        stripe = c["config"]["sp_impl"] == "ring_stripe"
        ids = gspmd.shard_batch(mesh, {"ids": case["tokens"]}, 1, "cpu", stripe)["ids"]
        with torch.no_grad():
            logits, _ = model.apply(model.init(), ids)
        out[name] = {"local": tuple(logits.shape),
                     "whole": gspmd.gather_sequence(logits, mesh, 1, stripe).numpy()}
    return out


def pp_stage(chunk, x, seed=None):
    """The pipeline tests' stage: ``tanh(x @ w + b)``; with a seed, dropout
    at 0.25 from a generator seeded with it."""
    y = torch.tanh(x @ chunk["w"] + chunk["b"])
    if seed is None:
        return y
    keep = torch.rand(y.shape, generator=torch.Generator().manual_seed(seed)) >= 0.25
    return torch.where(keep, y / 0.75, torch.zeros((), dtype=y.dtype))


def pp_stage_aux(chunk, x):
    y = pp_stage(chunk, x)
    return y, (y * y).mean()


def pp_last(chunk, head, x, labels, seed=None, with_aux=False, moe=False):
    """The pipeline tests' last stage with its head and loss: the squared
    error of ``stage(x) @ hw + hb`` against the labels (and, as the metric
    channel, the mean of the stage's output; with ``moe``, the stage's
    ``mean(y²)`` as its differentiated aux loss, before the metric)."""
    y = pp_stage(chunk, x, seed)
    loss = ((y @ head["w"] + head["b"] - labels) ** 2).mean()
    out = (loss,) + (((y * y).mean(),) if moe else ()) + ((y.mean(),) if with_aux else ())
    return out if len(out) > 1 else loss


def pp_engine(case: dict, workdir: str) -> dict:
    """Each pipeline engine case over ``make_mesh(c["mesh"])``: this rank's
    chunks of the logical stages ``c["w"]``/``c["b"]`` (``rank_stages``),
    its dp slice of the microbatches; ``pipeline_apply`` under the cotangent
    ``c["cot"]`` (and ``c["aux_cot"]``), or ``pipeline_1f1b_value_and_grad``."""
    import functools

    from distkeras_tpu_torch.parallel.pipeline import pipeline_apply, rank_stages
    from distkeras_tpu_torch.parallel.pipeline_1f1b import pipeline_1f1b_value_and_grad

    out = {}
    for name, c in case["cases"].items():
        mesh = make_mesh(c["mesh"])
        where = mesh.coords(distributed.process_index())
        d, k = where["pp"], where.get("dp", 0)
        P, dp, V = mesh.shape["pp"], mesh.shape.get("dp", 1), c.get("V", 1)
        stages = rank_stages(P, V, d)
        chunks = [{"w": torch.tensor(c["w"][s]).requires_grad_(),
                   "b": torch.tensor(c["b"][s]).requires_grad_()} for s in stages]
        rows = c["mb"].shape[1] // dp
        mine = slice(k * rows, (k + 1) * rows)
        mb = torch.tensor(c["mb"][:, mine]).requires_grad_()
        rep = {"d": d, "k": k, "stages": stages}
        if c["engine"] == "gpipe":
            aux = c.get("aux_cot") is not None
            res = pipeline_apply(pp_stage_aux if aux else pp_stage, chunks, mb, mesh,
                                 virtual_stages=V, with_aux=aux)
            y, a = res if aux else (res, None)
            obj = (y * torch.tensor(c["cot"][:, mine])).sum()
            if aux:
                obj = obj + a * c["aux_cot"]
                rep["aux"] = a.item()
            obj.backward()
            rep["out"] = y.detach().numpy()
            rep["g_mb"] = mb.grad.numpy()
            rep["grads"] = [{n: t.grad.numpy() for n, t in ch.items()} for ch in chunks]
        else:
            head = {"w": torch.tensor(c["hw"]), "b": torch.tensor(c["hb"])}
            moe = c.get("moe_seed") is not None
            last = functools.partial(pp_last, with_aux=c["with_aux"], moe=moe)
            res = pipeline_1f1b_value_and_grad(
                pp_stage_aux if moe else pp_stage, last, chunks, head, mb.detach(),
                torch.tensor(c["labels"][:, mine]), mesh, rng=c.get("rng"),
                with_aux=c["with_aux"], stage_aux_seed=c.get("moe_seed"))
            *values, g_stage, g_head, cot = res
            rep["values"] = [v.item() for v in values]
            rep["grads"] = [{n: t.numpy() for n, t in g_stage[0].items()}]
            rep["head"] = {n: t.numpy() for n, t in g_head.items()}
            rep["cot"] = cot.numpy()
        out[name] = rep
    return out


class _record_routes:
    """While open, the dispatch tensors ``[T, E, C]`` of the first ``n``
    MoE routings (``ops/moe.py _route``) this rank makes; :meth:`close`
    stops and returns them."""

    def __init__(self, n: int):
        from distkeras_tpu_torch.ops import moe

        self.moe, self.real, self.seen = moe, moe._route, []
        if n:
            def recording(*args, **kwargs):
                out = self.real(*args, **kwargs)
                if len(self.seen) < n:
                    self.seen.append(out[0].detach().numpy().copy())
                return out

            moe._route = recording

    def close(self) -> list:
        self.moe._route = self.real
        return self.seen


def pp_train(case: dict, workdir: str) -> dict:
    """``PipelineTrainer`` runs (``c["kwargs"]``, the mesh among them) of a
    bert-family model from bridged weights; and the sync trainer's
    (``c["trainer"] == "sync"``). ``c["publish"]`` (steps) gives the trainer
    a ``WeightPublisher`` into ``WORKDIR/<name>-pub`` on that step cadence:
    rank 0 returns how many it published and the last one's weights."""
    from distkeras_tpu_torch.checkpoint import load_weights_file, read_manifest
    from distkeras_tpu_torch.deploy.publisher import PublishPolicy, WeightPublisher
    from distkeras_tpu_torch.utils.bridge import params_from_jax

    out = {}
    for name, c in case["cases"].items():
        model = with_weights(MODELS[c["model"]](c["config"]), c["weights"])
        data = dk.Dataset.from_arrays(**c["data"])
        kwargs = dict(c["kwargs"])
        if "checkpoint_dir" in kwargs:
            kwargs["checkpoint_dir"] = os.path.join(workdir, kwargs["checkpoint_dir"])
        cls = dk.SynchronousDistributedTrainer if c.get("trainer") == "sync" else \
            dk.PipelineTrainer
        trainer = cls(model, device="cpu", **kwargs)
        routes = _record_routes(c.get("routes", 0))
        pub = None
        if c.get("publish"):
            pub = WeightPublisher(os.path.join(workdir, f"{name}-pub"),
                                  PublishPolicy(every_steps=c["publish"]))
            trainer.publisher = pub
        try:
            trained = trainer.train(data.take(c["rows"]) if "rows" in c else data)
        finally:
            seen = routes.close()
        out[name] = {"history": trainer.history, "weights": host(trained.variables)}
        if seen:
            out[name]["routes"] = seen
        if "checkpoint_dir" in kwargs:
            out[name]["saved_steps"] = sorted(
                int(n) for n in os.listdir(kwargs["checkpoint_dir"]) if n.isdigit())
        if pub is not None and distributed.process_index() == 0:
            last = read_manifest(pub.directory)
            out[name]["published"] = pub.published
            out[name]["last_published"] = host(params_from_jax(
                load_weights_file(last["path"]), device="cpu"))
    return out


def gpt_model(cfg: dict) -> Model:
    """gpt_tiny at ``cfg``'s length and vocabulary, in float32 (its MLPs MoE
    blocks of ``cfg["experts"]`` experts at top ``cfg["top_k"]`` when
    given)."""
    base = bert.gpt_tiny(seq_len=cfg["seq"], vocab_size=cfg["vocab"])
    return bert._make(dataclasses.replace(base.config, dtype=torch.float32, dropout_rate=0.0,
                                          moe_experts=cfg.get("experts", 0),
                                          moe_top_k=cfg.get("top_k", 1)),
                      cfg["seq"], "gpt_tiny")


_KV_CARRY: dict = {}


def _serve_requests(engine, c):
    """The leader's side of one sharded-serving case: the requests (all at
    once, or one after another), then the swap, the KV export and the
    healthz row the case asks for."""
    import asyncio

    from distkeras_tpu_torch.serving import ServingClient, ServingServer

    rep = {}

    async def go():
        server = None
        if c.get("healthz"):
            server = ServingServer(engine, host="127.0.0.1", port=0)
            await server.start()
            task = None
        else:
            task = asyncio.create_task(engine.run())
        try:
            if c.get("kv_import") is not None:
                ev, res = engine.request_kv_import(_KV_CARRY[c["kv_import"]])
                await asyncio.wait_for(ev.wait(), 60)
                rep["import"] = {k: v for k, v in res.items() if k != "error"}
            reqs = c["requests"]
            if c.get("sequential"):
                done = [await engine.submit(p, n, **kw).result() for p, n, kw in reqs]
            else:
                pending = [engine.submit(p, n, **kw) for p, n, kw in reqs]
                done = [await r.result() for r in pending]
            rep["outs"] = [list(map(int, d)) for d in done]
            if not c.get("sequential"):
                rep["scores"] = [list(r.logprobs or []) for r in pending]
                rep["forks"] = [r.fork_completions for r in pending]
                rep["embeds"] = [r.embedding for r in pending]
            if c.get("swap") is not None:
                ev, res = engine.request_param_swap(
                    c["swap"], provenance={"version": 9, "digest": "d9"})
                await asyncio.wait_for(ev.wait(), 60)
                assert res.get("ok"), res
                rep["after_swap"] = [list(map(int, await engine.submit(p, n, **kw).result()))
                                     for p, n, kw in reqs]
                rep["weight_version"] = engine.weight_version
            if c.get("kv_refuse"):
                for verb in ("request_kv_export", "request_kv_import"):
                    try:
                        getattr(engine, verb)(reqs[0][0] if "export" in verb else b"")
                    except Exception as e:
                        rep.setdefault("refused", []).append((type(e).__name__, str(e)))
            if c.get("kv_export"):
                ev, res = engine.request_kv_export(reqs[0][0])
                await asyncio.wait_for(ev.wait(), 60)
                rep["payload"] = res["payload"]
            if server is not None:
                async with ServingClient("127.0.0.1", server.port) as client:
                    rep["healthz"] = await client.healthz()
        finally:
            if server is not None:
                await server.stop(drain=True)
            else:
                engine.shutdown(drain=True)
                await task

    asyncio.run(go())
    return rep


def serve_mesh(case: dict, workdir: str) -> dict:
    """Sharded serving (``ServingEngine(mesh=...)``): every rank builds the
    engine of each case from the same whole weights; the mesh's first rank
    serves the case's requests and closes, the others follow. A case may
    carry a second set of weights to swap in, export a prompt's blocks,
    hand them through an unsharded engine (``kv_relay``) or import them,
    ask for the healthz row, or make a follower rank's decode step raise
    (``fail``). Also runs batch-parallel ``generate``/``beam_search``
    (``generate``)."""
    from distkeras_tpu_torch.inference.generate import beam_search, generate
    from distkeras_tpu_torch.parallel.mesh import serving_mesh
    from distkeras_tpu_torch.serving import ServingEngine
    from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor

    rank = distributed.process_index()
    out = {}
    for name, c in case["cases"].items():
        model = gpt_model(c)
        weights = {k: torch.as_tensor(v) for k, v in c["weights"].items()}
        if c.get("generate"):
            mesh = make_mesh(c["mesh"])
            prompt = np.asarray(c["prompt"], np.int32)
            out[name] = {
                "greedy": generate(model, weights, prompt, c["new"], greedy=True, mesh=mesh,
                                   device="cpu"),
                "sampled": generate(model, weights, prompt, c["new"], temperature=0.9,
                                    top_k=8, seed=3, mesh=mesh, device="cpu"),
                "beam": beam_search(model, weights, prompt, c["new"], num_beams=3, mesh=mesh,
                                    device="cpu")}
            continue
        kw = dict(c["engine"])
        if kw.pop("draft", False):
            kw.update(draft_model=model, draft_variables=weights)
        auditor = RecompileAuditor()
        engine = ServingEngine(model, weights, mesh=serving_mesh(c["mesh"]), auditor=auditor,
                               arm_auditor_after_warmup=True, device="cpu", **kw)
        rep = {}
        fail = c.get("fail")
        if fail is not None and rank == fail["rank"]:
            step = engine._link._local["_decode_step"]
            calls = [0]

            def failing(*args, **kwargs):
                calls[0] += 1
                if calls[0] > fail["after"]:
                    raise RuntimeError("injected follower failure")
                return step(*args, **kwargs)

            engine._link._local["_decode_step"] = failing
        if engine.is_leader:
            import time

            t0 = time.monotonic()
            try:
                rep.update(_serve_requests(engine, c))
            except Exception as e:  # the failure case's typed error
                rep["error"] = (type(e).__name__, getattr(e, "code", None), str(e))
            rep["seconds"] = time.monotonic() - t0
            rep["mesh_info"] = engine.mesh_info()
            rep["debugz"] = engine.debugz()
            rep["bubble"] = engine.metrics.bubble.fraction
            rep["preemptions"] = engine.metrics.preemptions
            rep["spec_accepted"] = engine.metrics.spec_accepted_tokens
            rep["prefix_hits"] = (engine.prefix_cache.hit_tokens
                                  if engine.prefix_cache is not None else None)
            if "error" not in rep:
                rep["counts"] = engine.decode_compile_counts()
                engine.close()
            if c.get("kv_relay"):
                # tp=1 in the middle of a round trip: an unsharded engine
                # imports the payload and exports it again.
                plain = ServingEngine(model, weights, device="cpu", **c["engine"])
                _KV_CARRY[name] = _relay(plain, rep["payload"], c["requests"][0][0])
                rep["relayed"] = _KV_CARRY[name]
        else:
            try:
                rep["ops"] = engine.follow()
            except Exception as e:
                rep["error"] = (type(e).__name__, str(e))
        rep["compiles"] = {n: auditor.compiles(n) for n in
                           ("serving_decode", "serving_draft", "serving_verify")
                           if n in auditor.report()}
        out[name] = rep
        if "error" in rep:
            break  # the process group is gone
    return out


def _relay(engine, payload, prompt):
    """Import ``payload`` into an unsharded engine and export the same
    prompt's blocks again."""
    import asyncio

    async def go():
        task = asyncio.create_task(engine.run())
        try:
            ev, res = engine.request_kv_import(payload)
            await asyncio.wait_for(ev.wait(), 60)
            ev, res = engine.request_kv_export(prompt)
            await asyncio.wait_for(ev.wait(), 60)
            return res["payload"]
        finally:
            engine.shutdown(drain=True)
            await task

    return asyncio.run(go())


RUNNERS = {"serve_mesh": serve_mesh, "train": train, "predict": predict, "refuse": refuse, "groups": groups,
           "sharded_init": sharded_init, "tp_decode": tp_decode, "joint_group": joint_group,
           "sp_attention": sp_attention, "sp_forward": sp_forward, "pp_engine": pp_engine,
           "pp_train": pp_train}


def spawn_ranks(workdir: str, world: int, scenarios: dict, timeout: float = 280) -> list[dict]:
    """Start ``world`` of these workers on ``scenarios`` (pickled into
    ``workdir``), wait up to ``timeout`` seconds (killing them after) and
    return each rank's results; a rank that fails fails the caller with its
    log's tail."""
    import subprocess

    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(scenarios, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), workdir, str(r),
                               str(world)], cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
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


def main(workdir: str, rank: int, world: int) -> int:
    # One intra-op thread: with two, a process's first training run now and
    # then rounds differently from its later ones (a noise-level gradient,
    # the attention key bias's, moves first), which breaks the bitwise
    # checks between runs and between ranks (ROADMAP.md §C, C4).
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        scenarios = pickle.load(f)
    distributed.initialize(f"file://{os.path.join(workdir, 'store')}", world, rank,
                           backend="gloo")
    results = {"world": distributed.process_count(), "rank": distributed.process_index()}
    try:
        for name, case in scenarios.items():
            results[name] = RUNNERS[case["kind"]](case, workdir)
    except BaseException:
        results["failure"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(workdir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        if torch.distributed.is_initialized():  # a failed follower left it
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))

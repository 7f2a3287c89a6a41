"""One cell's run on one rank: set-up, the checked steps, the measured
window, the traced stretch and the reference.

What the window drives is the training step both of the port's trainers
run (``training/step.py make_train_step``), one call a batch, its batches
coming through ``data/feed.py DeviceFeed`` over ``minibatches``, in a copy
of the trainers' step loop (``training/trainers.py _run_steps``) kept here
so that a rename inside the port does not move the yardstick. On ranks
above one the step's process group is the ``dp`` group of a
``parallel/mesh.py`` mesh over the ranks, as ``SynchronousDistributedTrainer``
builds it when nothing is sharded.

Set-up builds the step and its state once, drives it through
``SETUP_STEPS`` steps of the window's own call and feed (the first
``CHECKED_STEPS`` read for the comparison) and hands the same objects to the
window. After the window the program's state is freed and the plain
reference follows the checked steps from the same weights and rows.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import statistics
import sys
import time

import numpy as np

from perfbench import counts, trace, traffic as traffic_gen
from perfbench.manifest import reader
from perfbench.weights import leaf_shapes, make_weights

SETUP_STEPS = 5
CHECKED_STEPS = 3
TRACE_STEPS = 20     # steps under the profiler in a traced run
STOP_EVERY = 10      # ranks above one agree on the window's end this often
FORBIDDEN = ("jax", "jaxlib", "flax", "distkeras_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that no run may load, compared
    whole (``distkeras_tpu_torch`` is not ``distkeras_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def build_model(cfg: dict, traffic: dict):
    """The port's model of ``cfg`` at the traffic's sequence length, after
    checking that it is the configuration the file states."""
    import torch

    from distkeras_tpu_torch.models import bert
    from distkeras_tpu_torch.models.core import Model

    port = cfg["port"]
    base = getattr(bert, port["constructor"])(seq_len=traffic["seq"])
    overrides = dict(port.get("overrides", {}))
    if "dtype" in overrides:
        overrides["dtype"] = getattr(torch, overrides["dtype"])
    mcfg = dataclasses.replace(base.config, **overrides)
    stated = {"vocab_size": cfg["vocab_size"], "hidden_size": cfg["hidden_size"],
              "num_layers": cfg["num_hidden_layers"], "num_heads": cfg["num_attention_heads"],
              "mlp_dim": cfg["intermediate_size"],
              "max_seq_len": cfg["max_position_embeddings"],
              "dropout_rate": cfg["hidden_dropout_prob"], "causal": cfg["causal"],
              "dtype": getattr(torch, cfg["dtype"])}
    built = {k: getattr(mcfg, k) for k in stated}
    if built != stated:
        raise RuntimeError(f"the port builds {built}, the configuration states {stated}")
    model = Model(lambda: bert.Bert(mcfg), name=cfg["name"], input_shape=(traffic["seq"],),
                  output_dim=cfg["vocab_size"])
    model.config = mcfg
    layout = {k: tuple(v.shape) for k, v in model.module.state_dict().items()}
    if layout != leaf_shapes(cfg):
        raise RuntimeError("the port's weight layout differs from the benchmark's "
                           f"({sorted(set(layout) ^ set(leaf_shapes(cfg)))[:8]} ...)")
    return model


def make_step(model, cfg: dict, group):
    """The training step the trainers build: the configuration's loss, the
    trainers' default metrics, data parallel over ``group``."""
    from distkeras_tpu_torch.training.step import make_train_step

    return make_train_step(model, cfg["port"]["loss"], process_group=group)


def make_state(model, weights: dict, traffic: dict, seed: int):
    """A ``TrainState`` over ``weights`` with the mix's optimizer, after
    checking that the port's optimizer is the one the mix states."""
    from distkeras_tpu_torch.ops.losses import get_optimizer, optimizer_spec
    from distkeras_tpu_torch.training.step import TrainState

    opt = traffic["optimizer"]
    factory = get_optimizer(opt["name"], opt["learning_rate"])
    _, kwargs = optimizer_spec(factory)
    stated = {"lr": opt["learning_rate"], "betas": tuple(opt["betas"]), "eps": opt["eps"],
              "weight_decay": opt["weight_decay"]}
    built = {k: tuple(kwargs[k]) if k == "betas" else kwargs[k] for k in stated}
    if built != stated:
        raise RuntimeError(f"the port's {opt['name']} is {built}, the mix states {stated}")
    params = {name: weights[name].requires_grad_() for name, _ in
              model.module.named_parameters()}
    return TrainState(params, {}, factory(list(params.values())), 0, int(seed))


class Source:
    """The rank's batches: the pool's global batches through the port's
    ``minibatches``, epoch after epoch reshuffled, cut to the rank's rows,
    until :attr:`stop` is set. Keeps the first ``CHECKED_STEPS`` global
    batches for the reference."""

    def __init__(self, pool: dict, traffic: dict, rank: int, seed: int):
        self.pool, self.traffic, self.rank, self.seed = pool, traffic, rank, seed
        self.stop = False
        self.first: list[dict] = []

    def __iter__(self):
        from distkeras_tpu_torch.data.dataset import Dataset
        from distkeras_tpu_torch.data.feed import minibatches

        b = self.traffic["batch"]
        rows = slice(self.rank * b, (self.rank + 1) * b)
        dataset = Dataset.from_arrays(**self.pool)
        for batch in minibatches(dataset, b * self.traffic["ranks"], num_epoch=1 << 40,
                                 seed=self.seed):
            if self.stop:
                return
            if len(self.first) < CHECKED_STEPS:
                self.first.append(batch)
            yield {k: v[rows] for k, v in batch.items()}


class _Clock:
    """Step intervals: CUDA events recorded after each step on the step's
    stream, read once at the end; on the CPU (tests only) the host clock."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.marks: list = []
        self._torch = torch

    def mark(self):
        if self.cuda:
            ev = self._torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _norms(tensors: list):
    import torch

    return torch.stack([torch.linalg.vector_norm(t.detach().double()) for t in tensors])


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rank(spec: dict, seed: int, seconds: float, traced: bool, rank: int = 0,
             world: int = 1, device: str = "cuda", t_process: float | None = None,
             init_method: str | None = None, backend: str = "nccl",
             step_factory=make_step, window: bool = True) -> dict:
    """One rank's run of the cell ``spec`` (:func:`perfbench.manifest.cell`);
    returns its report. ``window=False`` stops after the checked steps (the
    calibration's readings). ``step_factory(model, cfg, group)`` builds the
    step (tests plant faults there)."""
    t_process = time.time() if t_process is None else t_process
    import torch
    from torch.autograd.profiler import record_function

    from distkeras_tpu_torch.data.feed import DeviceFeed
    from distkeras_tpu_torch.parallel import distributed
    from distkeras_tpu_torch.parallel.mesh import make_mesh

    cfg, traffic = spec["config"], spec["traffic"]
    group = gloo = None
    if world > 1:
        if not torch.distributed.is_initialized():
            distributed.initialize(init_method, world, rank, backend=backend)
        gloo = torch.distributed.new_group(backend="gloo") if backend != "gloo" else None
        group = make_mesh({"dp": world}).group("dp")
    dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
           else torch.device(device))
    opt = traffic["optimizer"]
    report: dict = {"rank": rank}
    phases = {"imported": time.time() - t_process}

    model = build_model(cfg, traffic)
    weights = make_weights(cfg, seed, dev)
    state = make_state(model, weights, traffic, seed)
    params = list(state.params.values())
    initial = [p.detach().clone() for p in params]
    step = step_factory(model, cfg, group)
    pool = traffic_gen.make_pool(traffic, cfg, seed)
    source = Source(pool, traffic, rank, seed)
    feed = iter(DeviceFeed(source, dev, buffer_size=2))

    _sync(dev)
    phases["built"] = time.time() - t_process
    history, grad_norms, change_norms = [], None, None
    for i in range(SETUP_STEPS if window else CHECKED_STEPS):
        batch = next(feed)
        state, m = step(state, batch)
        history.append(m)
        if i == 0:
            _sync(dev)
            phases["first_step"] = time.time() - t_process
            # The gradient as the optimizer got it: Adam's first moment
            # after one step is (1 - beta1) g.
            moments = [state.optimizer.state.get(p, {}).get("exp_avg") for p in params]
            moments = [torch.zeros_like(p) if x is None else x for p, x in zip(params, moments)]
            grad_norms = _norms(moments) / (1 - opt["betas"][0])
        if i == CHECKED_STEPS - 1:
            change_norms = _norms([p - w0 for p, w0 in zip(params, initial)])
            del initial
    names = list(state.params)
    report["program"] = {
        "losses": [float(h["loss"]) for h in history[:CHECKED_STEPS]],
        "grad_norms": dict(zip(names, grad_norms.tolist())),
        "change_norms": dict(zip(names, change_norms.tolist())),
    }

    if window:
        _sync(dev)
        if world > 1:
            torch.distributed.barrier(group=gloo)
        clock = _Clock(dev)
        feed_s, dispatch_s = [], []
        prof, profiled, stretch = None, False, None
        t0_wall, t0 = time.time(), time.perf_counter()
        clock.mark()
        n = 0
        while True:
            if traced and prof is None and not profiled and \
                    time.perf_counter() - t0 >= seconds / 3:
                _sync(dev)
                prof = _profiler(dev)
                prof.__enter__()
                p_n0, p_t0 = n, time.perf_counter()
            ta = time.perf_counter()
            with record_function("perfbench.feed"):
                batch = next(feed)
            tb = time.perf_counter()
            with record_function("perfbench.step"):
                state, m = step(state, batch)
            tc = time.perf_counter()
            clock.mark()
            history.append(m)
            feed_s.append(tb - ta)
            dispatch_s.append(tc - tb)
            n += 1
            if prof is not None and not profiled and n - p_n0 == TRACE_STEPS:
                with record_function("perfbench.sync"):
                    _sync(dev)
                stretch = time.perf_counter() - p_t0
                prof.__exit__(None, None, None)
                profiled = True
            busy = prof is not None and not profiled
            if world == 1:
                if not busy and time.perf_counter() - t0 >= seconds:
                    break
            elif n % STOP_EVERY == 0:
                can_stop = torch.tensor([int(not busy and time.perf_counter() - t0 >= seconds)])
                torch.distributed.all_reduce(can_stop, torch.distributed.ReduceOp.MIN,
                                             group=gloo)
                if can_stop.item():
                    break
        source.stop = True
        _sync(dev)
        window_s = time.perf_counter() - t0
        report.update({
            "setup_s": t0_wall - t_process, "setup_phases": phases, "window_s": window_s,
            "steps": n,
            "tokens": n * traffic["batch"] * traffic["seq"],
            "intervals_ms": clock.intervals_ms(),
        })
        if prof is not None:
            report["trace"] = _read_trace(spec, prof, stretch, feed_s, dispatch_s, n,
                                          window_s, dev)
        report["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(dev))
                                       if dev.type == "cuda" else 0)
        del prof

    first = source.first
    del state, step, feed, history, params, weights, m, batch, source
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        t_ref = time.perf_counter()
        report["reference"] = reference_readings(cfg, traffic, first, seed, dev)
        report["reference_s"] = time.perf_counter() - t_ref
    if world > 1:
        torch.distributed.barrier(group=gloo)
    report["forbidden"] = forbidden_modules()
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(dev)
    return report


def reference_readings(cfg: dict, traffic: dict, first: list, seed: int, dev,
                       precision: str = "float32", rows_of=None) -> dict:
    """The plain reference over the checked steps' global batches
    ``first``, each cut into the ranks' rows, from the seed's weights."""
    import torch

    module = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    b = traffic["batch"]
    steps = [[(torch.from_numpy(g["features"][r * b:(r + 1) * b]).to(dev),
               torch.from_numpy(g["label"][r * b:(r + 1) * b]).to(dev))
              for r in range(traffic["ranks"])] for g in first]
    weights = make_weights(cfg, seed, dev)
    out = module.make(cfg, precision).train(weights, steps, seed, traffic["optimizer"], rows_of)
    del weights, steps
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _profiler(dev):
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _read_trace(spec, prof, stretch_s, feed_s, dispatch_s, steps, window_s, dev) -> dict:
    """The cell's per-layer metrics of this rank, its busy and traced
    seconds, and its breakdown."""
    import torch

    cfg, traffic = spec["config"], spec["traffic"]
    reduced = trace.reduce_profile(prof)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
    t = {
        **reduced,
        "stretch_steps": TRACE_STEPS, "stretch_s": stretch_s,
        "feed_s": feed_s, "dispatch_s": dispatch_s,
        "window_steps": steps, "window_s": window_s,
        "flops_per_step": counts.model_flops_per_step(
            cfg, traffic["batch"] * traffic["ranks"], traffic["seq"]),
        "chips": traffic["ranks"], "peak_flops": counts.peak_flops(name),
        "bounds": counts.step_bounds_s(cfg, traffic["batch"], traffic["seq"]),
    }
    metrics = {}
    for m in spec["per_layer"]:
        value = reader(m["name"])(t)
        if value is not None:
            metrics[m["name"]] = value
    return {
        "metrics": metrics,
        "busy_s": trace.busy_us(reduced["device"]) / 1e6,
        "class_ms": {k: v / TRACE_STEPS / 1e3 for k, v in trace.class_us(reduced["device"]).items()},
        "optimizer_ms": reduced["optimizer_us"] / TRACE_STEPS / 1e3,
        "window_s": stretch_s,
        "device_ops": trace.top_ops(reduced["device"]),
        "idle_gaps": trace.idle_gaps(reduced["device"], reduced["spans"]),
    }


def summarize(spec: dict, reports: list[dict], traced: bool) -> dict:
    """The run's result line (without ``correct`` and ``checks``) from every
    rank's report."""
    reports = sorted(reports, key=lambda r: r["rank"])
    tokens = sum(r["tokens"] for r in reports)
    window_s = max(r["window_s"] for r in reports)
    intervals = [x for r in reports for x in r["intervals_ms"]]
    device = {"platform": "gpu", "kind": reports[0].get("card", "cpu"), "count": len(reports),
              "memory_peak_bytes": max(r["memory_peak_bytes"] for r in reports)}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    out: dict = {"attempted": sum(r["steps"] for r in reports), "failed": 0}
    if not traced:
        values = {"train_tokens_per_s": tokens / window_s,
                  "train_step_ms_p95": float(np.percentile(intervals, 95)),
                  "setup_s": max(r["setup_s"] for r in reports)}
        out["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()
                          if k in units}
        out["device"] = device
        return out
    traces = [r["trace"] for r in reports]
    names = [m["name"] for m in spec["per_layer"]]
    out["metrics"] = {}
    for name in names:
        values = [t["metrics"][name] for t in traces if name in t["metrics"]]
        if values:
            out["metrics"][name] = {"value": statistics.fmean(values), "unit": units[name]}
    device["busy_s"] = statistics.fmean(t["busy_s"] for t in traces)
    device["window_s"] = statistics.fmean(t["window_s"] for t in traces)
    out["device"] = device
    out["breakdown"] = {"device_ops": _merge([t["device_ops"] for t in traces]),
                        "idle_gaps": _merge([t["idle_gaps"] for t in traces], longest=True)}
    return out


def _merge(lists, longest: bool = False) -> list:
    """Ten entries over the ranks: device operations by name, averaged over
    the ranks; idle gaps, the longest of all ranks."""
    lists = list(lists)
    if longest:
        return sorted((tuple(x) for lst in lists for x in lst), key=lambda x: -x[1])[:10]
    total: dict = {}
    for lst in lists:
        for name, s in lst:
            total[name] = total.get(name, 0.0) + s / len(lists)
    return sorted(total.items(), key=lambda kv: -kv[1])[:10]

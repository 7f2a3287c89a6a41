"""Trainers: counterpart of ``distkeras_tpu/training/trainers.py``.

Ported so far: the :class:`Trainer` base (constructor surface, wall-clock
bookkeeping, step history, :meth:`Trainer.evaluate`), :class:`SingleTrainer`
(one step loop on one device) and the asynchronous parameter-server family,
:class:`AsynchronousDistributedTrainer` with ``DOWNPOUR``, ``ADAG``,
``AEASGD``, ``EAMSGD`` and ``DynSGD``: worker threads, each running its
windows on its own CUDA stream, exchange with one in-process parameter
server every ``communication_window`` steps. The replica trainers (ensemble,
averaging, synchronous), the gRPC transport, multi-device islands,
checkpointing and the telemetry hooks of the serving slices (metric stream,
recompile auditor, weight publisher) come with later slices.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.feed import DeviceFeed, index_windows, minibatches, window_batches
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.ops.losses import get_loss, get_optimizer
from distkeras_tpu_torch.parallel.ha import CompressingClient, StampingClient
from distkeras_tpu_torch.parallel.protocols import (
    ADAGProtocol,
    AEASGDProtocol,
    AsyncProtocol,
    DOWNPOURProtocol,
    DynSGDProtocol,
    EAMSGDProtocol,
)
from distkeras_tpu_torch.parallel.ps import ParameterServerService
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.telemetry.training_health import TrainingHealth
from distkeras_tpu_torch.training.step import (
    TrainState,
    make_cached_window_train_step,
    make_eval_step,
    make_train_step,
    make_window_train_step,
)
from distkeras_tpu_torch.utils.device import resolve_device
from distkeras_tpu_torch.utils.rng import worker_seed

__all__ = [
    "Trainer",
    "SingleTrainer",
    "AsynchronousDistributedTrainer",
    "DOWNPOUR",
    "ADAG",
    "AEASGD",
    "EAMSGD",
    "DynSGD",
]


class Trainer:
    """Base trainer: holds the model spec, loss, worker optimizer name,
    the device and wall-clock bookkeeping. ``device`` defaults to CUDA and
    raises without one; pass ``"cpu"`` to run on the host."""

    def __init__(
        self,
        keras_model: Model,
        worker_optimizer="adagrad",
        loss: str = "categorical_crossentropy",
        metrics: tuple[str, ...] = ("accuracy",),
        learning_rate: float | None = None,
        seed: int = 0,
        loss_weights=None,
        device: str | torch.device | None = None,
    ):
        if not isinstance(keras_model, Model):
            raise TypeError("Trainer expects a distkeras_tpu_torch Model")
        self.model = keras_model
        self.device = resolve_device(device)
        self.loss_weights = loss_weights
        if loss_weights is not None:
            base, w = get_loss(loss), float(loss_weights)

            def _weighted(preds, targets):
                return base(preds, targets) * w

            loss = _weighted
        self.loss = loss
        self.worker_optimizer = worker_optimizer
        self.metrics = tuple(metrics)
        self.learning_rate = learning_rate
        self.seed = seed
        self.history: list[dict] = []
        self._training_start: float | None = None
        self._training_stop: float | None = None

    # -- timing ---------------------------------------------------------------

    def record_training_start(self) -> None:
        self._training_start = time.time()
        self._training_stop = None

    def record_training_stop(self) -> None:
        self._training_stop = time.time()

    def get_training_time(self) -> float:
        if self._training_start is None:
            return 0.0
        stop = self._training_stop if self._training_stop is not None else time.time()
        return stop - self._training_start

    def get_history(self) -> list[dict]:
        return self.history

    def get_averaged_history(self) -> dict:
        """Mean of each metric over the recorded steps."""
        if not self.history:
            return {}
        return {k: float(np.mean([h[k] for h in self.history if k in h]))
                for k in self.history[0]}

    def _optimizer(self):
        return get_optimizer(self.worker_optimizer, self.learning_rate)

    def train(self, dataset: Dataset, shuffle: bool = False) -> TrainedModel:
        raise NotImplementedError

    def evaluate(
        self,
        trained: TrainedModel,
        dataset: Dataset,
        batch_size: int = 1024,
        features_col: str | None = None,
        label_col: str | None = None,
    ) -> dict:
        """Mean eval metrics (loss + accuracy) over a dataset, batch by batch
        on the trainer's device."""
        eval_step = make_eval_step(self.model, self.loss)
        variables = {k: v.to(self.device) for k, v in trained.variables.items()}
        fcol = features_col or getattr(self, "features_col", "features")
        lcol = label_col or getattr(self, "label_col", "label")
        totals: dict[str, float] = {}
        count = 0
        for batch in minibatches(
            dataset, min(batch_size, dataset.num_rows), fcol, lcol,
            drop_remainder=False,
        ):
            dev_batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            m = eval_step(variables, dev_batch)
            n = batch["features"].shape[0]
            for k2, v2 in m.items():
                totals[k2] = totals.get(k2, 0.0) + float(v2) * n
            count += n
        return {k2: v2 / max(1, count) for k2, v2 in totals.items()}


class SingleTrainer(Trainer):
    """Single-device trainer (reference ``SingleTrainer``): one step loop on
    the trainer's device, CUDA unless ``device="cpu"``."""

    def __init__(
        self,
        keras_model: Model,
        worker_optimizer="adagrad",
        loss="categorical_crossentropy",
        metrics=("accuracy",),
        features_col: str = "features",
        label_col: str = "label",
        batch_size: int = 32,
        num_epoch: int = 1,
        learning_rate: float | None = None,
        seed: int = 0,
        grad_accum_steps: int = 1,
        remat: bool = False,
        aux_loss_weight: float = 0.01,
        validation_data: Dataset | None = None,
        loss_weights=None,
        device: str | torch.device | None = None,
    ):
        super().__init__(keras_model, worker_optimizer, loss, metrics,
                         learning_rate=learning_rate, seed=seed,
                         loss_weights=loss_weights, device=device)
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.grad_accum_steps = int(grad_accum_steps)
        self.remat = bool(remat)
        self.aux_loss_weight = float(aux_loss_weight)
        # Optional held-out set: evaluated after every epoch into
        # validation_history (val_loss/val_accuracy).
        self.validation_data = validation_data
        self.validation_history: list[dict] = []

    def train(self, dataset: Dataset, shuffle: bool = False) -> TrainedModel:
        """Train for ``num_epoch`` epochs (rows reshuffled each epoch with
        ``seed + epoch`` when ``shuffle``) and return the trained model, its
        weights on the trainer's device. ``history`` holds each step's
        metrics as floats, read from the device once, after the last step."""
        self.record_training_start()
        step_fn = make_train_step(
            self.model, self.loss, self.metrics, remat=self.remat,
            aux_loss_weight=self.aux_loss_weight, grad_accum_steps=self.grad_accum_steps,
        )
        state = TrainState.create(self.model, self._optimizer(), self.seed, self.device)
        history: list[dict] = []
        self.validation_history = []
        for epoch in range(self.num_epoch):
            batches = minibatches(
                dataset, self.batch_size, self.features_col, self.label_col,
                num_epoch=1, seed=(self.seed + epoch) if shuffle else None,
            )
            for batch in DeviceFeed(batches, self.device, buffer_size=2):
                state, m = step_fn(state, batch)
                history.append(m)
            if self.validation_data is not None:
                val = self.evaluate(
                    TrainedModel(self.model, state.variables), self.validation_data,
                    features_col=self.features_col, label_col=self.label_col,
                )
                self.validation_history.append(
                    {"epoch": epoch, **{f"val_{k}": v for k, v in val.items()}})
        # One read from the device for all the steps' metrics.
        self.history = []
        if history:
            keys = list(history[0])
            rows = torch.stack([torch.stack([h[k] for k in keys]) for h in history]).tolist()
            self.history = [dict(zip(keys, row)) for row in rows]
        self.record_training_stop()
        return TrainedModel(self.model, {k: v.detach() for k, v in state.variables.items()})


def _on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing on the CPU."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _tree_bytes(tree: dict) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values())


class AsynchronousDistributedTrainer(Trainer):
    """Async parameter-server trainer (reference
    ``AsynchronousDistributedTrainer``, ``trainers.py:711-1296``): owns the
    PS lifecycle, runs ``num_workers`` worker threads and returns the final
    center.

    Each worker thread drives its windows on its own CUDA stream: the
    kernels, Triton's launches and :class:`DeviceFeed`'s hand-offs all
    follow the thread's current stream, and a window ends in a sync on that
    stream alone. ``overlap_window`` runs each exchange on a helper thread
    with a stream of its own, which waits on an event the worker records
    after its snapshot; the reply is then rebased onto the advanced
    weights, ``center + (now - snapshot)``. Every new value is written into
    the optimizer's own parameter tensors, so its state stays attached;
    after ``train()``, ``worker_states`` holds each worker's
    :class:`TrainState`. ``parallelism_factor`` over-partitions the data.

    Not ported yet, and refused: ``transport="grpc"``, ``devices_per_worker
    > 1``, ``checkpoint_dir``/``resume`` and a weight ``publisher``.
    """

    protocol_cls: type[AsyncProtocol] = DOWNPOURProtocol

    # "auto" partition budget when the device reports no memory (the CPU).
    _DEVICE_CACHE_LIMIT = 256 * 1024 * 1024

    def __init__(
        self,
        keras_model: Model,
        worker_optimizer="adagrad",
        loss="categorical_crossentropy",
        metrics=("accuracy",),
        num_workers: int = 2,
        devices_per_worker: int = 1,
        batch_size: int = 32,
        features_col: str = "features",
        label_col: str = "label",
        num_epoch: int = 1,
        parallelism_factor: int = 1,
        communication_window: int | None = None,
        learning_rate: float | None = None,
        seed: int = 0,
        transport: str = "inprocess",
        master_host: str | None = None,
        master_port: int | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_interval_s: float = 60.0,
        resume: bool = False,
        compress_deltas: bool = False,
        overlap_window: bool = True,
        device_cache: bool | str = "auto",
        track_health: bool = True,
        loss_weights=None,
        registry=None,
        device: str | torch.device | None = None,
        **protocol_kwargs,
    ):
        super().__init__(keras_model, worker_optimizer, loss, metrics,
                         learning_rate=learning_rate, seed=seed,
                         loss_weights=loss_weights, device=device)
        if transport not in ("inprocess", "grpc"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "grpc":
            raise ValueError("transport='grpc' needs parallel/ps_grpc.py, which is not "
                             "ported yet (ROADMAP.md §A item 4)")
        if int(devices_per_worker) != 1:
            raise ValueError("devices_per_worker > 1 (multi-device islands) is not ported "
                             "yet (ROADMAP.md §A item 10)")
        if checkpoint_dir is not None or resume:
            raise ValueError("checkpoint_dir/resume need checkpoint.py, which is not "
                             "ported yet (ROADMAP.md §A item 5)")
        self.num_workers = int(num_workers)
        self.devices_per_worker = 1
        self.batch_size = int(batch_size)
        self.features_col = features_col
        self.label_col = label_col
        self.num_epoch = int(num_epoch)
        self.parallelism_factor = int(parallelism_factor)
        self.transport = transport
        self.master_host = master_host
        self.master_port = master_port
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval_s = float(checkpoint_interval_s)
        self.resume = bool(resume)
        # bf16 commit deltas: half the bytes to the PS (ha.CompressingClient)
        self.compress_deltas = bool(compress_deltas)
        self.overlap_window = bool(overlap_window)
        # "auto": keep a worker's partition on the device (batches gathered
        # there from index arrays) when it fits the budget.
        self.device_cache = device_cache
        self.registry = registry
        # The trainer side of continuous deployment (deploy/ publisher):
        # not ported; train() refuses a publisher.
        self.publisher = None
        if communication_window is not None:
            protocol_kwargs["communication_window"] = communication_window
        self.protocol = self._allocate_protocol(**protocol_kwargs)
        self.communication_window = self.protocol.communication_window
        self.parameter_server: ParameterServerService | None = None
        self.track_health = bool(track_health)
        self.training_health: TrainingHealth | None = None
        self.worker_states: list[TrainState | None] = []
        self.window_times: list[list[tuple[float, int]]] = []

    def _allocate_protocol(self, **kwargs) -> AsyncProtocol:
        return self.protocol_cls(**kwargs)

    def _device_cache_budget(self, state_bytes: int) -> int:
        """Device bytes one worker may spend keeping its partition resident:
        the card's memory less three times the training state (weights and
        optimizer slots, their gradients, the window's snapshot) less a
        quarter for activations; the 256 MB constant on the CPU."""
        if self.device.type == "cuda":
            _, limit = torch.cuda.mem_get_info(self.device)
            return max(0, limit - 3 * int(state_bytes) - limit // 4)
        return self._DEVICE_CACHE_LIMIT

    def _use_device_cache(self, part: Dataset, state_bytes: int = 0) -> bool:
        if not self.device_cache:
            return False
        if self.device_cache == "auto":
            size = sum(np.asarray(part[c]).nbytes for c in (self.features_col, self.label_col))
            budget = self._device_cache_budget(state_bytes)
            use = size < budget
            logging.getLogger(__name__).info(
                "device_cache auto: partition %.1f MB vs budget %.1f MB (device=%s, "
                "state %.1f MB) -> %s", size / 2**20, budget / 2**20, self.device,
                state_bytes / 2**20, "cache" if use else "host feed")
            return use
        return True

    # reference API parity: DistributedTrainer.service()/stop_service()
    def service(self, center_params: dict) -> ParameterServerService:
        budget_fn = getattr(self.protocol, "host_state_budget", None)
        if budget_fn is not None:
            n_params = sum(v.numel() for v in center_params.values())
            logging.getLogger(__name__).info(
                "PS host-state budget (%s): %.1f MB worst-case (%d workers, %d params, "
                "mirror_dtype=%s)", self.protocol.name,
                budget_fn(n_params, self.num_workers) / 2**20, self.num_workers, n_params,
                getattr(self.protocol, "mirror_dtype", "n/a"))
        self.parameter_server = ParameterServerService(
            self.protocol, center_params, self.num_workers,
            registry=self.registry, health=self.training_health)
        self.parameter_server.start()
        return self.parameter_server

    def stop_service(self) -> None:
        if self.parameter_server is not None:
            self.parameter_server.stop()

    def _put(self, tree: dict) -> dict:
        """A fresh copy of ``tree`` on the trainer's device (never an alias
        of the tree, so it can serve as the next window's baseline)."""
        return {k: v.to(self.device, non_blocking=True, copy=True) for k, v in tree.items()}

    def train(self, dataset: Dataset, shuffle: bool = False) -> TrainedModel:
        """Train ``num_workers`` workers asynchronously against the PS and
        return the final center on the trainer's device. ``history`` holds
        every step of every worker, tagged with its ``worker``."""
        if self.publisher is not None:
            raise ValueError("a weight publisher needs deploy/, which is not ported yet "
                             "(ROADMAP.md §A item 8)")
        self.record_training_start()
        optimizer = self.protocol.local_optimizer(self._optimizer())
        window_fn = make_window_train_step(self.model, self.loss, self.metrics)
        cached_window_fn = make_cached_window_train_step(self.model, self.loss, self.metrics)
        init_state = TrainState.create(self.model, optimizer, self.seed, self.device)
        center_init = {k: v.detach() for k, v in init_state.params.items()}
        del init_state
        self.training_health = None
        if self.track_health:
            self.training_health = TrainingHealth(
                registry=self.registry, num_workers=self.num_workers,
                protocol=self.protocol.name)
            self.training_health.set_params_bytes(_tree_bytes(center_init))
        health = self.training_health
        ps = self.service(center_init)
        del center_init

        nw = self.num_workers
        partitions = dataset.partitions(nw * self.parallelism_factor)
        window = self.protocol.communication_window
        # Per worker: (stacked window metrics on the device, window length,
        # completion wall time), read to the host after the join.
        win_histories: list[list[tuple[dict, int, float]]] = [[] for _ in range(nw)]
        self.worker_states = [None] * nw
        errors: list[BaseException | None] = [None] * nw

        def worker_loop(widx: int):
            try:
                stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
                with _on_stream(stream):
                    self._worker(widx, stream, optimizer, partitions[widx::nw], window,
                                 shuffle, window_fn, cached_window_fn, win_histories[widx])
                    if stream is not None:
                        stream.synchronize()
            except BaseException as e:  # surfaced to the caller below
                errors[widx] = e

        threads = [threading.Thread(target=worker_loop, args=(w,), name=f"worker-{w}")
                   for w in range(nw)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        center = ps.get_model()
        self.stop_service()
        for e in errors:
            if e is not None:
                raise e

        self.history = []
        # Per-worker (wall_time, window_len) pairs: steady-state throughput
        # without touching history.
        self.window_times = [[(t, wsize) for _, wsize, t in hist] for hist in win_histories]
        for w, hist in enumerate(win_histories):
            for ms, wsize, _ in hist:
                keys = list(ms)
                rows = torch.stack([ms[k].float() for k in keys], dim=1).tolist()
                self.history.extend({**dict(zip(keys, row)), "worker": w} for row in rows)
        model_state = next((st.model_state for st in self.worker_states if st.model_state), {})
        variables = {**self._put(center), **model_state}
        self.record_training_stop()
        return TrainedModel(self.model, variables)

    def _worker(self, widx, stream, optimizer, my_parts, window, shuffle, window_fn,
                cached_window_fn, win_history):
        """One worker's run, on the calling thread's current stream."""
        health = self.training_health
        protocol = self.protocol
        client = self.parameter_server.client()
        if self.compress_deltas:
            client = CompressingClient(client)
        # Stamped commit ids + PS dedupe: exactly-once commits.
        client = StampingClient(client, widx)
        center, carry = protocol.worker_begin(client, None)
        if health is not None:
            health.record_pull(widx)
        # The worker's own state from its seed, its weights then set to the
        # center in place and a fresh optimizer over them.
        state = TrainState.create(self.model, optimizer, worker_seed(self.seed, widx), self.device)
        self.worker_states[widx] = state
        keys = list(state.params)
        params = [state.params[k] for k in keys]
        base = self._put(center)
        with torch.no_grad():
            torch._foreach_copy_(params, [base[k] for k in keys])
        carry.window_start = base

        exchanger = xstream = None
        if self.overlap_window:
            exchanger = ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"ps-exchange-{widx}")
            xstream = torch.cuda.Stream(self.device) if stream is not None else None

        def exchange(snap, carry, ready):
            # The helper thread's own stream, after the worker's snapshot.
            with _on_stream(xstream):
                if ready is not None:
                    xstream.wait_event(ready)
                with span("ps_exchange", worker=widx):
                    return protocol.worker_window(snap, carry, client)

        def adopt(new_params, new_carry, snap=None):
            """Write the exchange's result into the optimizer's tensors:
            the new params, or with ``snap`` the rebase ``new + (now -
            snap)``; the placed copy becomes the next window's baseline."""
            with span("ps_to_device", worker=widx):
                base = self._put(new_params)
            with torch.no_grad():
                if snap is None:
                    torch._foreach_copy_(params, [base[k] for k in keys])
                else:
                    torch._foreach_sub_(params, [snap[k] for k in keys])
                    torch._foreach_add_(params, [base[k] for k in keys])
            new_carry.window_start = base
            return new_carry

        def drive(state, carry, pending, windows, exec_window):
            """One window at a time: compute, record, rebase the previous
            exchange, launch the next."""
            for item in windows:
                with span("window_step", worker=widx):
                    state, ms, wsize = exec_window(state, item)
                    if stream is not None:
                        stream.synchronize()
                win_history.append((ms, wsize, time.time()))
                if health is not None:
                    health.record_window(widx, wsize)
                if pending is not None:
                    fut, snap = pending
                    with span("ps_rebase", worker=widx):
                        carry = adopt(*fut.result(), snap=snap)
                    if health is not None:
                        health.record_rebase(widx)
                    pending = None
                if exchanger is not None:
                    snap = {k: p.detach().clone() for k, p in zip(keys, params)}
                    ready = None
                    if stream is not None:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    pending = (exchanger.submit(exchange, snap, carry, ready), snap)
                else:
                    with span("ps_exchange", worker=widx):
                        new_params, carry = protocol.worker_window(state.params, carry, client)
                    carry = adopt(new_params, carry)
            return state, carry, pending

        seed_w = worker_seed(self.seed, widx) if shuffle else None
        pending = None
        try:
            for part in my_parts:
                state_bytes = _tree_bytes(state.params) + sum(
                    _tree_bytes({k: v for k, v in s.items() if isinstance(v, torch.Tensor)})
                    for s in state.optimizer.state.values())
                if self._use_device_cache(part, state_bytes):
                    # The partition lives on the device whole; each step
                    # gathers its batch there from [W, B] index arrays.
                    xcol = torch.from_numpy(np.ascontiguousarray(part[self.features_col])
                                            ).to(self.device)
                    ycol = torch.from_numpy(np.asarray(part[self.label_col])).to(self.device)

                    def exec_cached(state, idx, xcol=xcol, ycol=ycol):
                        ix = torch.from_numpy(idx).to(self.device, non_blocking=True)
                        state, ms = cached_window_fn(state, xcol, ycol, ix)
                        return state, ms, int(idx.shape[0])

                    state, carry, pending = drive(
                        state, carry, pending,
                        index_windows(part.num_rows, self.batch_size, window,
                                      self.num_epoch, seed_w),
                        exec_cached)
                else:
                    feed = DeviceFeed(
                        window_batches(minibatches(part, self.batch_size, self.features_col,
                                                   self.label_col, num_epoch=self.num_epoch,
                                                   seed=seed_w), window),
                        self.device, buffer_size=2)

                    def exec_fed(state, wbatch):
                        state, ms = window_fn(state, wbatch)
                        return state, ms, int(wbatch["features"].shape[0])

                    state, carry, pending = drive(state, carry, pending, feed, exec_fed)
            if pending is not None:
                fut, snap = pending
                pending = None
                carry = adopt(*fut.result(), snap=snap)
        finally:
            if exchanger is not None:
                exchanger.shutdown(wait=True)


class DOWNPOUR(AsynchronousDistributedTrainer):
    """Downpour SGD (reference ``DOWNPOUR``)."""

    protocol_cls = DOWNPOURProtocol

    def __init__(self, *args, communication_window: int = 5, **kwargs):
        super().__init__(*args, communication_window=communication_window, **kwargs)


class ADAG(AsynchronousDistributedTrainer):
    """Asynchronous Distributed Adaptive Gradients: accumulated-gradient
    normalization (reference ``ADAG``)."""

    protocol_cls = ADAGProtocol

    def __init__(self, *args, communication_window: int = 12, **kwargs):
        super().__init__(*args, communication_window=communication_window, **kwargs)


class AEASGD(AsynchronousDistributedTrainer):
    """Asynchronous Elastic Averaging SGD (reference ``AEASGD``).

    ``alpha = rho * learning_rate`` is the rate at which the center tracks
    the workers per exchange, and the returned model is the center: with
    adam-scale learning rates (1e-3), scale ``rho`` up to land alpha in a
    working 0.05-0.5 band."""

    protocol_cls = AEASGDProtocol

    def __init__(self, *args, communication_window: int = 32, rho: float = 5.0,
                 learning_rate: float = 0.1, **kwargs):
        super().__init__(*args, communication_window=communication_window, rho=rho,
                         learning_rate=learning_rate, **kwargs)

    def _allocate_protocol(self, **kwargs):
        # The elastic force uses the local optimizer's learning rate, as the
        # reference's AEASGD kwargs couple them.
        kwargs.setdefault("learning_rate",
                          self.learning_rate if self.learning_rate is not None else 0.1)
        return self.protocol_cls(**kwargs)


class EAMSGD(AEASGD):
    """Elastic Averaging Momentum SGD (reference ``EAMSGD``)."""

    protocol_cls = EAMSGDProtocol

    def __init__(self, *args, momentum: float = 0.9, **kwargs):
        super().__init__(*args, momentum=momentum, **kwargs)


class DynSGD(AsynchronousDistributedTrainer):
    """Staleness-damped async SGD (reference ``DynSGD``)."""

    protocol_cls = DynSGDProtocol

    def __init__(self, *args, communication_window: int = 5, **kwargs):
        super().__init__(*args, communication_window=communication_window, **kwargs)

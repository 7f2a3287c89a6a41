"""Trainers: counterpart of ``distkeras_tpu/training/trainers.py``.

The :class:`Trainer` base (constructor surface, wall-clock bookkeeping,
step history, the telemetry surface: a per-step ``metric_stream`` and the
``train_*`` series published into a ``registry``, :meth:`Trainer.evaluate`);
:class:`SingleTrainer` (one step loop on one device);
:class:`EnsembleTrainer` and :class:`AveragingTrainer` (N replicas, each
with its own state, stepped in turn); :class:`SynchronousDistributedTrainer`
(data parallelism, on one device here, with step checkpoints and resume);
and the asynchronous parameter-server family,
:class:`AsynchronousDistributedTrainer` with ``DOWNPOUR``, ``ADAG``,
``AEASGD``, ``EAMSGD`` and ``DynSGD``: worker threads, each running its
windows on its own CUDA stream, exchange with one in-process parameter
server every ``communication_window`` steps, with periodic PS checkpoints
and resume. A recompile ``auditor`` signs each trainer's step, as the
reference's ``Trainer._audit`` wraps it. Not ported yet, and refused with
the ``ROADMAP.md`` item that brings them: multi-device islands and meshes.
A weight ``publisher`` (:class:`~distkeras_tpu_torch.deploy.WeightPublisher`)
publishes the live weights on its cadence: the step-loop trainers per
step, the asynchronous family the PS center from a thread of its own.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distkeras_tpu_torch.checkpoint import CheckpointManager
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.feed import DeviceFeed, index_windows, minibatches, window_batches
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.ops.losses import get_loss, get_optimizer
from distkeras_tpu_torch.parallel.ha import CompressingClient, RetryingClient, StampingClient
from distkeras_tpu_torch.parallel.protocols import (
    ADAGProtocol,
    AEASGDProtocol,
    AsyncProtocol,
    DOWNPOURProtocol,
    DynSGDProtocol,
    EAMSGDProtocol,
)
from distkeras_tpu_torch.parallel.ps import ParameterServerService
from distkeras_tpu_torch.parallel.ps_grpc import GrpcClient, GrpcParameterServer, _import_grpc
from distkeras_tpu_torch.telemetry.registry import sanitize_metric_name
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.telemetry.training_health import TrainingHealth
from distkeras_tpu_torch.training.step import (
    TrainState,
    make_cached_window_train_step,
    make_eval_step,
    make_train_step,
    make_window_train_step,
)
from distkeras_tpu_torch.utils.bridge import params_to_jax
from distkeras_tpu_torch.utils.device import resolve_device
from distkeras_tpu_torch.utils.pytree import to_host
from distkeras_tpu_torch.utils.rng import worker_seed

__all__ = [
    "Trainer",
    "SingleTrainer",
    "EnsembleTrainer",
    "AveragingTrainer",
    "SynchronousDistributedTrainer",
    "AsynchronousDistributedTrainer",
    "DOWNPOUR",
    "ADAG",
    "AEASGD",
    "EAMSGD",
    "DynSGD",
]


class _StepCheckpointer:
    """Save and resume for the step-loop trainers (reference ``trainers.py:87-138``):
    restore the latest step into the live state, timed ``wait=False`` saves
    during the loop, a final blocking save, and a ``close()`` safe to call
    from ``finally``, so a crash mid-train still finishes an in-flight save."""

    def __init__(self, directory, interval_s, resume, like):
        self.mgr = None
        self.start_step = 0
        self.state = None
        self.interval_s = float(interval_s)
        if directory is None:
            return
        self.mgr = CheckpointManager(directory)
        if resume and self.mgr.latest_step() is not None:
            self.state = self.mgr.restore(like={"state": like})["state"]
            self.start_step = self.mgr.latest_step()
        self._last = time.monotonic()

    def maybe_save(self, step, state):
        if self.mgr is not None and time.monotonic() - self._last >= self.interval_s:
            with span("checkpoint_save", step=step):
                self.mgr.save(step, state=state, wait=False)
            self._last = time.monotonic()

    def finalize(self, step, state):
        if self.mgr is not None and step > self.start_step:
            # Skipped when maybe_save already saved this very step in the
            # background; then the wait is for that write.
            with span("checkpoint_save", step=step):
                self.mgr.save(step, state=state)
            self.mgr.wait_until_finished()

    def close(self):
        if self.mgr is not None:
            self.mgr.close()
            self.mgr = None


def _step_signature(args, kwargs):
    """What a trainer's step is signed by: the state's tensors (the Python
    step counter the port's ``TrainState`` keeps is a device scalar of
    fixed shape in the reference's) and the step's other arguments."""
    state, *rest = args
    return (state.params, state.model_state, *rest)


class Trainer:
    """Base trainer: holds the model spec, loss, worker optimizer name,
    the device and wall-clock bookkeeping. ``device`` defaults to CUDA and
    raises without one; pass ``"cpu"`` to run on the host.

    Telemetry: ``metric_stream`` (anything with ``.emit(i, record)``) gets
    every history row after ``train()``; a ``registry``
    (:class:`~distkeras_tpu_torch.telemetry.registry.MetricsRegistry`) gets
    ``train_steps_total``, ``train_time_seconds`` and a ``train_last_<key>``
    gauge per numeric metric of the last row. The replica trainers, as the
    reference's, emit neither. ``auditor`` (a
    :class:`~distkeras_tpu_torch.telemetry.recompile.RecompileAuditor`)
    wraps each ``train()``'s step under the reference's name
    (``train_step``, ``vmapped_step``, ``sync_train_step``,
    ``async_window_step``, ``async_cached_window_step``) and counts its
    abstract signatures: the state's tensors and the batch. ``publisher``
    (a :class:`~distkeras_tpu_torch.deploy.WeightPublisher`, None by
    default) publishes the reference-layout weight tree on its cadence;
    the replica trainers, as the reference's, never call it."""

    def __init__(
        self,
        keras_model: Model,
        worker_optimizer="adagrad",
        loss: str = "categorical_crossentropy",
        metrics: tuple[str, ...] = ("accuracy",),
        learning_rate: float | None = None,
        seed: int = 0,
        loss_weights=None,
        metric_stream=None,
        registry=None,
        auditor=None,
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
        self.metric_stream = metric_stream
        self.registry = registry
        self.auditor = auditor
        # Optional deploy.WeightPublisher: the trainer side of the
        # continuous-deployment loop. Step-loop trainers call
        # _maybe_publish per step; the async family publishes the PS
        # center from a dedicated thread.
        self.publisher = None
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
        """Mean of each metric over the recorded steps (and over replicas,
        for the replica trainers, whose per-step metrics are arrays);
        non-numeric keys are skipped."""
        if not self.history:
            return {}
        out = {}
        for k in self.history[0]:
            try:
                out[k] = float(np.mean([np.mean(np.asarray(h[k]))
                                        for h in self.history if k in h]))
            except (TypeError, ValueError):
                continue
        return out

    def _emit_history(self) -> None:
        """Hand the history to the metric stream and the registry
        (reference ``trainers.py:227-244``)."""
        if self.metric_stream is not None:
            for i, h in enumerate(self.history):
                self.metric_stream.emit(i, h)
        if self.registry is not None and self.history:
            self.registry.counter("train_steps_total", help="train steps recorded"
                                  ).inc(len(self.history))
            self.registry.gauge("train_time_seconds", help="wall clock of the last train()"
                                ).set(self.get_training_time())
            for k, v in self.history[-1].items():
                if isinstance(v, (int, float)):
                    self.registry.gauge("train_last_" + sanitize_metric_name(k),
                                        help="last-step train metric").set(v)

    def _audit(self, step_fn, name: str):
        """Wrap a step with the attached recompile auditor (no-op without
        one), signed by the state's tensors and the step's other
        arguments. Auditor names are unique per auditor, so a second
        train() on the same trainer runs unaudited rather than failing
        (reference ``Trainer._audit``)."""
        if self.auditor is None:
            return step_fn
        try:
            return self.auditor.wrap(step_fn, name, signature=_step_signature)
        except ValueError:  # name already wrapped (trainer re-used)
            return step_fn

    def _maybe_publish(self, step: int, variables_fn, loss_fn=None) -> None:
        """Per-step publish hook (no-op without a publisher). Both callables
        are lazy: an idle cadence costs two comparisons, no device sync and
        no host copy."""
        if self.publisher is not None:
            self.publisher.maybe_publish(variables_fn, step=step, loss_fn=loss_fn)

    def _published_tree(self, variables: dict) -> dict:
        """The reference-layout weight tree (``{"params": ...}``) of a flat
        ``state_dict``, on the host: what a publish writes, so either
        package's serving fleet loads it."""
        return params_to_jax(to_host(variables), self.model.module)

    def _publish_step(self, step_no: int, state, m: dict) -> None:
        """:func:`_run_steps`'s per-step hook: the live weights and the
        step's loss, both read only when the cadence fires."""
        self._maybe_publish(step_no, lambda: self._published_tree(state.variables),
                            loss_fn=lambda: float(m["loss"]))

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
        metric_stream=None,
        registry=None,
        auditor=None,
        device: str | torch.device | None = None,
    ):
        super().__init__(keras_model, worker_optimizer, loss, metrics,
                         learning_rate=learning_rate, seed=seed,
                         loss_weights=loss_weights, metric_stream=metric_stream,
                         registry=registry, auditor=auditor, device=device)
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
        step_fn = self._audit(make_train_step(
            self.model, self.loss, self.metrics, remat=self.remat,
            aux_loss_weight=self.aux_loss_weight, grad_accum_steps=self.grad_accum_steps,
        ), "train_step")
        state = TrainState.create(self.model, self._optimizer(), self.seed, self.device)
        history: list[dict] = []
        self.validation_history = []
        for epoch in range(self.num_epoch):
            batches = minibatches(
                dataset, self.batch_size, self.features_col, self.label_col,
                num_epoch=1, seed=(self.seed + epoch) if shuffle else None,
            )
            state, _ = _run_steps(step_fn, state, batches, self.device, history,
                                  step_no=len(history), publish=self._publish_step)
            if self.validation_data is not None:
                with span("validation", epoch=epoch):
                    val = self.evaluate(
                        TrainedModel(self.model, state.variables), self.validation_data,
                        features_col=self.features_col, label_col=self.label_col,
                    )
                self.validation_history.append(
                    {"epoch": epoch, **{f"val_{k}": v for k, v in val.items()}})
        self.history = _read_history(history)
        self._emit_history()
        self.record_training_stop()
        return TrainedModel(self.model, {k: v.detach() for k, v in state.variables.items()})


def _run_steps(step_fn, state, batches, device, history: list, ck=None, step_no: int = 0,
               publish=None):
    """The one-device step loop: ``batches`` through :class:`DeviceFeed`
    onto ``device``, one ``step_fn`` a batch, each step's metrics appended
    to ``history``; with a :class:`_StepCheckpointer`, a timed save after
    each step, and with ``publish`` (``publish(step_no, state, metrics)``)
    the trainer's publish hook. ``step_no`` is the count of steps before
    ``batches``. Returns the state and the count after them."""
    for batch in DeviceFeed(batches, device, buffer_size=2):
        with span("train_step"):
            state, m = step_fn(state, batch)
        history.append(m)
        step_no += 1
        if ck is not None:
            ck.maybe_save(step_no, state)
        if publish is not None:
            publish(step_no, state, m)
    return state, step_no


def _read_history(history: list[dict]) -> list[dict]:
    """Per-step metric dicts of device tensors -> dicts of floats (of
    ``[replicas]`` float32 arrays for the replica trainers' rows), in one
    read from the device."""
    if not history:
        return []
    keys = list(history[0])
    table = torch.stack([torch.stack([h[k] for k in keys]) for h in history]).cpu()
    rows = table.tolist() if table.ndim == 2 else table.float().numpy()
    return [dict(zip(keys, row)) for row in rows]


class _ReplicasTrainer(Trainer):
    """The engine of :class:`EnsembleTrainer` and :class:`AveragingTrainer`
    (reference ``_VmappedReplicasTrainer``, ``trainers.py:391-510``): N
    replicas, replica ``i`` with its own :class:`TrainState` from seed
    ``worker_seed(seed, i)`` on partition ``i`` of the data. The reference
    vmaps the N steps into one program; here the N states are stepped in
    turn on the trainer's device, one group of N batches at a time, so each
    replica sees the batches the reference's replica ``i`` sees. One device
    needs no padded replicas. The lock-step stops at the shortest partition's
    stream; ``dropped_batches`` counts each replica's tail batches not
    stepped. History rows hold each metric as a ``[num_models]`` array."""

    def __init__(
        self,
        keras_model: Model,
        worker_optimizer="adagrad",
        loss="categorical_crossentropy",
        metrics=("accuracy",),
        num_models: int = 2,
        features_col: str = "features",
        label_col: str = "label",
        batch_size: int = 32,
        num_epoch: int = 1,
        learning_rate: float | None = None,
        seed: int = 0,
        loss_weights=None,
        metric_stream=None,
        registry=None,
        auditor=None,
        device: str | torch.device | None = None,
    ):
        super().__init__(keras_model, worker_optimizer, loss, metrics,
                         learning_rate=learning_rate, seed=seed,
                         loss_weights=loss_weights, metric_stream=metric_stream,
                         registry=registry, auditor=auditor, device=device)
        self.num_models = int(num_models)
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.dropped_batches: list[int] = []

    def _train_replicas(self, dataset: Dataset, shuffle: bool) -> list[TrainState]:
        n = self.num_models
        step_fn = self._audit(make_train_step(self.model, self.loss, self.metrics),
                              "vmapped_step")
        states = [TrainState.create(self.model, self._optimizer(), worker_seed(self.seed, i),
                                    self.device) for i in range(n)]
        parts = dataset.partitions(n)
        streams = [minibatches(parts[i], self.batch_size, self.features_col, self.label_col,
                               num_epoch=self.num_epoch,
                               seed=worker_seed(self.seed, i) if shuffle else None)
                   for i in range(n)]

        history = []
        # Lock-step: ends with the first stream that ends, as the reference's does.
        for group in zip(*(DeviceFeed(s, self.device, buffer_size=2) for s in streams)):
            with span("train_step"):
                row = []
                for i, batch in enumerate(group):
                    states[i], m = step_fn(states[i], batch)
                    row.append(m)
            history.append({k: torch.stack([m[k] for m in row]) for k in row[0]})
        steps = len(history)
        expected = [self.num_epoch * (parts[i].num_rows // self.batch_size) for i in range(n)]
        self.dropped_batches = [e - steps for e in expected]
        if any(self.dropped_batches):
            logging.getLogger(__name__).warning(
                "replica lock-step stopped at %d steps; tail batches dropped per replica: %s "
                "(uneven partitions: replica i gets rows//batch_size=%s batches/epoch)",
                steps, self.dropped_batches, [e // max(self.num_epoch, 1) for e in expected])
        self.history = _read_history(history)
        return states


class EnsembleTrainer(_ReplicasTrainer):
    """Train N independent models and return all of them (reference
    ``EnsembleTrainer``)."""

    def train(self, dataset: Dataset, shuffle: bool = False) -> list[TrainedModel]:
        self.record_training_start()
        states = self._train_replicas(dataset, shuffle)
        models = [TrainedModel(self.model, {k: v.detach() for k, v in st.variables.items()})
                  for st in states]
        self.record_training_stop()
        return models


class AveragingTrainer(_ReplicasTrainer):
    """Train N models side by side and return the mean of their weights and
    model states (reference ``AveragingTrainer``)."""

    def __init__(self, *args, num_workers: int = 2, **kwargs):
        kwargs.setdefault("num_models", num_workers)
        super().__init__(*args, **kwargs)
        self.num_workers = self.num_models

    def train(self, dataset: Dataset, shuffle: bool = False) -> TrainedModel:
        self.record_training_start()
        states = self._train_replicas(dataset, shuffle)
        with torch.no_grad():
            averaged = {k: torch.stack([st.variables[k] for st in states]).mean(dim=0)
                        for k in states[0].variables}
        self.record_training_stop()
        return TrainedModel(self.model, averaged)


class SynchronousDistributedTrainer(Trainer):
    """Synchronous data parallelism (reference
    ``SynchronousDistributedTrainer``, ``trainers.py:565-709``, its
    data-parallel branch): the global batch is ``batch_size`` times the
    data-parallel size, which on the one device the port trains on is 1.
    ``num_workers`` above the devices in use raises as the reference's
    ``best_mesh`` does. Checkpoints: with ``checkpoint_dir`` the state is
    saved every ``checkpoint_interval_s`` (in the background) and at the
    end; ``resume=True`` restores the latest step into the state and
    fast-forwards the deterministic batch stream past it, so a resumed run
    reproduces the uninterrupted one. Model axes in ``mesh``, ``zero1``,
    ``shard_sequence`` and a process group of more than one rank are
    multi-device work and raise; ``mesh`` is a mapping of axis sizes
    (``{"dp": 1}``), as the reference's ``make_mesh`` takes."""

    def __init__(
        self,
        keras_model: Model,
        worker_optimizer="adagrad",
        loss="categorical_crossentropy",
        metrics=("accuracy",),
        num_workers: int | None = None,
        batch_size: int = 32,
        features_col: str = "features",
        label_col: str = "label",
        num_epoch: int = 1,
        learning_rate: float | None = None,
        seed: int = 0,
        mesh=None,
        zero1: bool = False,
        shard_sequence: bool = False,
        aux_loss_weight: float = 0.01,
        checkpoint_dir: str | None = None,
        checkpoint_interval_s: float = 60.0,
        resume: bool = False,
        loss_weights=None,
        metric_stream=None,
        registry=None,
        auditor=None,
        device: str | torch.device | None = None,
    ):
        super().__init__(keras_model, worker_optimizer, loss, metrics,
                         learning_rate=learning_rate, seed=seed,
                         loss_weights=loss_weights, metric_stream=metric_stream,
                         registry=registry, auditor=auditor, device=device)
        self.num_workers = num_workers
        self.batch_size = int(batch_size)
        self.features_col = features_col
        self.label_col = label_col
        self.num_epoch = int(num_epoch)
        self.mesh = mesh
        self.zero1 = bool(zero1)
        self.shard_sequence = bool(shard_sequence)
        self.aux_loss_weight = float(aux_loss_weight)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval_s = float(checkpoint_interval_s)
        self.resume = bool(resume)

    def _data_parallel_size(self) -> int:
        """The data-parallel size, 1: what else the reference's mesh paths
        do is refused (ROADMAP.md §A item A10)."""
        later = "multi-device training, which is not ported yet (ROADMAP.md §A item A10)"
        if self.zero1:
            raise ValueError(f"zero1 needs {later}")
        if self.shard_sequence:
            raise ValueError(f"shard_sequence needs {later}")
        if (torch.distributed.is_available() and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise ValueError(f"a process group of more than one rank needs {later}")
        devices = 1
        if self.num_workers is not None and self.num_workers > devices:
            raise ValueError(f"requested {self.num_workers} devices but only {devices} "
                             f"are attached; reduce num_workers or run on more chips")
        if self.mesh is not None:
            sizes = dict(self.mesh)
            model_axes = {a: n for a, n in sizes.items() if a != "dp" and n > 1}
            if model_axes:
                raise ValueError(f"mesh axes {model_axes} need {later}")
            if sizes.get("dp", 1) > devices:
                raise ValueError(f"mesh dp={sizes['dp']} but only {devices} device is used")
        return 1

    def train(self, dataset: Dataset, shuffle: bool = False) -> TrainedModel:
        """Train ``num_epoch`` epochs (rows reshuffled each epoch with
        ``seed + epoch`` when ``shuffle``), resuming from ``checkpoint_dir``
        when asked, and return the trained model on the trainer's device."""
        global_batch = self.batch_size * self._data_parallel_size()
        self.record_training_start()
        step_fn = self._audit(make_train_step(self.model, self.loss, self.metrics,
                                              aux_loss_weight=self.aux_loss_weight),
                              "sync_train_step")
        state = TrainState.create(self.model, self._optimizer(), self.seed, self.device)
        ck = _StepCheckpointer(self.checkpoint_dir, self.checkpoint_interval_s, self.resume,
                               like=state)
        if ck.state is not None:
            state = ck.state
        batches = minibatches(dataset, global_batch, self.features_col, self.label_col,
                              num_epoch=self.num_epoch, seed=self.seed if shuffle else None,
                              start_batch=ck.start_step)
        history = []
        try:
            state, step_no = _run_steps(step_fn, state, batches, self.device, history, ck,
                                        ck.start_step, publish=self._publish_step)
            ck.finalize(step_no, state)
        finally:
            ck.close()
        self.history = _read_history(history)
        self._emit_history()
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

    With ``checkpoint_dir``, a ``ps-checkpoint`` thread saves the PS center
    and update count every ``checkpoint_interval_s`` (a failure is logged
    and counted in the PS's ``snapshot_failures``, never raised), and the
    final center is saved after the workers end, each as step
    ``num_commits`` with ``meta={"weight_version": num_commits}``.
    ``resume=True`` starts the PS from the latest saved center; its update
    count restarts at 0, as the reference's does.

    ``transport="grpc"`` puts the PS behind :class:`GrpcParameterServer` on
    ``master_host:master_port`` (loopback and a free port by default) and
    gives each worker a :class:`GrpcClient` wrapped in
    :class:`RetryingClient`; it needs the ``grpcio`` package.

    Not ported yet, and refused: ``devices_per_worker > 1`` and a weight
    ``publisher``.
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
        metric_stream=None,
        registry=None,
        auditor=None,
        device: str | torch.device | None = None,
        **protocol_kwargs,
    ):
        super().__init__(keras_model, worker_optimizer, loss, metrics,
                         learning_rate=learning_rate, seed=seed,
                         loss_weights=loss_weights, metric_stream=metric_stream,
                         registry=registry, auditor=auditor, device=device)
        if transport not in ("inprocess", "grpc"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "grpc":
            _import_grpc()  # fail here, not inside a worker thread
        if int(devices_per_worker) != 1:
            raise ValueError("devices_per_worker > 1 (multi-device islands) is not ported "
                             "yet (ROADMAP.md §A item 10)")
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
        if communication_window is not None:
            protocol_kwargs["communication_window"] = communication_window
        self.protocol = self._allocate_protocol(**protocol_kwargs)
        self.communication_window = self.protocol.communication_window
        self.parameter_server: ParameterServerService | None = None
        self._grpc_ps: GrpcParameterServer | None = None
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
        if self.transport == "grpc":
            grpc_ps = GrpcParameterServer(
                self.protocol, center_params, self.num_workers,
                port=self.master_port or 0, registry=self.registry,
                health=self.training_health)
            self.master_port = grpc_ps.start()
            if self.master_host is None:
                self.master_host = "127.0.0.1"
            self._grpc_ps = grpc_ps
            self.parameter_server = grpc_ps.service
            return self.parameter_server
        self.parameter_server = ParameterServerService(
            self.protocol, center_params, self.num_workers,
            registry=self.registry, health=self.training_health)
        self.parameter_server.start()
        return self.parameter_server

    def _make_client(self):
        if self.transport == "grpc":
            return RetryingClient(GrpcClient(self.master_host, self.master_port))
        return self.parameter_server.client()

    def stop_service(self) -> None:
        if self._grpc_ps is not None:
            self._grpc_ps.stop()
            self._grpc_ps = None
        elif self.parameter_server is not None:
            self.parameter_server.stop()

    def _put(self, tree: dict) -> dict:
        """A fresh copy of ``tree`` on the trainer's device (never an alias
        of the tree, so it can serve as the next window's baseline)."""
        return {k: v.to(self.device, non_blocking=True, copy=True) for k, v in tree.items()}

    def train(self, dataset: Dataset, shuffle: bool = False) -> TrainedModel:
        """Train ``num_workers`` workers asynchronously against the PS and
        return the final center on the trainer's device. ``history`` holds
        every step of every worker, tagged with its ``worker``."""
        self.record_training_start()
        optimizer = self.protocol.local_optimizer(self._optimizer())
        window_fn = self._audit(make_window_train_step(self.model, self.loss, self.metrics),
                                "async_window_step")
        cached_window_fn = self._audit(
            make_cached_window_train_step(self.model, self.loss, self.metrics),
            "async_cached_window_step")
        init_state = TrainState.create(self.model, optimizer, self.seed, self.device)
        center_init = {k: v.detach() for k, v in init_state.params.items()}
        del init_state
        self.training_health = None
        if self.track_health:
            self.training_health = TrainingHealth(
                registry=self.registry, num_workers=self.num_workers,
                protocol=self.protocol.name)
            self.training_health.set_params_bytes(_tree_bytes(center_init))
        ckpt_mgr = None
        if self.checkpoint_dir is not None:
            ckpt_mgr = CheckpointManager(self.checkpoint_dir)
            if self.resume and ckpt_mgr.latest_step() is not None:
                restored = ckpt_mgr.restore(like={"ps": {"center": center_init, "num_updates": 0}})
                center_init = {k: v.to(self.device) for k, v in restored["ps"]["center"].items()}
        ps = self.service(center_init)
        del center_init
        stop_ckpt = threading.Event()
        ckpt_thread = None
        pub_stop = threading.Event()
        pub_thread = None
        # The newest window's loss tensor (already synchronized by its
        # worker): the publisher thread reads one float of it lazily.
        self._publish_loss = None
        svc = self.parameter_server if self.parameter_server is not None else ps
        try:
            if self.publisher is not None:
                # Continuous deployment: a dedicated thread publishes the PS
                # CENTER on the publisher's cadence; the workers' loops only
                # keep a reference to their newest window loss.
                def publish_loss_now():
                    arr = self._publish_loss
                    return None if arr is None else float(arr.reshape(-1)[-1])

                def publish_loop():
                    while not pub_stop.wait(0.2):
                        try:
                            self.publisher.maybe_publish(
                                lambda: self._published_tree(svc.get_model()),
                                step=svc.num_commits, loss_fn=publish_loss_now)
                        except Exception:
                            # The publisher swallows its own failures; this
                            # guards the PS accessors, so one surprise does
                            # not end publishing for the rest of the run.
                            logging.getLogger(__name__).exception(
                                "weight-publisher tick failed")

                pub_thread = threading.Thread(target=publish_loop, name="weight-publisher",
                                              daemon=True)
                pub_thread.start()
            if ckpt_mgr is not None:
                ckpt_thread = threading.Thread(target=self._periodic_checkpoint,
                                               args=(ckpt_mgr, ps, stop_ckpt),
                                               name="ps-checkpoint", daemon=True)
                ckpt_thread.start()

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
            if pub_thread is not None:
                pub_stop.set()
                pub_thread.join(timeout=10)
                # Final snapshot: the publish directory ends on the run's
                # final center, even for runs shorter than one cadence.
                loss = self._publish_loss
                self.publisher.publish(
                    self._published_tree(center), step=int(svc.num_commits),
                    loss=None if loss is None else float(loss.reshape(-1)[-1]))
            if ckpt_mgr is not None:
                stop_ckpt.set()
                ckpt_thread.join(timeout=10)
                self._save_center(ckpt_mgr, ps, center)
        finally:
            # Also when anything above raised: no snapshot or publisher
            # thread, writer or PS loop outlives train().
            pub_stop.set()
            if pub_thread is not None:
                pub_thread.join(timeout=10)
            stop_ckpt.set()
            if ckpt_thread is not None:
                ckpt_thread.join(timeout=10)
            if ckpt_mgr is not None:
                ckpt_mgr.close()
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
        self._emit_history()
        self.record_training_stop()
        return TrainedModel(self.model, variables)

    @staticmethod
    def _save_center(mgr: CheckpointManager, ps: ParameterServerService, center=None) -> None:
        """Checkpoint the PS center as step ``num_commits``; the commit
        count is also the snapshot's weight version. A step at or below the
        latest saved one is skipped (no commit since, or a resumed run whose
        count restarted), as the reference's orbax manager skips it."""
        commits = int(ps.num_commits)
        latest = mgr.latest_step()
        if latest is not None and commits <= latest:
            return
        # get_model() of a running PS is already the caller's own CPU copy.
        mgr.save(commits, ps_center=ps.get_model() if center is None else center,
                 ps_num_updates=ps.num_updates, meta={"weight_version": commits},
                 copy=False)

    def _periodic_checkpoint(self, mgr: CheckpointManager, ps: ParameterServerService,
                             stop: threading.Event) -> None:
        """The ``ps-checkpoint`` thread (reference ``trainers.py:947-977``): a
        snapshot every ``checkpoint_interval_s``; a failure must not stop
        training, so it is logged (the first with its traceback) and
        counted in ``ps.snapshot_failures``."""
        log = logging.getLogger(__name__)
        while not stop.wait(self.checkpoint_interval_s):
            try:
                self._save_center(mgr, ps)
            except Exception:
                ps.snapshot_failures += 1
                if ps.snapshot_failures == 1:
                    log.exception("PS checkpoint snapshot failed")
                else:
                    log.warning("PS checkpoint snapshot failed (%d so far)",
                                ps.snapshot_failures)

    def _worker(self, widx, stream, optimizer, my_parts, window, shuffle, window_fn,
                cached_window_fn, win_history):
        """One worker's run, on the calling thread's current stream."""
        health = self.training_health
        protocol = self.protocol
        client = self._make_client()
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
                if self.publisher is not None:
                    self._publish_loss = ms["loss"]
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
            close = getattr(client, "close", None)  # a gRPC client's channel
            if close is not None:
                close()


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

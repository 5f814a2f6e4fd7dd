"""Estimator: fit / evaluate / predict on one device.

The counterpart of ``analytics_zoo_tpu/learn/estimator.py``. The
reference jits one SPMD step over a mesh; here the step is eager
PyTorch on one device (CUDA by default): forward with ``train=True`` and
an explicit ``torch.Generator`` for dropout, ``backward``, then the
optax-style transformation of ``learn/optim.py`` applied in place.

Carried over: the per-step ``fit`` loop with the epoch loss accumulated
on the device and read on the host only at ``zoo.train.log_every_n_steps``;
triggers seeing every step; validation; the checkpoint trigger;
``resume``; retry from the latest checkpoint on a failure
(``zoo.train.failure.*``); ``clip_norm``/``clip_value``;
``grad_accum_steps``; ``evaluate`` over every sample (the padded tail
masked out); ``predict``; ``save``/``load``; and ``device_cache=True``
(the dataset on the device, a permutation from the device generator, a
gather per step).

The model is an ``nn.Module`` whose ``forward(x, train=False, rng=None)``
follows the port's layers (a module without those keywords is called
without them). Meshes, ``param_spec_fn`` and MoE
``aux_loss_collections`` wait for the parallel and sharded item of
ROADMAP queue 1 and raise.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.common.triggers import (
    EveryEpoch, Trigger, TriggerState)
from analytics_zoo_tpu_torch.data.dataset import ZooDataset, to_device
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt_lib
from analytics_zoo_tpu_torch.learn.metrics import Loss, Metric, resolve_metric
from analytics_zoo_tpu_torch.learn.objectives import resolve_loss
from analytics_zoo_tpu_torch.learn.optim import (
    param_tree, resolve_optimizer, with_clipping)
from analytics_zoo_tpu_torch.obs.events import emit
from analytics_zoo_tpu_torch.obs.metrics import get_registry
from analytics_zoo_tpu_torch.utils.tree import tree_map

logger = get_logger(__name__)

_REG = get_registry()
_M_STEPS = _REG.counter(
    "zoo_learn_steps_total", "Optimization steps completed")
_M_EPOCHS = _REG.counter(
    "zoo_learn_epochs_total", "Training epochs completed")

_PARALLEL = ("is not ported yet: meshes, sharded parameters and MoE "
             "auxiliary losses arrive with the parallel and sharded item "
             "of ROADMAP queue 1")


def _as_dataset(data, labeled: bool = True) -> ZooDataset:
    """Coerce to ZooDataset. ``labeled=True`` splits a 2-tuple into
    (features, labels); predict paths pass ``labeled=False`` so a tuple is
    a multi-input feature tree."""
    if isinstance(data, ZooDataset):
        return data
    from analytics_zoo_tpu_torch.data.shard import XShards

    if isinstance(data, XShards):
        return ZooDataset.from_xshards(data)
    if labeled and isinstance(data, tuple) and len(data) == 2:
        return ZooDataset.from_ndarrays(data[0], data[1])
    return ZooDataset.from_ndarrays(data)


def _call_args(x) -> tuple:
    """Feature tree -> positional args for the model (tuple splats)."""
    return x if isinstance(x, tuple) else (x,)


def _stage(profiler, name: str):
    if profiler is not None:
        return profiler.timing(name)
    return contextlib.nullcontext()


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class Estimator:
    """fit/evaluate/predict on one device.

    Args:
      model: an ``nn.Module``; ``forward(x, train=..., rng=...)``.
      loss: loss name or ``fn(preds, labels) -> scalar``.
      optimizer: ZooOptimizer / GradientTransformation / name.
      metrics: list of Metric / names, tracked during evaluate and
        validation.
      clip_norm: global-L2 gradient clip; clip_value: symmetric clip.
      grad_accum_steps: k > 1 splits each batch into k microbatches and
        averages their gradients before one update.
      seed: seeds the generator for dropout and device-cached shuffles.
      device: where the model runs (default: where its parameters are).
    """

    def __init__(self, model: nn.Module, loss=None, optimizer="adam",
                 metrics: Sequence[Any] = (), mesh=None,
                 clip_norm: Optional[float] = None,
                 clip_value: Optional[float] = None,
                 param_spec_fn=None,
                 aux_loss_collections: Sequence[str] = (),
                 grad_accum_steps: int = 1, seed: int = 0, device=None):
        if mesh is not None:
            raise NotImplementedError(f"Estimator(mesh=...) {_PARALLEL}")
        if param_spec_fn is not None:
            raise NotImplementedError(f"Estimator(param_spec_fn=...) "
                                      f"{_PARALLEL}")
        if aux_loss_collections:
            raise NotImplementedError(f"Estimator(aux_loss_collections=...) "
                                      f"{_PARALLEL}")
        if int(grad_accum_steps) < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        self.model = model
        self.loss_fn = resolve_loss(loss) if loss is not None else None
        self.tx = with_clipping(resolve_optimizer(optimizer), clip_norm,
                                clip_value)
        self.metrics: List[Metric] = [resolve_metric(m) for m in metrics]
        self.grad_accum_steps = int(grad_accum_steps)
        self.seed = seed
        if device is None:
            first = next(model.parameters(), None)
            device = first.device if first is not None else None
        self.device = resolve_device(device)
        self.model.to(self.device)
        self.params = param_tree(model)
        self.opt_state = None
        self.global_step = 0
        self.epoch = 0
        self.last_profile = None  # set by fit(profile=True)
        self.generator = torch.Generator(self.device).manual_seed(int(seed))
        try:
            sig = set(inspect.signature(model.forward).parameters)
        except (TypeError, ValueError):
            sig = set()
        self._takes_train = "train" in sig
        self._takes_rng = "rng" in sig

    # ------------------------------------------------------------- setup --
    def _ensure_built(self) -> None:
        if self.opt_state is None:
            with torch.no_grad():
                self.opt_state = self.tx.init(
                    {k: p.detach() for k, p in self.params.items()})

    def _apply(self, x, training: bool):
        kwargs = {}
        if self._takes_train:
            kwargs["train"] = training
        if self._takes_rng and training:
            kwargs["rng"] = self.generator
        return self.model(*_call_args(x), **kwargs)

    # -------------------------------------------------------- train step --
    def _loss_and_grads(self, x, y) -> torch.Tensor:
        """Forward and backward; leaves the batch-mean gradient in each
        parameter's ``.grad`` and returns the loss (a device scalar)."""
        for p in self.params.values():
            p.grad = None
        k = self.grad_accum_steps
        if k == 1:
            loss = self.loss_fn(self._apply(x, training=True), y)
            loss.backward()
            return loss.detach()

        def split(a):
            if a.shape[0] % k:
                raise ValueError(f"grad_accum_steps={k} must divide the "
                                 f"batch dim, got {a.shape[0]}")
            return a.reshape(k, a.shape[0] // k, *a.shape[1:])

        xs, ys = tree_map(split, x), tree_map(split, y)
        loss_sum = torch.zeros((), device=self.device)
        for j in range(k):
            loss = self.loss_fn(
                self._apply(tree_map(lambda a: a[j], xs), training=True),
                tree_map(lambda a: a[j], ys))
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        grads = [p.grad for p in self.params.values() if p.grad is not None]
        torch._foreach_div_(grads, k)
        return loss_sum / k

    def _train_step(self, x, y) -> torch.Tensor:
        if self.loss_fn is None:
            raise ValueError("Estimator needs a loss to train")
        loss = self._loss_and_grads(x, y)
        with torch.no_grad():
            params = {k: p.detach() for k, p in self.params.items()}
            # a parameter the loss does not reach gets a zero gradient,
            # as under jax.grad
            grads = {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p))
                     for k, p in self.params.items()}
            updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                     params)
            keys = list(params)
            torch._foreach_add_([params[k] for k in keys],
                                [updates[k] for k in keys])
        return loss

    # --------------------------------------------------------------- fit --
    def fit(self, data, batch_size: int, epochs: int = 1,
            validation_data=None, validation_trigger: Optional[Trigger] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_trigger: Optional[Trigger] = None,
            log_dir: Optional[str] = None,
            resume: bool = False,
            device_cache: bool = False,
            profile: bool = False,
            trace_dir: Optional[str] = None) -> List[Dict[str, float]]:
        """Train to ``epochs`` completed epochs; returns per-epoch history.

        On an exception mid-epoch, if a checkpoint exists and fewer than
        ``zoo.train.failure.retry_times`` failures occurred within
        ``zoo.train.failure.retry_interval_s``, restore the latest
        snapshot and continue. ``device_cache=True`` keeps the whole
        dataset on the device (triggers, validation and checkpoints then
        run at epoch granularity). ``profile=True`` records stage timers
        into ``self.last_profile``; ``trace_dir`` also writes a
        torch.profiler trace there. ``log_dir`` is not supported yet
        (the reference's TensorBoard writer is still to be ported).
        """
        if log_dir is not None:
            raise NotImplementedError(
                "fit(log_dir=...): the summary writer "
                "(utils/summary.py) is not ported yet")
        cfg = get_config()
        dataset = _as_dataset(data)
        if dataset.num_samples == 0:
            raise ValueError("dataset is empty")
        val_dataset = (_as_dataset(validation_data)
                       if validation_data is not None else None)
        validation_trigger = validation_trigger or EveryEpoch()
        checkpoint_trigger = checkpoint_trigger or EveryEpoch()
        self._ensure_built()
        if resume and checkpoint_dir and \
                ckpt_lib.latest_step(checkpoint_dir) is not None:
            self._restore(checkpoint_dir)
        profiler = None
        if profile or trace_dir:
            from analytics_zoo_tpu_torch.learn.profiler import (
                TrainingProfiler)

            profiler = TrainingProfiler(trace_dir=trace_dir)
            self.last_profile = profiler
            profiler.start_trace()
        emit("train_start", "learn", epochs=epochs,
             batch_size=batch_size, device_cache=bool(device_cache))
        run = dict(dataset=dataset, val_dataset=val_dataset,
                   batch_size=batch_size, epochs=epochs,
                   validation_trigger=validation_trigger,
                   checkpoint_trigger=checkpoint_trigger,
                   checkpoint_dir=checkpoint_dir,
                   retry_times=cfg.get("zoo.train.failure.retry_times"),
                   retry_interval=cfg.get(
                       "zoo.train.failure.retry_interval_s"),
                   profiler=profiler)
        try:
            if device_cache:
                return self._fit_device_cached(**run)
            return self._fit_loop(
                log_every=cfg.get("zoo.train.log_every_n_steps"), **run)
        finally:
            emit("train_stop", "learn", epochs_run=self.epoch,
                 global_step=self.global_step)
            if profiler is not None:
                profiler.stop_trace()
                logger.info("training profile: %s", profiler.summary())

    def _fit_loop(self, dataset, val_dataset, batch_size, epochs,
                  validation_trigger, checkpoint_trigger, checkpoint_dir,
                  retry_times, retry_interval, profiler, log_every
                  ) -> List[Dict[str, float]]:
        stage = functools.partial(_stage, profiler)
        failures: List[float] = []
        history: List[Dict[str, float]] = []
        state = TriggerState(epoch=self.epoch, iteration=self.global_step)
        steps_per_epoch = dataset.steps_per_epoch(batch_size)
        while self.epoch < epochs:
            epoch_start = time.time()
            loss_sum = torch.zeros((), device=self.device)
            n_steps = 0
            last_val: Optional[Dict[str, float]] = None
            try:
                batches = iter(dataset.device_iterator(
                    batch_size, device=self.device, shuffle=True,
                    seed=self.seed, epoch=self.epoch))
                for step_in_epoch in range(steps_per_epoch):
                    with stage("data_wait"):
                        try:
                            x, y = next(batches)
                        except StopIteration:
                            break
                    with stage("train_step"):
                        loss = self._train_step(x, y)
                        # the epoch loss accumulates on the device: a
                        # per-step float() would sync every step
                        loss_sum = loss_sum + loss
                    self.global_step += 1
                    n_steps += 1
                    _M_STEPS.inc()
                    if (self.global_step % log_every == 0 or
                            self.global_step == 1):
                        lf = float(loss)
                        state.loss = lf
                        logger.info("epoch %d step %d loss %.5f",
                                    self.epoch, self.global_step, lf)
                    finishing = step_in_epoch == steps_per_epoch - 1
                    state.iteration = self.global_step
                    state.epoch = self.epoch + (1 if finishing else 0)
                    state.epoch_finished = finishing
                    state.wall_time = time.time()
                    if val_dataset is not None and validation_trigger(state):
                        last_val = self.evaluate(val_dataset, batch_size)
                        state.score = next(iter(last_val.values()), None)
                    if checkpoint_dir is not None and \
                            checkpoint_trigger(state):
                        self._save(checkpoint_dir, state.epoch)
                # epoch completed; ONE host sync for the whole epoch
                self.epoch += 1
                _M_EPOCHS.inc()
                state.epoch = self.epoch
                entry: Dict[str, float] = {
                    "epoch": self.epoch,
                    "loss": (float(loss_sum) / n_steps if n_steps
                             else float("nan")),
                    "seconds": time.time() - epoch_start,
                }
                if last_val is not None:
                    entry.update({f"val_{k}": v for k, v in last_val.items()})
                history.append(entry)
                logger.info("epoch %d done: %s", self.epoch, entry)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if not self._handle_training_failure(
                        e, failures, retry_times, retry_interval,
                        checkpoint_dir, state):
                    raise
        return history

    def _handle_training_failure(self, e, failures, retry_times,
                                 retry_interval, checkpoint_dir,
                                 state) -> bool:
        """Retry-from-checkpoint contract for both fit loops: prune the
        failure window and, if a checkpoint exists within the retry
        budget, reset stale trigger state and restore. Returns whether
        training continues (False -> caller re-raises)."""
        now = time.time()
        failures[:] = [t for t in failures
                       if now - t < retry_interval] + [now]
        can_retry = (checkpoint_dir is not None and
                     ckpt_lib.latest_step(checkpoint_dir) is not None
                     and len(failures) <= retry_times)
        logger.exception("training failure %d/%d in window: %s",
                         len(failures), retry_times, e)
        emit("train_failure", "learn", error=repr(e),
             failures=len(failures), retrying=can_retry)
        if not can_retry:
            return False
        state.loss = None
        state.score = None
        self._restore(checkpoint_dir)
        return True

    @staticmethod
    def _fired_in_range(trigger: Trigger, state: TriggerState,
                        start_step: int, end_step: int) -> bool:
        """Whether ``trigger`` would have fired at any step in
        (start_step, end_step]: the cached path checks triggers once per
        epoch."""
        saved = state.iteration
        try:
            for it in range(start_step + 1, end_step + 1):
                state.iteration = it
                if trigger(state):
                    return True
            return False
        finally:
            state.iteration = saved

    def _fit_device_cached(self, dataset, val_dataset, batch_size, epochs,
                           validation_trigger, checkpoint_trigger,
                           checkpoint_dir, retry_times, retry_interval,
                           profiler) -> List[Dict[str, float]]:
        stage = functools.partial(_stage, profiler)
        n = dataset.num_samples
        n_steps = n // batch_size
        if n_steps == 0:
            raise ValueError(f"dataset ({n} samples) smaller than "
                             f"batch_size {batch_size}")
        x_all = to_device(dataset.features, self.device)
        y_all = (to_device(dataset.labels, self.device)
                 if dataset.labels is not None else None)
        history: List[Dict[str, float]] = []
        state = TriggerState(epoch=self.epoch, iteration=self.global_step)
        failures: List[float] = []
        while self.epoch < epochs:
            t0 = time.time()
            step_before = self.global_step
            try:
                with stage("train_step"):
                    perm = torch.randperm(n, generator=self.generator,
                                          device=self.device)
                    loss_sum = torch.zeros((), device=self.device)
                    for i in range(n_steps):
                        idx = perm[i * batch_size:(i + 1) * batch_size]
                        x = tree_map(lambda a: a.index_select(0, idx), x_all)
                        y = tree_map(lambda a: a.index_select(0, idx), y_all)
                        loss_sum = loss_sum + self._train_step(x, y)
                    lf = float(loss_sum) / n_steps
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if not self._handle_training_failure(
                        e, failures, retry_times, retry_interval,
                        checkpoint_dir, state):
                    raise
                continue
            self.epoch += 1
            self.global_step += n_steps
            _M_EPOCHS.inc()
            _M_STEPS.inc(n_steps)
            entry: Dict[str, float] = {
                "epoch": self.epoch, "loss": lf, "seconds": time.time() - t0}
            state.epoch = self.epoch
            state.iteration = self.global_step
            state.loss = lf
            state.epoch_finished = True
            state.wall_time = time.time()
            if val_dataset is not None and self._fired_in_range(
                    validation_trigger, state, step_before,
                    self.global_step):
                val = self.evaluate(val_dataset, batch_size)
                state.score = next(iter(val.values()), None)
                entry.update({f"val_{k}": v for k, v in val.items()})
            if checkpoint_dir is not None and self._fired_in_range(
                    checkpoint_trigger, state, step_before,
                    self.global_step):
                self._save(checkpoint_dir, self.epoch)
            history.append(entry)
            logger.info("epoch %d done (device-cached): %s",
                        self.epoch, entry)
        return history

    # ------------------------------------------------------- checkpoints --
    def _save(self, ckpt_dir: str, epoch: int) -> None:
        ckpt_lib.save_checkpoint(ckpt_dir, self.model.state_dict(),
                                 self.opt_state, self.global_step, epoch)

    def _restore(self, checkpoint_dir: str) -> None:
        model_state, opt_state, meta = ckpt_lib.load_checkpoint(
            checkpoint_dir, map_location=self.device)
        self.model.load_state_dict(model_state)
        self.opt_state = opt_state
        self.global_step = meta["step"]
        self.epoch = meta["epoch"]
        logger.info("restored from checkpoint: step=%d epoch=%d",
                    self.global_step, self.epoch)

    # ---------------------------------------------------------- evaluate --
    def _eval_metrics(self) -> List[Metric]:
        """The tracked metrics plus a Loss metric when a loss is set."""
        out = list(self.metrics)
        if self.loss_fn is not None:
            out.append(Loss(self.loss_fn))
        return out

    def evaluate(self, data, batch_size: int) -> Dict[str, float]:
        """Metrics over the full dataset -- the short final batch is
        included via padding + masking, so no tail samples are dropped."""
        dataset = _as_dataset(data)
        if dataset.num_samples == 0:
            raise ValueError("dataset is empty")
        metrics = self._eval_metrics()
        states = [m.empty(self.device) for m in metrics]
        with torch.no_grad():
            for x, y, w in dataset.device_iterator(
                    batch_size, device=self.device, shuffle=False,
                    drop_remainder=False, with_mask=True):
                preds = self._apply(x, training=False)
                states = [m.update(s, preds, y, weights=w)
                          for m, s in zip(metrics, states)]
        return {m.name: float(m.result(s))
                for m, s in zip(metrics, states)}

    # ----------------------------------------------------------- predict --
    def predict(self, data, batch_size: int = 32) -> Any:
        """Outputs for every sample as numpy (bf16 outputs as float32)."""
        dataset = _as_dataset(data, labeled=False)
        outs: List[Any] = []
        with torch.no_grad():
            for x, _ in dataset.device_iterator(
                    batch_size, device=self.device, shuffle=False,
                    drop_remainder=False):
                outs.append(tree_map(_host, self._apply(x, training=False)))
        return _concat(outs, dataset.num_samples)

    # ------------------------------------------------------- persistence --
    def save(self, ckpt_dir: str) -> None:
        self._ensure_built()
        self._save(ckpt_dir, self.epoch)

    def load(self, ckpt_dir: str) -> None:
        """Restore weights, optimizer state and counters."""
        self._ensure_built()
        self._restore(ckpt_dir)


def _concat(parts, n: int):
    """Concatenate per-batch output trees along the batch axis, cut to
    ``n`` rows."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts], n) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([p[i] for p in parts], n)
                           for i in range(len(first)))
    return np.concatenate(parts)[:n]


def recompiled(old: Optional[Estimator], model, **kwargs) -> Estimator:
    """A fresh Estimator over the same module (so trained weights carry
    over) with ``old``'s counters: the Keras ``compile()`` contract."""
    est = Estimator(model, **kwargs)
    if old is not None:
        est.global_step = old.global_step
        est.epoch = old.epoch
    return est

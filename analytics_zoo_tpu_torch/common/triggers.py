"""Composable training triggers, carried across from
``analytics_zoo_tpu/common/triggers.py`` as they are (the module is
jax-free).

The analog of ``ZooTrigger`` and BigDL triggers
(ref: zoo/.../common/ZooTrigger.scala:135-170 for And/Or composition;
EveryEpoch/SeveralIteration/MaxEpoch/MaxIteration/MaxScore/MinLoss mirror
the BigDL trigger family the Keras API exposes through
``setCheckpoint``/``setValidation``).

A trigger is a callable over :class:`TriggerState`; the Estimator evaluates
triggers after every optimization step (end-of-epoch triggers fire on the
step that completes an epoch).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass
class TriggerState:
    """Snapshot of training progress the Estimator feeds to triggers."""

    epoch: int = 0                 # completed epochs
    iteration: int = 0             # completed optimization steps (global)
    epoch_finished: bool = False   # did this step complete an epoch?
    loss: Optional[float] = None   # last training loss
    score: Optional[float] = None  # last validation score (higher=better)
    wall_time: float = field(default_factory=time.time)
    start_time: float = field(default_factory=time.time)


class Trigger:
    def __call__(self, state: TriggerState) -> bool:
        raise NotImplementedError

    def __and__(self, other: "Trigger") -> "And":
        return And(self, other)

    def __or__(self, other: "Trigger") -> "Or":
        return Or(self, other)


class EveryEpoch(Trigger):
    """Fires on steps that complete an epoch."""

    def __call__(self, state: TriggerState) -> bool:
        return state.epoch_finished


class SeveralIteration(Trigger):
    """Fires every ``interval`` optimization steps."""

    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = interval

    def __call__(self, state: TriggerState) -> bool:
        return state.iteration > 0 and state.iteration % self.interval == 0


class MaxEpoch(Trigger):
    """End-trigger: fires once ``max_epoch`` epochs have completed."""

    def __init__(self, max_epoch: int):
        self.max_epoch = max_epoch

    def __call__(self, state: TriggerState) -> bool:
        return state.epoch >= self.max_epoch


class MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = max_iteration

    def __call__(self, state: TriggerState) -> bool:
        return state.iteration >= self.max_iteration


class MaxScore(Trigger):
    """Fires when validation score exceeds ``max_score``."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def __call__(self, state: TriggerState) -> bool:
        return state.score is not None and state.score > self.max_score


class MinLoss(Trigger):
    """Fires when training loss drops below ``min_loss``.

    The Estimator materializes loss on host only at its logging cadence
    (``zoo.train.log_every_n_steps``), so this trigger observes the loss
    at that granularity -- keeping the train loop free of per-step
    device->host syncs."""

    def __init__(self, min_loss: float):
        self.min_loss = min_loss

    def __call__(self, state: TriggerState) -> bool:
        return state.loss is not None and state.loss < self.min_loss


class TimeLimit(Trigger):
    """Fires after ``max_seconds`` of wall-clock training time."""

    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds

    def __call__(self, state: TriggerState) -> bool:
        return (state.wall_time - state.start_time) >= self.max_seconds


class And(Trigger):
    """Fires iff every child trigger fires (ref: ZooTrigger.scala:135-151)."""

    def __init__(self, *triggers: Trigger):
        if not triggers:
            raise ValueError("And needs at least one trigger")
        self.triggers: Sequence[Trigger] = triggers

    def __call__(self, state: TriggerState) -> bool:
        return all(t(state) for t in self.triggers)


class Or(Trigger):
    """Fires iff any child trigger fires (ref: ZooTrigger.scala:152-170)."""

    def __init__(self, *triggers: Trigger):
        if not triggers:
            raise ValueError("Or needs at least one trigger")
        self.triggers: Sequence[Trigger] = triggers

    def __call__(self, state: TriggerState) -> bool:
        return any(t(state) for t in self.triggers)

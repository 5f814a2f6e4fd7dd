"""Priority-ordered admission control: brownout shedding (ISSUE-15).

The single ``zoo.serving.shed.queue_depth`` threshold of ISSUE-5 shed
every class of traffic at the same depth -- under overload a
background bulk export and an interactive request died together. This
module replaces it with a brownout LADDER over the protocol's
``PRIORITY_CLASSES``:

- ``interactive`` admits while depth < ``queue_depth`` (the historical
  threshold, so priority-less deployments behave byte-identically);
- ``batch`` admits while depth < ``queue_depth * batch_fraction``;
- ``background`` admits while depth < ``queue_depth *
  background_fraction``.

The ladder is clamped monotone non-increasing, so the no-inversion
contract holds *by construction*: at any queue depth, a class is
admitted whenever any lower class would be -- there is no interleaving
of decisions that refuses ``interactive`` while admitting ``batch``
(property-tested over randomized sequences in
``tests/test_overload.py``).

Generation admissions carry a COST: ``ceil(max_tokens /
zoo.serving.shed.gen_cost_tokens)`` queue slots, so a request asking
for a 4096-token stream is charged like the long occupancy it is and
cannot starve interactive traffic by slipping under the depth bar one
blob at a time.

Retry-After adapts to pressure: an EWMA over admission decisions
(1 = shed, 0 = admitted; ``zoo.serving.shed.ewma_alpha`` smoothing)
interpolates between ``zoo.serving.shed.retry_after_s`` (the floor)
and ``zoo.serving.shed.retry_after_max_s``. Rising shed pressure
monotonically raises the advertised backoff; recovery decays it back
to the floor. Decision-indexed (not wall-clock) smoothing keeps the
controller deterministic and directly testable.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

from analytics_zoo_tpu_torch.obs.events import emit as emit_event
from analytics_zoo_tpu_torch.obs.metrics import get_registry as _get_registry
from analytics_zoo_tpu_torch.serving.protocol import (
    PRIORITY_CLASSES, priority_name)

# THE registration site for the shed family (moved here from queues.py
# when it grew the per-class label): one counter, labeled by admission
# class, so dashboards separate "background browned out as designed"
# from "interactive is being refused" without a new metric name.
_REG = _get_registry()
_M_SHED = _REG.counter(
    "zoo_serving_shed_total",
    "Requests refused by priority-ordered admission control "
    "(zoo.serving.shed.*; class = admission class refused)",
    labelnames=("class",))


class AdmissionController:
    """Shed-or-admit decisions for one input queue.

    Thread-safe; every mutable piece sits behind one lock (enqueue
    paths are already serialized per producer, but several producer
    threads may share one InputQueue).
    """

    def __init__(self, queue_depth: int,
                 batch_fraction: Optional[float] = None,
                 background_fraction: Optional[float] = None,
                 retry_after_s: Optional[float] = None,
                 retry_after_max_s: Optional[float] = None,
                 ewma_alpha: Optional[float] = None):
        from analytics_zoo_tpu_torch.common.config import get_config

        cfg = get_config()
        if batch_fraction is None:
            batch_fraction = float(
                cfg.get("zoo.serving.shed.batch_fraction", 0.6))
        if background_fraction is None:
            background_fraction = float(
                cfg.get("zoo.serving.shed.background_fraction", 0.3))
        if retry_after_s is None:
            retry_after_s = float(
                cfg.get("zoo.serving.shed.retry_after_s", 1.0))
        if retry_after_max_s is None:
            retry_after_max_s = float(
                cfg.get("zoo.serving.shed.retry_after_max_s", 30.0))
        if ewma_alpha is None:
            ewma_alpha = float(
                cfg.get("zoo.serving.shed.ewma_alpha", 0.2))
        self.queue_depth = int(queue_depth)
        self.thresholds = self._ladder(
            self.queue_depth, (1.0, batch_fraction, background_fraction))
        self.floor_s = float(retry_after_s)
        self.max_s = max(float(retry_after_max_s), self.floor_s)
        self.alpha = min(max(float(ewma_alpha), 0.0), 1.0)
        self._lock = threading.Lock()
        self._pressure = 0.0  # EWMA of the shed fraction, in [0, 1]
        self._retry_s = self.floor_s
        self._shed_counts = [0] * len(PRIORITY_CLASSES)
        self._episode = [False] * len(PRIORITY_CLASSES)

    @staticmethod
    def _ladder(queue_depth: int, fractions) -> tuple:
        """Per-class depth thresholds, clamped monotone non-increasing
        from the highest class down -- the no-inversion invariant."""
        out = []
        prev = None
        for frac in fractions:
            t = int(math.ceil(queue_depth * min(max(frac, 0.0), 1.0)))
            if prev is not None:
                t = min(t, prev)
            out.append(t)
            prev = t
        return tuple(out)

    @property
    def enabled(self) -> bool:
        return self.queue_depth > 0

    def admit(self, depth: int, priority: Optional[int],
              cost: int = 1) -> bool:
        """One admission decision. ``depth`` is the observed backlog,
        ``priority`` an index into PRIORITY_CLASSES (None / out of
        range clamps to the lowest class -- garbage must never
        promote), ``cost`` how many queue slots this request is
        charged (>= 1; generation streams weigh their token budget).

        Admits iff ``depth + cost - 1 < threshold[class]`` -- with
        cost 1 exactly the historical ``depth < shed_depth`` rule, so
        an all-interactive deployment is decision-identical to the
        pre-ladder controller.
        """
        if not self.enabled:
            return True
        pri = priority if (isinstance(priority, int)
                           and 0 <= priority < len(self.thresholds)
                           ) else len(self.thresholds) - 1
        cost = max(1, int(cost))
        ok = depth + cost - 1 < self.thresholds[pri]
        with self._lock:
            if not ok:
                # advertise the backoff as of pressure BEFORE this
                # refusal: the first shed of a calm queue says exactly
                # the configured floor, and each consecutive shed says
                # strictly more (monotone, capped at max_s)
                self._retry_s = (self.floor_s
                                 + (self.max_s - self.floor_s)
                                 * self._pressure)
            self._pressure += self.alpha * ((0.0 if ok else 1.0)
                                            - self._pressure)
            if ok:
                self._episode[pri] = False
            else:
                self._shed_counts[pri] += 1
                first = not self._episode[pri]
                self._episode[pri] = True
        if not ok:
            name = priority_name(pri)
            _M_SHED.labels(**{"class": name}).inc()
            if first:
                # one event per shed EPISODE per class -- a sustained
                # overload must not churn the event ring with copies
                # of the same fact
                emit_event("request_shed", "serving", depth=depth,
                           shed_depth=self.thresholds[pri],
                           priority=name, cost=cost)
        return ok

    def retry_after_s(self) -> float:
        """Advertised client backoff: the value stamped at the most
        recent refusal (the configured floor when nothing has been
        refused). Consecutive refusals raise it monotonically toward
        ``retry_after_max_s``; admitted traffic decays the pressure
        behind it back down."""
        with self._lock:
            return self._retry_s

    def pressure(self) -> float:
        with self._lock:
            return self._pressure

    def shed_counts(self) -> Dict[str, int]:
        """Per-class refusals since construction (stats surface)."""
        with self._lock:
            return {priority_name(i): c
                    for i, c in enumerate(self._shed_counts)}

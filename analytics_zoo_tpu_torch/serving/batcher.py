"""Micro-batchers with bounded backpressure.

The analog of ``ClusterServingInference`` batching
(ref: zoo/.../serving/engine/ClusterServingInference.scala:33-160 --
groups up to ``batchSize`` requests per inference call; Flink supplied
backpressure upstream, here the bounded input queue does, SURVEY.md
section 7 "hard parts: serving ... our batcher must implement it").

Two policies:

- :class:`MicroBatcher` -- the fixed size/timeout policy: close a batch
  on ``batch_size`` reached or ``timeout_ms`` after the first item.
- :class:`AdaptiveBatcher` -- size OR deadline close with both knobs
  adapted to observed queue depth (the batch-assembly policy result of
  arXiv:2605.25645: size *and* deadline dominate serving efficiency):

  * **deadline tightens when the queue is shallow** -- waiting the full
    linger for stragglers that are not coming only adds latency, so the
    linger shrinks toward ``min_timeout_ms`` as depth drops;
  * **the cap grows when backlog builds** -- enough waiting requests to
    fill a larger device bucket means a bigger batch amortizes
    per-dispatch overhead and drains the backlog; grown caps are
    snapped to the power-of-two bucket ladder of
    ``InferenceModel.predict`` so no new XLA shapes are introduced.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.obs.events import emit as emit_event
from analytics_zoo_tpu_torch.obs.metrics import get_registry
from analytics_zoo_tpu_torch.serving.chaos import chaos_point

# why a batch closed, process-wide (obs registry): "size" = cap
# reached, "deadline" = linger expired -- the ratio is the first thing
# to read when tuning batch_size/timeout_ms against live traffic
_M_CLOSES = get_registry().counter(
    "zoo_serving_batch_close_total",
    "Micro-batches closed, by close reason", labelnames=("reason",))


def _bucket(n: int) -> int:
    """Power-of-two bucket ladder (mirrors inference_model._bucket; kept
    local so the batcher never imports jax)."""
    b = 1
    while b < n:
        b *= 2
    return b


class MicroBatcher:
    """Pulls items from a queue-like (``get(timeout)``), groups up to
    ``batch_size`` within ``timeout_ms`` of the first item."""

    def __init__(self, queue, batch_size: int = 8,
                 timeout_ms: float = 5.0):
        self.queue = queue
        self.batch_size = batch_size
        self.timeout_ms = timeout_ms

    def next_batch(self, wait_timeout: Optional[float] = 1.0
                   ) -> List[Any]:
        chaos_point("pull")  # queue-stall / crash injection seam
        first = self.queue.get(timeout=wait_timeout)
        if first is None:
            return []
        batch = [first]
        deadline = time.time() + self.timeout_ms / 1000.0
        while len(batch) < self.batch_size:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            item = self.queue.get(timeout=remaining)
            if item is None:
                break
            batch.append(item)
        _M_CLOSES.labels(reason="size" if len(batch) >= self.batch_size
                         else "deadline").inc()
        return batch

    def stats(self) -> Dict[str, Any]:
        return {}


class AdaptiveBatcher(MicroBatcher):
    """Deadline/size micro-batcher whose cap and linger track queue
    depth (policy described in the module docstring).

    Args:
      queue: queue-like with ``get(timeout)``; ``__len__`` (depth) and
        ``get_many(n)`` are used when available.
      batch_size: base cap -- the micro-batch size under normal load.
      timeout_ms: maximum linger after the first item of a batch.
      min_timeout_ms: linger floor the deadline tightens toward when
        the queue is empty behind the first item.
      max_batch_size: ceiling the cap may grow to under backlog
        (bucket-snapped); <= ``batch_size`` disables growth.
    """

    def __init__(self, queue, batch_size: int = 8,
                 timeout_ms: float = 5.0,
                 min_timeout_ms: Optional[float] = None,
                 max_batch_size: Optional[int] = None):
        super().__init__(queue, batch_size=batch_size,
                         timeout_ms=timeout_ms)
        self.min_timeout_ms = (timeout_ms * 0.2
                               if min_timeout_ms is None
                               else min(min_timeout_ms, timeout_ms))
        if max_batch_size is None:
            max_batch_size = _bucket(4 * batch_size)
        self.max_batch_size = max(batch_size, int(max_batch_size))
        self._lock = threading.Lock()
        self._closes: Dict[str, int] = {"size": 0, "deadline": 0}
        self._occupancy_sum = 0
        self._batches = 0
        self._depth_sum = 0
        self._last_cap = batch_size
        self._last_linger_ms = timeout_ms
        # depth observed behind the latest batch's first item; the
        # worker's queue_depth gauge reads this instead of issuing a
        # second len() (one broker RPC per pull on TcpQueue backends)
        self.last_depth = -1

    # ---------------------------------------------------------- policy --
    def _queue_depth(self) -> int:
        try:
            return len(self.queue)
        except Exception:  # depth-less backends: fixed policy
            return -1

    def _policy(self, depth: int):
        """(cap, linger_seconds) for the batch being assembled, given
        the queue depth observed behind its first item."""
        base = self.batch_size
        if depth < 0:
            return base, self.timeout_ms / 1000.0
        cap = base
        if depth + 1 > base and self.max_batch_size > base:
            # backlog covers a bigger bucket: grow, snapped to the
            # ladder so padded batch shapes stay on already-compiled
            # buckets (never a new XLA shape from growth). Grow to the
            # largest bucket the KNOWN backlog fills -- the covering
            # bucket would leave the batch short and linger the full
            # deadline for stragglers that may never come
            full = _bucket(depth + 1)
            if full > depth + 1:
                full //= 2
            cap = max(base, min(self.max_batch_size, full))
        # shallow queue: tighten the linger -- with depth d items
        # already waiting, only (base - 1 - d) stragglers could improve
        # occupancy, so scale the linger by how full the batch can get
        frac = min(1.0, depth / max(1, base - 1))
        linger_ms = (self.min_timeout_ms
                     + (self.timeout_ms - self.min_timeout_ms) * frac)
        return cap, linger_ms / 1000.0

    # ------------------------------------------------------------ pull --
    def next_batch(self, wait_timeout: Optional[float] = 1.0
                   ) -> List[Any]:
        chaos_point("pull")  # queue-stall / crash injection seam
        first = self.queue.get(timeout=wait_timeout)
        if first is None:
            return []
        depth = self._queue_depth()
        cap, linger = self._policy(depth)
        batch = [first]
        if len(batch) < cap and hasattr(self.queue, "get_many"):
            batch.extend(self.queue.get_many(cap - 1))
        deadline = time.monotonic() + linger
        while len(batch) < cap:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            item = self.queue.get(timeout=remaining)
            if item is None:
                break
            batch.append(item)
        reason = "size" if len(batch) >= cap else "deadline"
        _M_CLOSES.labels(reason=reason).inc()
        with self._lock:
            self._closes[reason] += 1
            self._occupancy_sum += len(batch)
            self._batches += 1
            self._depth_sum += max(0, depth)
            prev_cap = self._last_cap
            self._last_cap = cap
            self._last_linger_ms = linger * 1000.0
            self.last_depth = depth
        if cap != prev_cap:
            # policy transitions only (a handful per load swing, never
            # per batch): the event log shows WHEN the batcher grew
            # into a bigger bucket -- the context for occupancy and
            # close-reason shifts on the dashboard
            emit_event("batch_cap_change", "serving", cap=cap,
                       prev=prev_cap, depth=depth)
        return batch

    def stats(self) -> Dict[str, Any]:
        """Close-reason counts + occupancy/depth means, for
        ``ServingWorker.metrics()``."""
        with self._lock:
            n = max(1, self._batches)
            return {
                "batches": self._batches,
                "close_size": self._closes["size"],
                "close_deadline": self._closes["deadline"],
                "mean_occupancy": self._occupancy_sum / n,
                "mean_queue_depth": self._depth_sum / n,
                "last_cap": self._last_cap,
                "last_linger_ms": self._last_linger_ms,
                "max_batch_size": self.max_batch_size,
            }

"""ContinuousBatcher: slot admission at decode-step boundaries.

``AdaptiveBatcher``'s role, evolved for generation. The predict
batchers answer "how long do I linger assembling THIS batch" -- a
question that does not exist here, because the decode batch is never
assembled: it is a standing slot table requests join and leave.
What remains of batching policy is *admission pacing*:

- when slots are free, pull up to that many waiting requests in one
  non-blocking sweep (``get_many`` where the backend has it -- one
  lock/broker trip, the deep-backlog fast path);
- when the engine is otherwise **idle** (no active slots), block up to
  ``wait_timeout`` for the first request so an idle worker wakes on
  arrival instead of spinning;
- when the engine is **busy**, never block: a decode step for N live
  streams must not wait on the queue -- a request that arrives
  mid-step joins at the next boundary, which is at most one step away.

The batcher also owns the pull-side chaos seam (same ``pull`` seam as
the predict batchers) and admission wait accounting: ``last_depth``
feeds the queue-depth gauge exactly like ``AdaptiveBatcher`` does, so
the serving dashboard reads the same series for both data planes.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.serving.chaos import chaos_point


class ContinuousBatcher:
    """Admission-side pull policy for :class:`~.worker.GenerationWorker`.

    Args:
      queue: queue-like with ``get(timeout)``; ``get_many(n)`` and
        ``__len__`` are used when available.
      max_admit_per_step: cap on admissions per step boundary (0 =
        bounded only by free slots) -- a guard against one boundary
        paying many prefill stalls back-to-back while live streams
        starve.
    """

    def __init__(self, queue, max_admit_per_step: int = 0):
        self.queue = queue
        self.max_admit_per_step = int(max_admit_per_step)
        self._lock = threading.Lock()
        self._pulls = 0
        self._admitted = 0
        self.last_depth = -1

    def poll(self, n_free: int, wait_timeout: float = 0.05,
             idle: bool = True) -> List[bytes]:
        """Up to ``n_free`` request blobs for this step boundary.
        Blocks (up to ``wait_timeout``) only when ``idle`` -- see the
        module docstring for why a busy engine never waits here."""
        chaos_point("pull")
        if n_free <= 0:
            return []
        if self.max_admit_per_step:
            n_free = min(n_free, self.max_admit_per_step)
        out: List[bytes] = []
        first = self.queue.get(timeout=wait_timeout if idle else 0)
        if first is not None:
            out.append(first)
            if len(out) < n_free and hasattr(self.queue, "get_many"):
                out.extend(self.queue.get_many(n_free - len(out)))
            else:
                while len(out) < n_free:
                    item = self.queue.get(timeout=0)
                    if item is None:
                        break
                    out.append(item)
        try:
            depth = len(self.queue)
        except (TypeError, OSError):
            depth = -1
        with self._lock:
            self._pulls += 1
            self._admitted += len(out)
            self.last_depth = depth
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"pulls": self._pulls, "pulled": self._admitted,
                    "last_depth": self.last_depth,
                    "max_admit_per_step": self.max_admit_per_step}

"""Training-side profiling.

The counterpart of ``analytics_zoo_tpu/learn/profiler.py``:

- ``TrainingProfiler``: host-side stage timers (``data_wait`` vs
  ``train_step``) with the serving Timer's count/avg/max/min summary,
  mirrored into ``zoo_learn_stage_duration_seconds{stage=...}``;
- with ``trace_dir``, a ``torch.profiler`` trace (CPU and, on a card,
  CUDA activity) written there as a Chrome trace, each stage a named
  region on its timeline.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from analytics_zoo_tpu_torch.common.log import Timer
from analytics_zoo_tpu_torch.obs.metrics import get_registry

_M_LEARN_STAGE = get_registry().histogram(
    "zoo_learn_stage_duration_seconds",
    "Training stage latency (data_wait, train_step, epoch, ...)",
    labelnames=("stage",))


class TrainingProfiler:
    """Stage timers + optional torch.profiler trace for one fit() run."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.timer = Timer(mirror=_M_LEARN_STAGE)
        self.trace_dir = trace_dir
        self._prof = None

    @contextlib.contextmanager
    def timing(self, stage: str):
        """Host timer for the stage; while a trace is active the stage
        also appears as a named region on its timeline."""
        with self.timer.timing(stage):
            if self._prof is not None:
                with torch.profiler.record_function(stage):
                    yield
            else:
                yield

    def start_trace(self) -> None:
        if self.trace_dir and self._prof is None:
            from torch.profiler import (
                ProfilerActivity, profile, tensorboard_trace_handler)

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(
                activities=acts,
                on_trace_ready=tensorboard_trace_handler(self.trace_dir))
            self._prof.start()

    def stop_trace(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()

    def summary(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for name, stat in self.timer.stats().items():
            out[name] = {"count": stat.count,
                         "total_s": round(stat.total, 6),
                         "avg_s": round(stat.avg, 6),
                         "max_s": round(stat.max, 6),
                         "min_s": round(stat.min if stat.count else 0.0,
                                        6)}
        return out

    @property
    def input_bound_fraction(self) -> Optional[float]:
        """Fraction of loop time spent waiting on data -- > ~0.3 means
        the input pipeline, not the card, sets throughput."""
        stats = self.timer.stats()
        data = stats.get("data_wait")
        step = stats.get("train_step")
        if not data or not step or (data.total + step.total) == 0:
            return None
        return data.total / (data.total + step.total)

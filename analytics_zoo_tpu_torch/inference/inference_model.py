"""InferenceModel: the serving-facing prediction engine.

The counterpart of ``analytics_zoo_tpu/inference/inference_model.py``.
One module in eval mode serves every thread; batch inputs are padded up
to the nearest power-of-two bucket (the same ladder as the reference, so
the batcher and the warm-up agree on shapes).

Asynchronous dispatch: ``predict_async`` queues the host->device copy
and the forward on the model's own CUDA stream and returns at once.
Each output leaf is a :class:`DeviceResult`: the serving worker calls
its ``copy_to_host_async`` at dispatch (a non-blocking copy into pinned
memory on the same stream), and ``np.asarray`` waits for that copy
only. The worker dispatches the next batch meanwhile.

Loaders: ``load_zoo`` (a saved ZooModel directory) and ``load_module``
(an ``nn.Module`` plus an optional ``state_dict``, the counterpart of
``load_flax``). ``quantize``, ``shard``, the graph loaders and the
encrypted loaders are still to be ported (ROADMAP queue 1: inference
runtime).
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.obs.events import record_compile, warming
from analytics_zoo_tpu_torch.obs.metrics import get_registry
from analytics_zoo_tpu_torch.utils.tree import tree_leaves, tree_map

logger = get_logger(__name__)

# the reference's metric families, kept by name. PyTorch compiles
# nothing per shape, so "compile" here counts the first dispatch of each
# new bucket shape (flat after warm-up in a healthy deployment)
_REG = get_registry()
_M_COMPILES = _REG.counter(
    "zoo_inference_compile_total",
    "XLA shape-bucket compiles by (bucket, shard mode) -- flat after "
    "warm-up in a healthy deployment; climbing means requests pay "
    "compile stalls", labelnames=("bucket", "mode"))
_M_DISPATCH = _REG.counter(
    "zoo_inference_dispatch_total",
    "Prediction batches dispatched, by shard mode",
    labelnames=("mode",))
_M_PAD = _REG.histogram(
    "zoo_inference_batch_pad_ratio",
    "Fraction of each dispatched device batch that is bucket padding, "
    "by (bucket, shard mode)", labelnames=("bucket", "mode"),
    buckets=(0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0))


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def bucket_ladder(max_batch: int) -> List[int]:
    """Every power-of-two batch bucket up to (and including) the one
    covering ``max_batch`` -- the shape ladder ``predict`` pads onto."""
    ladder = []
    b = 1
    while b <= _bucket(max_batch):
        ladder.append(b)
        b *= 2
    return ladder


class DeviceResult:
    """One output leaf of ``predict_async``. ``copy_to_host_async``
    queues its copy into pinned host memory on the model's stream;
    ``np.asarray`` starts that copy if needed and waits for it only."""

    __slots__ = ("_tensor", "_stream", "_host", "_done")

    def __init__(self, tensor: torch.Tensor,
                 stream: Optional[torch.cuda.Stream]):
        self._tensor = tensor
        self._stream = stream
        self._host: Optional[torch.Tensor] = None
        self._done = None

    def copy_to_host_async(self) -> None:
        if self._host is not None:
            return
        t = self._tensor
        if not t.is_cuda:
            self._host = t
            return
        with torch.cuda.stream(self._stream):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(self._stream)
        self._host = host

    def __array__(self, dtype=None, copy=None):
        self.copy_to_host_async()
        if self._done is not None:
            self._done.synchronize()
        host = self._host
        if host.dtype == torch.bfloat16:
            host = host.float()
        arr = host.numpy()
        return arr if dtype is None else arr.astype(dtype)


class InferenceModel:
    """``device``: None = CUDA (raises without a GPU), or e.g. "cpu".
    One module serves every thread: no model copies."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.module: Optional[torch.nn.Module] = None
        self._seen: set = set()
        self._lock = threading.Lock()
        self.example_input = None  # set by load_zoo for warm_up
        # dispatch stream: the serving threads' work queues here, off
        # the default stream
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    # ------------------------------------------------------------ loads --
    def load_zoo(self, path: str) -> "InferenceModel":
        from analytics_zoo_tpu_torch.models.common import ZooModel

        model = ZooModel.load_model(path, device=self.device,
                                    with_optim=False)
        self.module = model.module.eval()
        try:  # lets deployments warm_up without knowing the model class
            self.example_input = model._example_input()
        except NotImplementedError:
            self.example_input = None
        return self

    def load_module(self, module: torch.nn.Module, state_dict=None,
                    example_input=None) -> "InferenceModel":
        """Serve ``module`` (moved to this model's device, eval mode),
        loading ``state_dict`` into it first when given."""
        if state_dict is not None:
            module.load_state_dict(state_dict)
        self.module = module.to(self.device).eval()
        self.example_input = example_input
        return self

    # ---------------------------------------------------------- warm-up --
    def warm_up(self, example_input,
                batch_sizes: Sequence[int] = (1, 8, 32)
                ) -> "InferenceModel":
        """Run each requested batch size's bucket once before traffic
        (first-use costs: CUDA kernel builds, cuBLAS plans, allocator
        growth). ``example_input`` is a single-sample batch tree."""
        if self.module is None:
            raise RuntimeError("no model loaded")
        example = tree_map(np.asarray, example_input,
                           is_leaf=lambda v: isinstance(v, list))
        done = set()
        with warming():
            for bs in batch_sizes:
                bucket = _bucket(bs)
                if bucket in done:
                    continue
                done.add(bucket)
                batch = tree_map(
                    lambda a: np.repeat(a[:1], bucket, axis=0), example)
                self.predict(batch)
        return self

    # ---------------------------------------------------------- predict --
    @staticmethod
    def _shape_key(x) -> Any:
        return tuple((getattr(l, "shape", None), str(getattr(l, "dtype", "")))
                     for l in tree_leaves(x))

    def predict(self, x, batch_size: Optional[int] = None) -> Any:
        """Thread-safe batched prediction; returns numpy."""
        out, n = self.predict_async(x)
        return tree_map(lambda a: np.asarray(a)[:n], out)

    def predict_async(self, x) -> Any:
        """Dispatch prediction without waiting: returns
        ``(outputs, n)``, ``outputs`` a tree of :class:`DeviceResult`;
        ``np.asarray(leaf)[:n]`` fetches one."""
        if self.module is None:
            raise RuntimeError("no model loaded")

        # 64-bit host inputs (JSON ints/floats) run as 32-bit, as in the
        # reference, so they share the warmed bucket shapes
        def canon(a):
            a = np.asarray(a)
            if a.dtype == np.float64:
                return a.astype(np.float32)
            if a.dtype == np.int64:
                return a.astype(np.int32)
            return a

        x = tree_map(canon, x)
        n = tree_leaves(x)[0].shape[0]
        bucket = _bucket(n)

        def pad(a):
            if a.shape[0] == bucket:
                return a
            return np.concatenate(
                [a, np.repeat(a[-1:], bucket - a.shape[0], axis=0)])

        padded = tree_map(pad, x)
        key = self._shape_key(padded)
        mode = "off"
        with self._lock:
            fresh = key not in self._seen
            if fresh:
                self._seen.add(key)
                _M_COMPILES.labels(bucket=str(bucket), mode=mode).inc()
                logger.info("inference: first dispatch of bucket %s", key)
        _M_DISPATCH.labels(mode=mode).inc()
        _M_PAD.labels(bucket=str(bucket),
                      mode=mode).observe((bucket - n) / bucket)
        t0 = time.perf_counter()
        out = self._run(padded)
        if fresh:
            # a new bucket's first dispatch: its wall time feeds the
            # recompile-storm detector (traffic that keeps minting new
            # shapes warns instead of just running slow)
            if self._stream is not None:
                self._stream.synchronize()
            record_compile("inference.predict", key,
                           time.perf_counter() - t0, subsystem="inference")
        return out, n

    def _run(self, padded) -> Any:
        stream = self._stream
        if stream is None:
            with torch.inference_mode():
                out = self.module(tree_map(torch.from_numpy, padded))
            return tree_map(lambda t: DeviceResult(t, None), out)
        # order after work the caller queued on its own stream (weight
        # loads, a previous model's output consumers)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream), torch.inference_mode():
            x = tree_map(lambda a: torch.from_numpy(a).pin_memory().to(
                self.device, non_blocking=True), padded)
            out = self.module(x)
        return tree_map(lambda t: DeviceResult(t, stream), out)

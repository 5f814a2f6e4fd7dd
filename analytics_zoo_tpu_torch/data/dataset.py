"""ZooDataset: the training-facing dataset.

The counterpart of ``analytics_zoo_tpu/data/dataset.py``, with the same
contracts: DRAM or DISK (memmap) tiers, deterministic epoch shuffles
(the same numpy permutation as the reference for the same seed and
epoch), and a final short batch padded by wrapping the epoch's order,
with an optional 0/1 mask marking the padded rows.

``batches`` yields host numpy batches; ``device_iterator`` moves them to
a device from a background thread: pinned host memory and
``non_blocking`` copies on a side stream, so the next batch's transfer
overlaps the current train step. Single process only: the reference's
multi-process slicing and mesh placement wait for the parallel and
sharded item of ROADMAP queue 1 and raise until then.
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.utils.tree import tree_leaves, tree_map

logger = get_logger(__name__)

_PARALLEL = ("is not ported yet: meshes and multi-process data "
             "parallelism arrive with the parallel and sharded item of ROADMAP queue 1")


def _leading_dim(tree) -> int:
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("empty pytree")
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError("all arrays must share the leading dim")
    return n


def _take_chunked(tree, idx, memory_type: str, cache_dir: str,
                  chunk: int = 65536):
    """Index-select rows from a pytree; DISK tier streams through a new
    memmap in chunks so selection never materializes fully in RAM."""
    if memory_type != "DISK":
        return tree_map(lambda a: np.asarray(a)[idx], tree)
    os.makedirs(cache_dir, exist_ok=True)
    counter = [0]

    def take(a):
        path = os.path.join(cache_dir, f"arr_{counter[0]}.npy")
        counter[0] += 1
        out = np.lib.format.open_memmap(
            path, mode="w+", dtype=a.dtype, shape=(len(idx),) + a.shape[1:])
        for s in range(0, len(idx), chunk):
            sel = idx[s:s + chunk]
            out[s:s + len(sel)] = a[sel]
        out.flush()
        return np.load(path, mmap_mode="r")

    return tree_map(take, tree)


def _spill_to_disk(tree, cache_dir: str):
    """Replace each array with a read-only memmap backed by ``cache_dir``."""
    os.makedirs(cache_dir, exist_ok=True)
    counter = [0]

    def spill(x):
        x = np.asarray(x)
        path = os.path.join(cache_dir, f"arr_{counter[0]}.npy")
        counter[0] += 1
        np.save(path, x)
        return np.load(path, mmap_mode="r")

    return tree_map(spill, tree)


def to_device(tree, device: torch.device, non_blocking: bool = False):
    """Numpy leaves -> tensors on ``device`` (pinned host staging and an
    asynchronous copy when ``non_blocking`` and the device is CUDA)."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type != "cuda":
            return t.to(device)
        if non_blocking:
            t = t.pin_memory()
        return t.to(device, non_blocking=non_blocking)

    return tree_map(put, tree)


class ZooDataset:
    """An in-memory (or disk-tiered) dataset of features + optional labels.

    ``features`` / ``labels`` are pytrees (array, dict, or tuple of arrays)
    sharing a leading sample dimension.
    """

    def __init__(self, features: Any, labels: Any = None,
                 memory_type: str = "DRAM",
                 cache_dir: Optional[str] = None):
        memory_type = memory_type.upper()
        if memory_type not in ("DRAM", "DISK"):
            raise ValueError(
                f"memory_type must be DRAM or DISK, got {memory_type!r}")
        features = tree_map(np.asarray, features)
        labels = tree_map(np.asarray, labels) if labels is not None else None
        self._n = _leading_dim(features)
        if labels is not None and _leading_dim(labels) != self._n:
            raise ValueError("features and labels disagree on sample count")
        if memory_type == "DISK":
            owned = cache_dir is None
            cache_dir = cache_dir or tempfile.mkdtemp(prefix="zoo_dataset_")
            features = _spill_to_disk(features, os.path.join(cache_dir, "x"))
            if labels is not None:
                labels = _spill_to_disk(labels, os.path.join(cache_dir, "y"))
            logger.info("dataset spilled to disk tier at %s", cache_dir)
            if owned:
                self._own_cache_dir(cache_dir)
        self.features = features
        self.labels = labels
        self.memory_type = memory_type

    def _own_cache_dir(self, cache_dir: str) -> None:
        """Delete a framework-created spill dir when the dataset is GC'd
        (user-supplied cache_dirs are never touched)."""
        import shutil
        import weakref

        weakref.finalize(self, shutil.rmtree, cache_dir,
                         ignore_errors=True)

    # ----------------------------------------------------- constructors --
    @staticmethod
    def from_ndarrays(features: Any, labels: Any = None,
                      **kwargs) -> "ZooDataset":
        return ZooDataset(features, labels, **kwargs)

    @staticmethod
    def from_xshards(shards, feature_cols=None, label_cols=None,
                     **kwargs) -> "ZooDataset":
        """Build from an XShards of dicts / DataFrames."""
        merged = shards.merged()
        if isinstance(merged, dict):
            if feature_cols is None and "x" in merged:
                feats = merged["x"]
                labels = merged.get("y")
            else:
                feature_cols = feature_cols or list(merged.keys())
                feats = {c: merged[c] for c in feature_cols}
                labels = ({c: merged[c] for c in label_cols}
                          if label_cols else None)
                if labels is not None and len(labels) == 1:
                    labels = next(iter(labels.values()))
            return ZooDataset(feats, labels, **kwargs)
        if hasattr(merged, "columns"):  # a pandas DataFrame
            if feature_cols is None:
                raise ValueError("feature_cols required for DataFrame shards")
            feats = {c: merged[c].to_numpy() for c in feature_cols}
            labels = ({c: merged[c].to_numpy() for c in label_cols}
                      if label_cols else None)
            if labels is not None and len(labels) == 1:
                labels = next(iter(labels.values()))
            return ZooDataset(feats, labels, **kwargs)
        return ZooDataset(merged, **kwargs)

    # ----------------------------------------------------------- queries --
    @property
    def num_samples(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def split(self, fraction: float, seed: int = 0
              ) -> Tuple["ZooDataset", "ZooDataset"]:
        """Random split into (first, second) with ``fraction`` in first."""
        rng = np.random.RandomState(seed)
        perm = rng.permutation(self._n)
        cut = int(self._n * fraction)

        def make(idx):
            cache_dir = (tempfile.mkdtemp(prefix="zoo_split_")
                         if self.memory_type == "DISK" else "")
            feats = _take_chunked(self.features, idx, self.memory_type,
                                  os.path.join(cache_dir, "x"))
            labs = (_take_chunked(self.labels, idx, self.memory_type,
                                  os.path.join(cache_dir, "y"))
                    if self.labels is not None else None)
            child = ZooDataset(feats, labs)
            child.memory_type = self.memory_type
            if cache_dir:
                child._own_cache_dir(cache_dir)
            return child

        return make(perm[:cut]), make(perm[cut:])

    def map_features(self, fn: Callable) -> "ZooDataset":
        return ZooDataset(fn(self.features), self.labels)

    # --------------------------------------------------------- iteration --
    def steps_per_epoch(self, batch_size: int,
                        drop_remainder: bool = True) -> int:
        if drop_remainder:
            return self._n // batch_size
        return -(-self._n // batch_size)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                epoch: int = 0, drop_remainder: bool = True,
                mesh=None, with_mask: bool = False
                ) -> Iterator[Tuple[Any, ...]]:
        """Yield host numpy ``(features, labels)`` batches, in the
        reference's order. With ``drop_remainder=False`` the final short
        batch is padded up to ``batch_size`` by wrapping the epoch's
        order; with ``with_mask=True`` each yield is ``(x, y, mask)``,
        ``mask`` a float32 [batch_size] vector with 0 on padded rows."""
        if mesh is not None:
            raise NotImplementedError(f"ZooDataset.batches(mesh=...) "
                                      f"{_PARALLEL}")
        if shuffle:
            rng = np.random.RandomState((seed * 100003 + epoch) & 0x7FFFFFFF)
            order = rng.permutation(self._n)
        else:
            order = np.arange(self._n)

        positions = np.arange(batch_size)
        for b in range(self.steps_per_epoch(batch_size, drop_remainder)):
            idx = order[b * batch_size:(b + 1) * batch_size]
            n_valid = len(idx)
            if n_valid < batch_size:  # pad final short batch (tiled wrap)
                idx = np.concatenate(
                    [idx, np.resize(order, batch_size - n_valid)])
            x = tree_map(lambda a: np.asarray(a[idx]), self.features)
            y = (tree_map(lambda a: np.asarray(a[idx]), self.labels)
                 if self.labels is not None else None)
            if with_mask:
                yield x, y, (positions < n_valid).astype(np.float32)
            else:
                yield x, y

    def device_iterator(self, batch_size: int, device=None,
                        shuffle: bool = True, seed: int = 0, epoch: int = 0,
                        drop_remainder: bool = True, with_mask: bool = False,
                        prefetch: Optional[int] = None, mesh=None
                        ) -> Iterator[Tuple[Any, ...]]:
        """``batches`` moved to ``device`` (default CUDA) with background
        prefetch: a producer thread stages the next ``prefetch`` batches
        (default: the ``zoo.data.prefetch_buffer`` config key) in pinned
        memory and copies them on a side stream; the consumer's stream
        waits for each batch's copy before using it."""
        if mesh is not None:
            raise NotImplementedError(f"ZooDataset.device_iterator(mesh=...) "
                                      f"{_PARALLEL}")
        from analytics_zoo_tpu_torch.common.context import resolve_device

        device = resolve_device(device)
        if prefetch is None:
            prefetch = int(get_config().get("zoo.data.prefetch_buffer", 2))
        cuda = device.type == "cuda"
        copy_stream = torch.cuda.Stream(device) if cuda else None
        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        sentinel = object()
        err: list = []
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up if the consumer went away, so an
            # abandoned iterator never leaks a blocked thread holding
            # device batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self.batches(batch_size, shuffle, seed, epoch,
                                         drop_remainder,
                                         with_mask=with_mask):
                    if cuda:
                        with torch.cuda.stream(copy_stream):
                            placed = to_device(item, device,
                                               non_blocking=True)
                            ready = torch.cuda.Event()
                            ready.record(copy_stream)
                    else:
                        placed, ready = to_device(item, device), None
                    if not put((placed, ready)):
                        return
            except BaseException as e:  # surface in consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                placed, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(ready)
                    # the batch was allocated on the copy stream; tell the
                    # caching allocator it is used on this one too
                    for leaf in tree_leaves(placed):
                        leaf.record_stream(stream)
                yield placed
        finally:
            stop.set()

"""XShards: a partitioned collection of data shards, carried across from
``analytics_zoo_tpu/data/shard.py`` (numpy and pandas only).

The analog of Orca's ``XShards``/``SparkXShards``
(ref: pyzoo/zoo/orca/data/shard.py:26-541 -- ``partition``,
``transform_shard``, ``collect``, ``num_partitions``, ``repartition``,
``zip``). Where the reference moves shards between Spark partitions and
Ray plasma, here shards are host-resident (numpy / pandas) and transforms
run on a thread pool -- device placement is the engine's job, and heavy
per-shard math belongs in jitted functions, not in the shard transform.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


class XShards:
    """A list of shards; each shard is any python object (typically a dict
    of ndarrays or a pandas DataFrame)."""

    def __init__(self, shards: Sequence[Any]):
        if not shards:
            raise ValueError("XShards needs at least one shard")
        self._shards: List[Any] = list(shards)

    # ------------------------------------------------------ construction --
    @staticmethod
    def partition(data: Any, num_shards: Optional[int] = None) -> "XShards":
        """Split a dict-of-ndarrays / ndarray / DataFrame into shards
        (ref: shard.py:65 ``zoo.orca.data.XShards.partition``)."""
        import pandas as pd

        num_shards = num_shards or _default_num_shards()

        if isinstance(data, np.ndarray):
            return XShards(np.array_split(data, num_shards))
        if isinstance(data, pd.DataFrame):
            idx = np.array_split(np.arange(len(data)), num_shards)
            return XShards([data.iloc[i] for i in idx])
        if isinstance(data, dict):
            keys = list(data.keys())
            arrays = [np.asarray(data[k]) for k in keys]
            n = arrays[0].shape[0]
            if any(a.shape[0] != n for a in arrays):
                raise ValueError("all arrays must share the leading dim")
            idx = np.array_split(np.arange(n), num_shards)
            return XShards([{k: a[i] for k, a in zip(keys, arrays)}
                            for i in idx])
        if isinstance(data, (list, tuple)):
            arrays = [np.asarray(a) for a in data]
            n = arrays[0].shape[0]
            if any(a.shape[0] != n for a in arrays):
                raise ValueError("all arrays must share the leading dim")
            idx = np.array_split(np.arange(n), num_shards)
            return XShards([type(data)(a[i] for a in arrays) for i in idx])
        raise TypeError(f"cannot partition {type(data)}")

    # -------------------------------------------------------- transforms --
    def transform_shard(self, fn: Callable, *args) -> "XShards":
        """Apply ``fn(shard, *args)`` to every shard in parallel
        (ref: shard.py transform_shard)."""
        with ThreadPoolExecutor(max_workers=min(len(self._shards), 16)) as ex:
            return XShards(list(ex.map(lambda s: fn(s, *args),
                                       self._shards)))

    def zip(self, other: "XShards") -> "XShards":
        if other.num_partitions() != self.num_partitions():
            raise ValueError("zip requires equal partition counts")
        return XShards(list(zip(self._shards, other._shards)))

    def repartition(self, num_shards: int) -> "XShards":
        merged = self._merge(self.collect())
        return XShards.partition(merged, num_shards)

    # ------------------------------------------------------------ access --
    def collect(self) -> List[Any]:
        return list(self._shards)

    def num_partitions(self) -> int:
        return len(self._shards)

    def __len__(self) -> int:
        def shard_len(s) -> int:
            if isinstance(s, dict):
                return len(next(iter(s.values())))
            if isinstance(s, (list, tuple)) and len(s) and \
                    isinstance(s[0], np.ndarray):
                return len(s[0])
            if hasattr(s, "__len__"):
                return len(s)
            raise TypeError(f"shard of {type(s)} has no length")

        return sum(shard_len(s) for s in self._shards)

    def merged(self) -> Any:
        """Concatenate all shards back into one object."""
        return self._merge(self._shards)

    @staticmethod
    def _merge(shards: List[Any]) -> Any:
        import pandas as pd

        first = shards[0]
        if isinstance(first, np.ndarray):
            return np.concatenate(shards)
        if isinstance(first, pd.DataFrame):
            return pd.concat(shards, ignore_index=True)
        if isinstance(first, dict):
            return {k: np.concatenate([s[k] for s in shards])
                    for k in first.keys()}
        if isinstance(first, (list, tuple)):
            return type(first)(np.concatenate([s[i] for s in shards])
                               for i in range(len(first)))
        raise TypeError(f"cannot merge shards of {type(first)}")

    def to_dataset(self, **kwargs):
        """Materialize into a ZooDataset for training."""
        from analytics_zoo_tpu_torch.data.dataset import ZooDataset

        return ZooDataset.from_xshards(self, **kwargs)


def _default_num_shards() -> int:
    # the reference's max(jax.local_device_count(), 2)
    import torch

    return max(torch.cuda.device_count(), 2)

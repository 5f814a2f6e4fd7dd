"""Data layer: ``ZooDataset`` (host batches, prefetched device batches)
and ``XShards``. The reference's ``data/sources.py`` readers and
``data/bucketing.py`` are still to be ported (ROADMAP queue 1)."""

from analytics_zoo_tpu_torch.data.shard import XShards  # noqa: F401
from analytics_zoo_tpu_torch.data.dataset import ZooDataset  # noqa: F401

from analytics_zoo_tpu_torch.common.config import ZooConfig, get_config
from analytics_zoo_tpu_torch.common.context import resolve_device

__all__ = ["ZooConfig", "get_config", "resolve_device"]

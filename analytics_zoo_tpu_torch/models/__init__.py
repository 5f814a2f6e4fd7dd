from analytics_zoo_tpu_torch.models.common import (  # noqa: F401
    ZooModel,
    register_model,
)
from analytics_zoo_tpu_torch.models.text import (  # noqa: F401
    BERTNER,
    BERTClassifier,
    BERTSQuAD,
)

from analytics_zoo_tpu_torch.models.text.classifier import (  # noqa: F401
    TextClassifier,
)
from analytics_zoo_tpu_torch.models.text.knrm import KNRM  # noqa: F401
from analytics_zoo_tpu_torch.models.text.bert_estimators import (  # noqa: F401
    BERTNER,
    BERTClassifier,
)
from analytics_zoo_tpu_torch.models.text.bert_squad import (  # noqa: F401
    BERTSQuAD,
)

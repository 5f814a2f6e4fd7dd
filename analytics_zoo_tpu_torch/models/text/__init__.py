from analytics_zoo_tpu_torch.models.text.bert_estimators import (  # noqa: F401
    BERTClassifier,
)

from analytics_zoo_tpu_torch.models.common import (  # noqa: F401
    ZooModel,
    register_model,
    softmax_probs,
    topk_with_probs,
)
from analytics_zoo_tpu_torch.models.recommendation import (  # noqa: F401
    NeuralCF,
    Recommender,
    UserItemFeature,
    UserItemPrediction,
)
from analytics_zoo_tpu_torch.models.text import (  # noqa: F401
    BERTNER,
    BERTClassifier,
    BERTSQuAD,
)
from analytics_zoo_tpu_torch.models.image import (  # noqa: F401
    ImageClassifier,
    ResNet18,
    ResNet50,
)

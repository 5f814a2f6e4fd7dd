from analytics_zoo_tpu_torch.models.common import (  # noqa: F401
    ZooModel,
    register_model,
    softmax_probs,
    topk_with_probs,
)
from analytics_zoo_tpu_torch.models.recommendation import (  # noqa: F401
    ColumnFeatureInfo,
    NeuralCF,
    Recommender,
    SessionRecommender,
    UserItemFeature,
    UserItemPrediction,
    WideAndDeep,
)
from analytics_zoo_tpu_torch.models.text import (  # noqa: F401
    BERTNER,
    KNRM,
    BERTClassifier,
    BERTSQuAD,
    TextClassifier,
)
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq  # noqa: F401
from analytics_zoo_tpu_torch.models.anomaly import AnomalyDetector  # noqa: F401
from analytics_zoo_tpu_torch.models.image import (  # noqa: F401
    ImageClassifier,
    ObjectDetector,
    ResNet18,
    ResNet50,
)

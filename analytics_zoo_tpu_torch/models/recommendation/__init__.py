"""Recommendation models: the recommender base, NCF, Wide & Deep and
the session recommender."""

from analytics_zoo_tpu_torch.models.recommendation.base import (  # noqa: F401
    Recommender,
    UserItemFeature,
    UserItemPrediction,
)
from analytics_zoo_tpu_torch.models.recommendation.ncf import (  # noqa: F401
    NeuralCF,
)
from analytics_zoo_tpu_torch.models.recommendation.wide_and_deep import (  # noqa: F401
    ColumnFeatureInfo,
    WideAndDeep,
)
from analytics_zoo_tpu_torch.models.recommendation.session_recommender import (  # noqa: F401
    SessionRecommender,
)

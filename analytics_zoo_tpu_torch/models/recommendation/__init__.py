"""Recommendation models: the recommender base and NCF."""

from analytics_zoo_tpu_torch.models.recommendation.base import (  # noqa: F401
    Recommender,
    UserItemFeature,
    UserItemPrediction,
)
from analytics_zoo_tpu_torch.models.recommendation.ncf import (  # noqa: F401
    NeuralCF,
)

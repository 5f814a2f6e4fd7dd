"""Vision models: ResNet backbones and the image classifier."""

from analytics_zoo_tpu_torch.models.image.resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet50,
)
from analytics_zoo_tpu_torch.models.image.classifier import (  # noqa: F401
    ImageClassifier,
)

"""Vision models: the classification backbones, the image classifier
and the SSD and Faster-RCNN detectors."""

from analytics_zoo_tpu_torch.models.image.resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet50,
)
from analytics_zoo_tpu_torch.models.image.backbones import (  # noqa: F401
    AlexNet,
    DenseNet,
    InceptionV1,
    InceptionV3,
    MobileNetV1,
    MobileNetV2,
    SqueezeNet,
    VGG16,
    VGG19,
    densenet161,
)
from analytics_zoo_tpu_torch.models.image.classifier import (  # noqa: F401
    ImageClassifier,
)
from analytics_zoo_tpu_torch.models.image import detection  # noqa: F401
from analytics_zoo_tpu_torch.models.image.object_detection import (  # noqa: F401
    ObjectDetector,
    SSDModule,
    generate_anchors,
    visualize,
)
from analytics_zoo_tpu_torch.models.image.faster_rcnn import (  # noqa: F401
    FasterRCNN,
)

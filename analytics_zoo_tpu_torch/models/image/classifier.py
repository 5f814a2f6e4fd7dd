"""Image classification model wrapper.

The counterpart of ``analytics_zoo_tpu/models/image/classifier.py``:
``ImageClassifier`` over any of the reference's twelve backbones
(``resnet18``, ``resnet50`` and those of ``backbones.py``), whose module
``_NormalizedBackbone`` takes raw uint8 NHWC images and normalizes them
on the device (``(x / 255 - mean) / std`` with ImageNet's channel
statistics) or float images as they are. Served clients send uint8, a
quarter of the bytes of host-side f32 preprocessing. The flax submodule
is ``backbone``, so parameter paths are
``backbone/stage0_block0/conv1/kernel`` and so on. VGG and AlexNet are
built for the classifier's ``image_size`` (their ``fc6`` width depends
on it).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.models.common import (
    ZooModel, register_model, softmax_probs, topk_with_probs, torch_dtype)
from analytics_zoo_tpu_torch.models.image.backbones import (
    AlexNet, DenseNet, InceptionV1, InceptionV3, MobileNetV1, MobileNetV2,
    SqueezeNet, VGG16, VGG19, densenet161)
from analytics_zoo_tpu_torch.models.image.resnet import ResNet18, ResNet50

# the reference's full family, every member trainable
_BACKBONES = {"resnet18": ResNet18, "resnet50": ResNet50,
              "inception-v1": InceptionV1, "inception-v3": InceptionV3,
              "mobilenet": MobileNetV1, "mobilenet-v2": MobileNetV2,
              "vgg16": VGG16, "vgg19": VGG19, "alexnet": AlexNet,
              "squeezenet": SqueezeNet, "densenet121": DenseNet,
              "densenet161": densenet161}
# the backbones whose fc6 is built for the image size
_SIZED = ("vgg16", "vgg19", "alexnet")

# ImageNet channel stats (the reference's ImageChannelNormalize defaults)
_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class _NormalizedBackbone(nn.Module):
    """Backbone wrapper: integer images are normalized in f32 on the
    device, float images pass through untouched (assumed already
    normalized)."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone
        # moved with the module, never saved
        self.register_buffer("pixel_mean", torch.from_numpy(_MEAN),
                             persistent=False)
        self.register_buffer("pixel_std", torch.from_numpy(_STD),
                             persistent=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if not torch.is_floating_point(x):
            x = (x.float() / 255.0 - self.pixel_mean) / self.pixel_std
        return self.backbone(x, train=train, rng=rng)


@register_model
class ImageClassifier(ZooModel):
    """Trainable classifier over one of the reference's backbones.
    Accepts normalized float images or raw uint8 (normalized on the
    device)."""

    default_loss = "sparse_categorical_crossentropy"
    default_optimizer = "adam"
    default_metrics = ("accuracy", "top5")

    def __init__(self, class_num: int, backbone: str = "resnet50",
                 image_size: int = 224, dtype: str = "float32",
                 device=None, seed: int = 0):
        if backbone not in _BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r}; "
                             f"known: {sorted(_BACKBONES)}")
        super().__init__(device=device, seed=seed, class_num=class_num,
                         backbone=backbone, image_size=image_size,
                         dtype=dtype)

    def _build_module(self):
        c = self._config
        sized = ({"image_size": c["image_size"]}
                 if c["backbone"] in _SIZED else {})
        return _NormalizedBackbone(_BACKBONES[c["backbone"]](
            num_classes=c["class_num"], dtype=torch_dtype(c["dtype"]),
            **sized))

    def _example_input(self):
        s = self._config["image_size"]
        return np.zeros((1, s, s, 3), np.float32)

    @staticmethod
    def preprocess(images: np.ndarray) -> np.ndarray:
        """uint8 [N, H, W, 3] -> normalized float32."""
        x = np.asarray(images, np.float32) / 255.0
        return (x - _MEAN) / _STD

    def predict_classes(self, images, batch_size: int = 32,
                        top_k: int = 1):
        """Top-k (class, score) per image. Integer images go to the
        device raw (normalized there); float images are taken as raw
        0-255 and preprocessed on the host."""
        images = np.asarray(images)
        x = (images if np.issubdtype(images.dtype, np.integer)
             else self.preprocess(images))
        logits = self.predict(x, batch_size=batch_size)
        return topk_with_probs(softmax_probs(logits), top_k)

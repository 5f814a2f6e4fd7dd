"""Keras-style model API on PyTorch: the counterpart of
``analytics_zoo_tpu/keras`` (``Input``, ``Sequential``, ``Model`` and the
layers of ``keras.layers``). Layers are declarative configs that build
``nn.Module``s; ``Sequential`` and graph ``Model`` compile into the
port's Estimator. Channels-last layouts, as the reference's."""

from analytics_zoo_tpu_torch.keras.engine import (  # noqa: F401
    Input,
    KTensor,
    Model,
    Sequential,
)
from analytics_zoo_tpu_torch.keras import layers  # noqa: F401
from analytics_zoo_tpu_torch.keras import activations  # noqa: F401
from analytics_zoo_tpu_torch.learn import objectives  # noqa: F401
from analytics_zoo_tpu_torch.keras.layers.transformer import (  # noqa: F401
    BERTModule,
    MultiHeadSelfAttention,
    TransformerBlock,
    TransformerModule,
)

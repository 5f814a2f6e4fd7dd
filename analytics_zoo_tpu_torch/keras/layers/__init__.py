"""Keras layer library: the counterpart of
``analytics_zoo_tpu/keras/layers``, re-exported here by family. The
convolutional, pooling, embedding, recurrent and torch-style layers and
the Keras normalization layers are still to be ported (ROADMAP section
1, item 3, slice 3b)."""

from analytics_zoo_tpu_torch.keras.layers.core import (  # noqa: F401
    Activation,
    Dense,
    Dropout,
    Flatten,
    GaussianDropout,
    GaussianNoise,
    GaussianSampler,
    Highway,
    InputLayer,
    Lambda,
    Masking,
    MaxoutDense,
    Permute,
    RepeatVector,
    Reshape,
    SpatialDropout1D,
    SpatialDropout2D,
    SpatialDropout3D,
    SReLU,
)
from analytics_zoo_tpu_torch.keras.layers.merge import (  # noqa: F401
    MM,
    Merge,
    SelectTable,
    SplitTensor,
    average,
    concatenate,
    dot,
    maximum,
    multiply,
)
from analytics_zoo_tpu_torch.keras.layers.merge import add as merge_add  # noqa: F401
from analytics_zoo_tpu_torch.keras.layers.advanced_activations import (  # noqa: F401
    ELU,
    LeakyReLU,
    PReLU,
    ThresholdedReLU,
)
from analytics_zoo_tpu_torch.keras.layers.transformer import (  # noqa: F401
    BERT,
    BERTKL,
    BERTModule,
    MultiHeadSelfAttention,
    TransformerBlock,
    TransformerLayer,
    TransformerLayerKL,
    TransformerModule,
)

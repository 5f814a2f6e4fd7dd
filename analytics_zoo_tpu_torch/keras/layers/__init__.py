from analytics_zoo_tpu_torch.keras.layers.transformer import (  # noqa: F401
    BERTModule,
    MultiHeadSelfAttention,
    TransformerBlock,
    TransformerModule,
)

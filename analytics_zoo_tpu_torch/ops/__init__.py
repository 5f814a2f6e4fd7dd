"""Attention dispatch and the hand-written Hopper kernels
(``ops.flash_attention``: K1, its plain version and its build)."""

from analytics_zoo_tpu_torch.ops.attention import (  # noqa: F401
    dot_product_attention,
    reference_attention,
)

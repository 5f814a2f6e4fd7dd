from analytics_zoo_tpu_torch.inference.inference_model import (  # noqa: F401
    InferenceModel,
    bucket_ladder,
)

"""Training engine: the Estimator with its optimizers, losses, metrics,
checkpoints and profiler (``learn/gan.py`` and ``learn/population.py``
are still to be ported)."""

from analytics_zoo_tpu_torch.learn.estimator import Estimator  # noqa: F401
from analytics_zoo_tpu_torch.learn.profiler import (  # noqa: F401
    TrainingProfiler,
)
from analytics_zoo_tpu_torch.learn import metrics  # noqa: F401
from analytics_zoo_tpu_torch.learn import objectives  # noqa: F401
from analytics_zoo_tpu_torch.learn.optim import (  # noqa: F401
    SGD,
    Adam,
    AdamWeightDecay,
    RMSprop,
    Adagrad,
    Adadelta,
    Fixed,
    Poly,
    Warmup,
)

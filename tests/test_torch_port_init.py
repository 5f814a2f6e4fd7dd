"""PyTorch port, default initializers: the spread and the extremes of
the seeded weights of the port's ``Dense``, ``Conv`` and ``Embed``
against flax's ``lecun_normal`` and ``default_embed_init`` over one
large draw each (the seeds cannot match, so the distributions are
compared: std x sqrt(fan_in) within 2%, the largest |w| x sqrt(fan_in)
at flax's truncation point, or beyond 4 for the untruncated embedding).
``Dense``'s bias options are held here too.
"""

import math

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.keras.layers.transformer import Dense, Embed
from analytics_zoo_tpu_torch.models.image.resnet import Conv

torch.set_num_threads(2)

# flax's lecun_normal: a normal of std s / 0.8796 truncated at +-2 of it
TRUNC = 2.0 / 0.87962566103423978
SPREAD_TOL = 0.02


def _spread(w: np.ndarray, fan_in: int):
    w = np.asarray(w, np.float64) * math.sqrt(fan_in)
    return float(w.std()), float(np.abs(w).max())


def _port(module, fan_in):
    gen = torch.Generator().manual_seed(0)
    module.reset_parameters(gen)
    return _spread(module.weight.detach().numpy(), fan_in)


# (case, the port's module, flax's initializer, the flax kernel's shape,
# fan_in, truncated)
CASES = [
    ("dense", lambda: Dense(1024, 512), nn.initializers.lecun_normal(),
     (1024, 512), 1024, True),
    ("conv", lambda: Conv(64, 512, (3, 3)), nn.initializers.lecun_normal(),
     (3, 3, 64, 512), 576, True),
    ("embed", lambda: Embed(4096, 256), nn.linear.default_embed_init,
     (4096, 256), 256, False),
]


@pytest.mark.parametrize("case,make,init,shape,fan_in,truncated", CASES,
                         ids=[c[0] for c in CASES])
def test_spread_matches_flax(case, make, init, shape, fan_in, truncated):
    want_std, want_max = _spread(init(jax.random.PRNGKey(0), shape),
                                 fan_in)
    got_std, got_max = _port(make(), fan_in)
    # flax's draw itself has the spread 1/sqrt(fan_in)
    assert abs(want_std - 1.0) < SPREAD_TOL, want_std
    assert abs(got_std / want_std - 1.0) < SPREAD_TOL, (got_std, want_std)
    if truncated:
        for m in (got_max, want_max):
            assert TRUNC * 0.99 < m <= TRUNC * (1 + 1e-6), (got_max,
                                                            want_max)
    else:
        assert got_max > 4.0 and want_max > 4.0, (got_max, want_max)


def test_dense_bias_init_and_no_bias():
    gen = torch.Generator().manual_seed(0)
    d = Dense(8, 4, bias_init=-2.0)
    d.reset_parameters(gen)
    assert torch.equal(d.bias, torch.full((4,), -2.0))
    n = Dense(8, 4, use_bias=False)
    n.reset_parameters(gen)
    assert n.bias is None
    x = torch.randn(3, 8)
    torch.testing.assert_close(n(x), x @ n.weight.T)

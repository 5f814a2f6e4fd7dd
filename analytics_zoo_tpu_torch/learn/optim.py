"""Optimizers and LR schedules.

The counterpart of ``analytics_zoo_tpu/learn/optim.py``. The reference's
optimizers are optax chains; here each ``ZooOptimizer.to_transform()``
yields a ``GradientTransformation`` with optax's ``init``/``update``
contract and optax's arithmetic, written out on tensors (``torch.optim``
differs in places: RMSprop adds eps after the square root, Adagrad's
accumulator starts at 0, ``clip_grad_norm_`` adds 1e-6). Where optax
and torch disagree, optax wins:

- ``rmsprop`` scales by ``rsqrt(nu + eps)``;
- ``adagrad`` starts its accumulator at 0.1;
- ``clip_by_global_norm`` divides by the norm itself, no epsilon;
- a schedule is read at the step count *before* the increment, so a
  ``Warmup`` from 0 makes the first update zero.

Parameters, gradients and updates are dicts keyed by flax-style paths
(``bert/encoder_0/ln_attn/scale``; see ``param_tree``), so
``AdamWeightDecay``'s name mask sees the names the reference's mask sees.
Optimizer state is a nest of lists (a chain), dicts (a transformation's
fields, or a per-parameter tree keyed by path), ints and tensors. Each
optimizer is chained as optax chains it, ``identity`` and masked state
included, so its state maps one for one onto the optax state the JAX
package checkpoints (``learn/checkpoint.py``). Updates are computed with
``torch._foreach_*``: a handful of launches per step instead of several
per parameter.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

Params = Dict[str, torch.Tensor]
ScheduleLike = Union[float, Callable[[int], float]]


# -------------------------------------------------------------- schedules --
def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int, transition_begin: int = 0):
    """``optax.polynomial_schedule``."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        count = min(max(count - transition_begin, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * (frac ** power) + end_value

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int, transition_begin: int = 0):
    return polynomial_schedule(init_value, end_value, 1, transition_steps,
                               transition_begin)


def join_schedules(schedules: Sequence[Callable], boundaries: Sequence[int]):
    """``optax.join_schedules``: after each boundary the next schedule
    runs with its count restarted at 0."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


class LearningRateSchedule:
    def to_schedule(self) -> ScheduleLike:
        raise NotImplementedError


class Fixed(LearningRateSchedule):
    """Constant LR (ref: Optim.Fixed, common/Optim.scala:29)."""

    def __init__(self, lr: float):
        self.lr = lr

    def to_schedule(self):
        return self.lr


class Poly(LearningRateSchedule):
    """Polynomial decay to zero over ``max_iteration`` steps (BigDL Poly)."""

    def __init__(self, power: float, max_iteration: int, lr: float):
        self.power, self.max_iteration, self.lr = power, max_iteration, lr

    def to_schedule(self):
        return polynomial_schedule(self.lr, 0.0, self.power,
                                   self.max_iteration)


class Warmup(LearningRateSchedule):
    """Linear warmup then constant / linear decay (the schedule baked into
    the reference's AdamWeightDecay for BERT)."""

    def __init__(self, lr: float, warmup_steps: int,
                 total_steps: Optional[int] = None):
        self.lr, self.warmup_steps, self.total_steps = (
            lr, warmup_steps, total_steps)

    def to_schedule(self):
        warm = linear_schedule(0.0, self.lr, self.warmup_steps)
        if self.total_steps is None:
            return join_schedules([warm, lambda count: self.lr],
                                  [self.warmup_steps])
        decay = linear_schedule(
            self.lr, 0.0, max(self.total_steps - self.warmup_steps, 1))
        return join_schedules([warm, decay], [self.warmup_steps])


def _as_schedule(lr) -> ScheduleLike:
    if isinstance(lr, LearningRateSchedule):
        return lr.to_schedule()
    return lr


# ----------------------------------------------------------- transforms --
class GradientTransformation:
    """optax's contract: ``init(params) -> state``;
    ``update(updates, state, params) -> (updates, state)``. ``update``
    may change ``state``'s tensors in place."""

    def init(self, params: Params) -> Any:
        return {}

    def update(self, updates: Params, state: Any, params: Params):
        raise NotImplementedError


def _pow_correction(decay: float, count: int, moments) -> float:
    """1 - decay**count as optax computes it: in float32, or in float64
    for float64 moments (optax under x64)."""
    if moments and moments[0].dtype == torch.float64:
        return 1.0 - decay ** count
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _zeros(params: Params, value: float = 0.0) -> Params:
    return {k: torch.full_like(p, value) for k, p in params.items()}


def _values(d: Params, keys) -> List[torch.Tensor]:
    return [d[k] for k in keys]


class Identity(GradientTransformation):
    """optax.identity: updates pass unchanged (the place a chain keeps
    for an option that is off, e.g. ``sgd`` without momentum)."""

    def update(self, updates, state, params):
        return updates, state


class Chain(GradientTransformation):
    def __init__(self, *txs: GradientTransformation):
        self.txs = txs

    def init(self, params):
        return [tx.init(params) for tx in self.txs]

    def update(self, updates, state, params):
        new_state = []
        for tx, s in zip(self.txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, new_state


class ScaleByAdam(GradientTransformation):
    def __init__(self, b1: float, b2: float, eps: float,
                 eps_root: float = 0.0):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(self, updates, state, params):
        keys = list(updates)
        g = _values(updates, keys)
        mu, nu = _values(state["mu"], keys), _values(state["nu"], keys)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, _pow_correction(self.b1, count, mu))
        den = torch._foreach_div(nu, _pow_correction(self.b2, count, nu))
        if self.eps_root:
            torch._foreach_add_(den, self.eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        state["count"] = count
        return dict(zip(keys, torch._foreach_div(mu_hat, den))), state


class ScaleByRms(GradientTransformation):
    def __init__(self, decay: float, eps: float, initial_scale: float = 0.0):
        self.decay, self.eps, self.initial_scale = decay, eps, initial_scale

    def init(self, params):
        return {"nu": _zeros(params, self.initial_scale)}

    def update(self, updates, state, params):
        keys = list(updates)
        g, nu = _values(updates, keys), _values(state["nu"], keys)
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.decay)
        scale = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scale)
        return dict(zip(keys, torch._foreach_mul(scale, g))), state


class ScaleByRss(GradientTransformation):
    def __init__(self, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        self.initial, self.eps = initial_accumulator_value, eps

    def init(self, params):
        return {"sum_of_squares": _zeros(params, self.initial)}

    def update(self, updates, state, params):
        out = {}
        for k, g in updates.items():
            sos = state["sum_of_squares"][k]
            sos.addcmul_(g, g)
            inv = torch.where(sos > 0, torch.rsqrt(sos + self.eps), 0.0)
            out[k] = inv * g
        return out, state


class ScaleByAdadelta(GradientTransformation):
    def __init__(self, rho: float, eps: float):
        self.rho, self.eps = rho, eps

    def init(self, params):
        return {"e_g": _zeros(params), "e_x": _zeros(params)}

    def update(self, updates, state, params):
        out = {}
        for k, g in updates.items():
            e_g, e_x = state["e_g"][k], state["e_x"][k]
            e_g.mul_(self.rho).addcmul_(g, g, value=1 - self.rho)
            u = torch.sqrt(e_x + self.eps) / torch.sqrt(e_g + self.eps) * g
            e_x.mul_(self.rho).addcmul_(u, u, value=1 - self.rho)
            out[k] = u
        return out, state


class Trace(GradientTransformation):
    """Momentum: ``trace = g + decay * trace`` (optax.trace)."""

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov

    def init(self, params):
        return {"trace": _zeros(params)}

    def update(self, updates, state, params):
        keys = list(updates)
        g, tr = _values(updates, keys), _values(state["trace"], keys)
        torch._foreach_mul_(tr, self.decay)
        torch._foreach_add_(tr, g)
        if self.nesterov:
            out = torch._foreach_mul(tr, self.decay)
            torch._foreach_add_(out, g)
        else:
            out = [t.clone() for t in tr]
        return dict(zip(keys, out)), state


class ScaleByLearningRate(GradientTransformation):
    """Multiply by ``-lr``; a schedule is read at the count before the
    increment (optax.scale_by_schedule)."""

    def __init__(self, lr: ScheduleLike):
        self.lr = lr

    def init(self, params):
        return {"count": 0} if callable(self.lr) else {}

    def update(self, updates, state, params):
        if callable(self.lr):
            step = -float(self.lr(state["count"]))
            state["count"] += 1
        else:
            step = -float(self.lr)
        keys = list(updates)
        return dict(zip(keys, torch._foreach_mul(_values(updates, keys),
                                                 step))), state


class AddDecayedWeights(GradientTransformation):
    """``updates + weight_decay * params`` on the parameters whose names
    ``mask`` keeps (all when ``mask`` is None). With a mask its state is
    optax.masked's, ``{"inner_state": {}}``."""

    def __init__(self, weight_decay: float,
                 mask: Optional[Callable[[str], bool]] = None):
        self.weight_decay, self.mask = weight_decay, mask

    def init(self, params):
        return {} if self.mask is None else {"inner_state": {}}

    def update(self, updates, state, params):
        if not self.weight_decay:
            return updates, state
        keys = [k for k in updates if self.mask is None or self.mask(k)]
        out = dict(updates)
        new = torch._foreach_add(_values(updates, keys),
                                 _values(params, keys),
                                 alpha=self.weight_decay)
        out.update(zip(keys, new))
        return out, state


class Clip(GradientTransformation):
    """Element-wise clip to ``[-max_delta, max_delta]`` (optax.clip)."""

    def __init__(self, max_delta: float):
        self.max_delta = max_delta

    def update(self, updates, state, params):
        return {k: torch.clamp(g, -self.max_delta, self.max_delta)
                for k, g in updates.items()}, state


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class ClipByGlobalNorm(GradientTransformation):
    """optax.clip_by_global_norm: above ``max_norm`` every update becomes
    ``(t / norm) * max_norm``; no epsilon, and no host sync (the branch
    is a ``where`` on the device)."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def update(self, updates, state, params):
        keys = list(updates)
        g = _values(updates, keys)
        norm = global_norm(g)
        keep = norm < self.max_norm
        scaled = torch._foreach_div(g, norm)
        torch._foreach_mul_(scaled, self.max_norm)
        return {k: torch.where(keep, t, s)
                for k, t, s in zip(keys, g, scaled)}, state


# ----------------------------------------------------------- optimizers --
class ZooOptimizer:
    """Base optimizer config."""

    def to_transform(self) -> GradientTransformation:
        raise NotImplementedError


class SGD(ZooOptimizer):
    def __init__(self, lr: ScheduleLike = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr, self.momentum = lr, momentum
        self.nesterov, self.weight_decay = nesterov, weight_decay

    def to_transform(self):
        tx = Chain(Trace(self.momentum, self.nesterov) if self.momentum
                   else Identity(),
                   ScaleByLearningRate(_as_schedule(self.lr)))
        if self.weight_decay:
            tx = Chain(AddDecayedWeights(self.weight_decay), tx)
        return tx


class Adam(ZooOptimizer):
    def __init__(self, lr: ScheduleLike = 1e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8):
        self.lr, self.beta_1, self.beta_2, self.epsilon = (
            lr, beta_1, beta_2, epsilon)

    def to_transform(self):
        return Chain(ScaleByAdam(self.beta_1, self.beta_2, self.epsilon),
                     ScaleByLearningRate(_as_schedule(self.lr)))


class AdamWeightDecay(ZooOptimizer):
    """BERT-style decoupled weight decay, skipping every parameter whose
    flax-style path has an element containing one of ``EXCLUDE``
    (LayerNorm scales and biases by default)."""

    EXCLUDE = ("layer_norm", "layernorm", "ln", "bias", "scale")

    def __init__(self, lr: ScheduleLike = 1e-4, weight_decay: float = 0.01,
                 beta_1: float = 0.9, beta_2: float = 0.999,
                 epsilon: float = 1e-6,
                 exclude_from_weight_decay: Optional[Sequence[str]] = None):
        self.lr, self.weight_decay = lr, weight_decay
        self.beta_1, self.beta_2, self.epsilon = beta_1, beta_2, epsilon
        self.exclude = tuple(exclude_from_weight_decay
                             if exclude_from_weight_decay is not None
                             else self.EXCLUDE)

    def decays(self, path: str) -> bool:
        names = path.lower().split("/")
        return not any(e in n for n in names for e in self.exclude)

    def to_transform(self):
        return Chain(ScaleByAdam(self.beta_1, self.beta_2, self.epsilon),
                     AddDecayedWeights(self.weight_decay, self.decays),
                     ScaleByLearningRate(_as_schedule(self.lr)))


class RMSprop(ZooOptimizer):
    def __init__(self, lr: ScheduleLike = 1e-3, decay_rate: float = 0.9,
                 epsilon: float = 1e-8):
        self.lr, self.decay_rate, self.epsilon = lr, decay_rate, epsilon

    def to_transform(self):
        return Chain(ScaleByRms(self.decay_rate, self.epsilon), Identity(),
                     ScaleByLearningRate(_as_schedule(self.lr)))


class Adagrad(ZooOptimizer):
    def __init__(self, lr: ScheduleLike = 1e-2):
        self.lr = lr

    def to_transform(self):
        return Chain(ScaleByRss(0.1, 1e-7),
                     ScaleByLearningRate(_as_schedule(self.lr)))


class Adadelta(ZooOptimizer):
    def __init__(self, lr: ScheduleLike = 1.0, rho: float = 0.9,
                 epsilon: float = 1e-6):
        self.lr, self.rho, self.epsilon = lr, rho, epsilon

    def to_transform(self):
        return Chain(AddDecayedWeights(0.0),
                     ScaleByAdadelta(self.rho, self.epsilon),
                     ScaleByLearningRate(_as_schedule(self.lr)))


def resolve_optimizer(opt) -> GradientTransformation:
    """Accept a ZooOptimizer, a GradientTransformation, or a name."""
    if isinstance(opt, ZooOptimizer):
        return opt.to_transform()
    if isinstance(opt, GradientTransformation):
        return opt
    if isinstance(opt, str):
        table = {"sgd": SGD, "adam": Adam, "adamw": AdamWeightDecay,
                 "adamweightdecay": AdamWeightDecay, "rmsprop": RMSprop,
                 "adagrad": Adagrad, "adadelta": Adadelta}
        key = opt.lower()
        if key not in table:
            raise ValueError(f"unknown optimizer {opt!r}")
        return table[key]().to_transform()
    raise TypeError(f"cannot interpret optimizer {opt!r}")


def with_clipping(tx: GradientTransformation, clip_norm: Optional[float],
                  clip_value: Optional[float]) -> GradientTransformation:
    """``clip_value`` then ``clip_norm`` ahead of ``tx``, as the
    reference's Estimator chains them."""
    chain = []
    if clip_value is not None:
        chain.append(Clip(clip_value))
    if clip_norm is not None:
        chain.append(ClipByGlobalNorm(clip_norm))
    return Chain(*chain, tx) if chain else tx


# ----------------------------------------------------------- param tree --
def _flax_leaf(module: nn.Module, name: str) -> str:
    from analytics_zoo_tpu_torch.keras.layers.transformer import (
        Dense, Embed, LayerNorm)

    if name == "weight":
        # a layer of another file names its own (Conv, BatchNorm)
        own = getattr(module, "flax_weight_name", None)
        if own is not None:
            return own
        if isinstance(module, (Dense, nn.Linear)):
            return "kernel"
        if isinstance(module, (LayerNorm, nn.LayerNorm)):
            return "scale"
        if isinstance(module, (Embed, nn.Embedding)):
            return "embedding"
    return name


def flax_path(mname: str, leaf: str) -> str:
    """The flax-style path of ``leaf`` in the module named ``mname``."""
    return "/".join(([*mname.split(".")] if mname else []) + [leaf])


def param_tree(module: nn.Module) -> Dict[str, nn.Parameter]:
    """The module's parameters keyed by flax-style paths: module names
    joined by ``/``, with a Dense or Conv ``weight`` named ``kernel``, a
    LayerNorm or BatchNorm ``weight`` ``scale`` and an Embed ``weight``
    ``embedding`` (the reverse of ``bridge.state_dict_from_flax``'s
    renaming)."""
    out: Dict[str, nn.Parameter] = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            out[flax_path(mname, _flax_leaf(m, pname))] = p
    return out


def batch_stats_tree(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics of the module's BatchNorms (their
    ``mean`` and ``var`` buffers) keyed by their paths in flax's
    ``batch_stats`` collection; empty for a model without BatchNorm."""
    from analytics_zoo_tpu_torch.keras.layers.normalization import BatchNorm

    return {flax_path(mname, bname): b
            for mname, m in module.named_modules()
            if isinstance(m, BatchNorm)
            for bname, b in m.named_buffers(recurse=False)}

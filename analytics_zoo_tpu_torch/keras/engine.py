"""Keras engine: symbolic tensors, Sequential and graph Model topologies.

The counterpart of ``analytics_zoo_tpu/keras/engine.py`` (ref:
zoo/.../keras/models/Topology.scala KerasNet/Sequential/Model). ``Input``
makes a symbolic :class:`KTensor`; calling a layer on KTensors records a
:class:`Node`; ``Model(input, output)`` sorts the graph into one
``nn.Module`` in the reference's topological order; KTensor arithmetic
(+, -, *, /) is ``Lambda`` sugar. The built modules hold their layers as
``modules_0``, ``modules_1``, ... (flax's names for a tuple field), so a
parameter's path is the reference's (``modules_0/Dense_0/kernel``); a
layer called twice in one graph is one module, its parameters under its
first index. Each module's ``forward(x, train=False, rng=None)`` hands
``train`` and the dropout ``torch.Generator`` to every layer.

``compile()`` configures the port's ``Estimator`` (``learn/estimator.py``).
The Estimator reads the parameters when it is made, and a layer's
widths are known only from data, so a model is materialized at its
first ``fit``, ``evaluate`` or ``predict`` (or ``materialize``): one
forward on a one-row probe batch makes every parameter on the model's
device, then ``reset_parameters`` fills them from a generator seeded
with ``seed``, and only then is the Estimator made. ``compile()`` before
any data only records the configuration; after training it keeps the
weights and counters (``recompiled``). ``load_weights`` before the
model is materialized loads at materialization.

``device`` (None = CUDA, raising without a GPU) is where the model
lives. ``set_tensorboard`` and the summaries wait for the summary writer
(``utils/summary.py``, ROADMAP's "the rest") and raise.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.data.dataset import to_device
from analytics_zoo_tpu_torch.keras.layers.transformer import reset_parameters
from analytics_zoo_tpu_torch.learn.estimator import (Estimator, _as_dataset,
                                                     _call_args, recompiled)
from analytics_zoo_tpu_torch.utils.tree import tree_map

logger = get_logger(__name__)

_uid = itertools.count()

_SUMMARY = ("is not ported yet: the summary writer (utils/summary.py) "
            "arrives with ROADMAP's \"the rest\"")


class Node:
    """One layer invocation in the graph."""

    def __init__(self, layer, inputs: List["KTensor"]):
        self.layer = layer
        self.inputs = inputs
        self.id = next(_uid)


class KTensor:
    """Symbolic tensor: the output of a Node (or a graph input)."""

    def __init__(self, node: Optional[Node], shape=None,
                 input_index: Optional[int] = None):
        self.node = node
        self.shape = shape  # without batch dim, may be None
        self.input_index = input_index  # set for graph inputs

    # autograd-style arithmetic sugar (ref: api/autograd math.scala)
    def __add__(self, other):
        return _lambda_op("add", self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return _lambda_op("sub", self, other)

    def __rsub__(self, other):
        return _lambda_op("rsub", self, other)

    def __mul__(self, other):
        return _lambda_op("mul", self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _lambda_op("div", self, other)

    def __rtruediv__(self, other):
        return _lambda_op("rdiv", self, other)

    def __neg__(self):
        return _lambda_op("neg", self)


def Input(shape, name: Optional[str] = None) -> KTensor:
    """Graph input placeholder; ``shape`` excludes the batch dim
    (ref: keras/engine Input / InputLayer)."""
    return KTensor(node=None, shape=tuple(shape), input_index=next(_uid))


_OPS: Dict[str, Callable] = {
    "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
    "rsub": lambda x, y: y - x, "mul": lambda x, y: x * y,
    "div": lambda x, y: x / y, "rdiv": lambda x, y: y / x,
    "neg": lambda x: -x,
}


def _lambda_op(op: str, a, b=None) -> KTensor:
    from analytics_zoo_tpu_torch.keras.layers.core import Lambda

    fn = _OPS[op]
    if b is None:
        return Lambda(fn, name=f"lambda_{op}_{next(_uid)}")(a)
    if isinstance(b, KTensor):
        lam = Lambda(lambda xs: fn(xs[0], xs[1]),
                     name=f"lambda_{op}_{next(_uid)}")
        return lam([a, b])
    const = b
    return Lambda(lambda x: fn(x, const),
                  name=f"lambda_{op}_{next(_uid)}")(a)


# ------------------------------------------------------------- modules ---


def _build_once(layers: Sequence) -> List[nn.Module]:
    """Each layer's module, one per distinct layer: a layer that comes
    twice is one module with one set of parameters."""
    built: Dict[int, nn.Module] = {}
    for layer in layers:
        if id(layer) not in built:
            built[id(layer)] = layer.build()
    return [built[id(layer)] for layer in layers]


def _register(owner: nn.Module, modules: Sequence[nn.Module]) -> int:
    for i, m in enumerate(modules):
        owner.add_module(f"modules_{i}", m)
    return len(modules)


class _SequentialModule(nn.Module):
    """Applies built layer modules in order with a uniform train flag
    and generator."""

    def __init__(self, modules: Sequence[nn.Module]):
        super().__init__()
        self.n_modules = _register(self, modules)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        for i in range(self.n_modules):
            x = self._modules[f"modules_{i}"](x, train=train, rng=rng)
        return x


class _GraphModule(nn.Module):
    """Executes a topologically-sorted DAG of layer modules.

    ``input_slots[i]`` lists the slots module i reads: graph inputs
    first (0 .. n_inputs - 1), then each earlier module's output. The
    inputs come splatted or as one tuple or list."""

    def __init__(self, modules: Sequence[nn.Module],
                 input_slots: Sequence[Sequence[int]], n_inputs: int):
        super().__init__()
        self.n_modules = _register(self, modules)
        self.input_slots = tuple(tuple(s) for s in input_slots)
        self.n_inputs = n_inputs

    def forward(self, *xs, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if len(xs) == 1 and isinstance(xs[0], (tuple, list)):
            xs = tuple(xs[0])
        if len(xs) != self.n_inputs:
            raise ValueError(
                f"model expects {self.n_inputs} inputs, got {len(xs)}")
        values: List[Any] = list(xs)
        for i, slots in enumerate(self.input_slots):
            args = [values[s] for s in slots]
            values.append(self._modules[f"modules_{i}"](
                args if len(args) > 1 else args[0], train=train, rng=rng))
        return values[-1]


# ------------------------------------------------------------ topology ---


class KerasNet:
    """compile/fit/evaluate/predict surface shared by Sequential and Model
    (ref: Topology.scala:67-630 KerasNet)."""

    def __init__(self, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.seed = seed
        self._module: Optional[nn.Module] = None
        self.estimator: Optional[Estimator] = None
        self._compiled: Optional[Dict[str, Any]] = None
        self._checkpoint_dir = None
        self._checkpoint_trigger = None
        self._pending_load: Optional[str] = None

    def _build_module(self) -> nn.Module:
        raise NotImplementedError

    @property
    def module(self) -> nn.Module:
        """The model's module, built on ``device`` at the first access;
        its input-dependent parameters exist once it is materialized."""
        if self._module is None:
            with torch.device(self.device):
                self._module = self._build_module()
        return self._module

    @property
    def materialized(self) -> bool:
        return self.estimator is not None

    def materialize(self, x) -> "KerasNet":
        """Make every parameter from one row of the features ``x`` (an
        array, a tuple or dict of them, or a ``ZooDataset``), fill them
        from ``seed`` and make the Estimator. ``fit``, ``evaluate`` and
        ``predict`` call it themselves; a second call does nothing."""
        if self.materialized:
            return self
        features = _as_dataset(x, labeled=False).features
        probe = to_device(tree_map(lambda a: np.asarray(a)[:1], features),
                          self.device)
        module = self.module
        with torch.no_grad():
            module(*_call_args(probe), train=False)
        reset_parameters(module, self.seed)
        n = sum(p.numel() for p in module.parameters())
        logger.info("model built: %d parameters", n)
        self.estimator = Estimator(module, device=self.device,
                                   seed=self.seed, **(self._compiled or {}))
        if self._pending_load is not None:
            path, self._pending_load = self._pending_load, None
            self.estimator.load(path)
        return self

    def compile(self, optimizer="adam", loss=None, metrics=()):
        """(ref: Topology.scala compile). Recompiling preserves trained
        weights (Keras contract)."""
        self._compiled = dict(optimizer=optimizer, loss=loss,
                              metrics=metrics)
        if self.materialized:
            self.estimator = recompiled(self.estimator, self.module,
                                        device=self.device, seed=self.seed,
                                        **self._compiled)
        return self

    def set_checkpoint(self, path: str, over_write: bool = True,
                       trigger=None):
        """(ref: Topology.scala:249 setCheckpoint)."""
        self._checkpoint_dir = path
        self._checkpoint_trigger = trigger
        return self

    def set_tensorboard(self, log_dir: str, app_name: str = "zoo"):
        """(ref: Topology.scala:208 setTensorBoard)."""
        raise NotImplementedError(f"set_tensorboard {_SUMMARY}")

    def get_train_summary(self, tag: str = "train/loss"):
        """(ref: Topology.scala:1390 getTrainSummary)."""
        raise NotImplementedError(f"get_train_summary {_SUMMARY}")

    def get_validation_summary(self, metric: str = "loss"):
        return self.get_train_summary(tag=f"validation/{metric}")

    def _require_compiled(self):
        if self._compiled is None:
            raise RuntimeError("call compile(optimizer, loss) before "
                               "fit/evaluate")

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, **kwargs):
        """(ref: Topology.scala fit; keras fit signature)."""
        self._require_compiled()
        data = _as_dataset((x, y) if y is not None else x)
        self.materialize(data)
        return self.estimator.fit(
            data, batch_size=batch_size, epochs=nb_epoch,
            validation_data=validation_data,
            checkpoint_dir=self._checkpoint_dir,
            checkpoint_trigger=self._checkpoint_trigger, **kwargs)

    def evaluate(self, x, y=None, batch_size: int = 32):
        self._require_compiled()
        data = _as_dataset((x, y) if y is not None else x)
        self.materialize(data)
        return self.estimator.evaluate(data, batch_size=batch_size)

    def predict(self, x, batch_size: int = 32):
        data = _as_dataset(x, labeled=False)
        self.materialize(data)
        return self.estimator.predict(data, batch_size=batch_size)

    def save_weights(self, path: str):
        self._require_compiled()
        if not self.materialized:
            raise ValueError("nothing to save: model not built")
        self.estimator.save(path)

    def load_weights(self, path: str):
        """Weights, optimizer state and counters from a checkpoint that
        either package wrote; before the model is materialized, at its
        materialization."""
        self._require_compiled()
        if self.materialized:
            self.estimator.load(path)
        else:
            self._pending_load = path


class Sequential(KerasNet):
    """(ref: Topology.scala:631+ Sequential, keras Sequential)."""

    def __init__(self, layers: Optional[Sequence] = None, device=None,
                 seed: int = 0):
        super().__init__(device=device, seed=seed)
        self.layers: List = []
        for l in layers or []:
            self.add(l)

    def add(self, layer) -> "Sequential":
        if self._module is not None:
            raise RuntimeError("cannot add layers after the model is built")
        self.layers.append(layer)
        return self

    def _build_module(self) -> nn.Module:
        if not self.layers:
            raise ValueError("empty Sequential")
        return _SequentialModule(_build_once(self.layers))

    def summary(self) -> str:
        lines = ["Sequential {"]
        for l in self.layers:
            lines.append(f"  {l!r}")
        lines.append("}")
        return "\n".join(lines)


class Model(KerasNet):
    """Functional graph model (ref: Topology.scala Model; keras Model)."""

    def __init__(self, input: Union[KTensor, Sequence[KTensor]],
                 output: KTensor, device=None, seed: int = 0):
        super().__init__(device=device, seed=seed)
        self.inputs: List[KTensor] = (list(input)
                                      if isinstance(input, (list, tuple))
                                      else [input])
        self.output = output
        for i, t in enumerate(self.inputs):
            if t.input_index is None:
                raise ValueError(f"input {i} is not an Input() tensor")

    def _build_module(self) -> nn.Module:
        # topo-sort nodes reachable from output
        order: List[Node] = []
        seen: Dict[int, int] = {}  # node id -> slot
        input_slot = {t.input_index: i for i, t in enumerate(self.inputs)}

        def slot_of(t: KTensor) -> int:
            if t.node is None:
                if t.input_index not in input_slot:
                    raise ValueError("graph references an Input that is "
                                     "not among the model inputs")
                return input_slot[t.input_index]
            if t.node.id not in seen:
                visit(t.node)
            return seen[t.node.id]

        def visit(node: Node):
            slots = tuple(slot_of(i) for i in node.inputs)
            node._slots = slots
            seen[node.id] = len(self.inputs) + len(order)
            order.append(node)

        out_slot = slot_of(self.output)
        assert out_slot == len(self.inputs) + len(order) - 1, \
            "output must be the last computed node"
        return _GraphModule(_build_once([n.layer for n in order]),
                            [n._slots for n in order], len(self.inputs))

    def summary(self) -> str:
        return f"Model(inputs={len(self.inputs)})"

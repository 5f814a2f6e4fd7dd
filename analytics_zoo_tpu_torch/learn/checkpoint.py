"""Checkpoint save/restore, in the reference's format.

The counterpart of ``analytics_zoo_tpu/learn/checkpoint.py``, with the
same directory layout, meta and bytes, so a checkpoint written by either
package resumes in the other: ``<dir>/model.<step>`` holds the model
variables (``{"params": {...}}``, flax's names and axes:
``bridge.variables_from_module``) and ``<dir>/optim.<step>`` the
optimizer state, both flax msgpack (``utils/flax_msgpack.py``: the
bytes ``flax.serialization.to_bytes`` writes); ``<dir>/meta.<step>.json``
(``{"step", "epoch", ...}``) and ``<dir>/latest`` naming the newest step.
Each file is written atomically (temp file, fsync, rename). Local paths
only; single process.

The optimizer state is written in the layout flax gives the optax
chain's state (``opt_state_to_flax``): a chain becomes a map keyed
``"0"``, ``"1"``, ..., a transformation's state a map of its fields
(``count``, ``mu``, ``nu``, ...), a per-parameter tree the params'
nesting and axes (a kernel's input axis first), a step count an int32
scalar. ``learn/optim.py`` builds its
chains as optax does, so the two states map one for one.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.bridge import (flatten, from_flax_layout,
                                            nest, to_flax_layout)
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.utils import flax_msgpack

logger = get_logger(__name__)


def _is_param_dict(node: Any) -> bool:
    """A per-parameter tree of the optimizer state (``mu``, ``nu``,
    ``trace``, ...): a dict of tensors keyed by flax-style paths."""
    return (isinstance(node, dict) and bool(node)
            and all(isinstance(v, torch.Tensor) for v in node.values()))


def opt_state_to_flax(state: Any,
                      layouts: Optional[Dict[str, str]] = None) -> Any:
    """The port's optimizer state as flax's state dict of the optax
    chain's state (see the module docstring); ``layouts`` is the
    model's ``bridge.kernel_layouts``."""
    if isinstance(state, (list, tuple)):
        return {str(i): opt_state_to_flax(s, layouts)
                for i, s in enumerate(state)}
    if _is_param_dict(state):
        return nest({k: to_flax_layout(k, v.detach().cpu().numpy(), layouts)
                     for k, v in state.items()})
    if isinstance(state, dict):
        return {k: opt_state_to_flax(v, layouts) for k, v in state.items()}
    if isinstance(state, int) and not isinstance(state, bool):
        return np.asarray(state, np.int32)
    return state


def opt_state_from_flax(template: Any, tree: Any, path: str = "",
                        layouts: Optional[Dict[str, str]] = None) -> Any:
    """``tree`` (flax's state dict of an optax state) as the port's
    optimizer state shaped like ``template`` (this optimizer's
    ``init``), on the template's devices (``layouts``: the model's
    ``bridge.kernel_layouts``). A parameter the checkpoint
    lacks keeps its template entry: the JAX package creates a BERT
    ``segment_embed`` only when its first batch has ``token_type_ids``.
    Any other difference raises ``ValueError``."""
    def mismatch(what):
        return ValueError(
            f"optimizer state in the checkpoint does not match this "
            f"Estimator's optimizer (type and clip_norm/clip_value must "
            f"match the run that saved it): {what} at {path or '/'}")

    if isinstance(template, (list, tuple)):
        if not isinstance(tree, dict) or set(tree) != {
                str(i) for i in range(len(template))}:
            raise mismatch(f"a chain of {len(template)}")
        return [opt_state_from_flax(t, tree[str(i)], f"{path}/{i}",
                                    layouts)
                for i, t in enumerate(template)]
    if _is_param_dict(template):
        flat = flatten(tree) if isinstance(tree, dict) else {}
        out = {}
        for key, t in template.items():
            if key not in flat:
                out[key] = t
                continue
            arr = torch.from_numpy(from_flax_layout(
                key, np.array(flat[key]), layouts))
            if tuple(arr.shape) != tuple(t.shape):
                raise mismatch(f"{key} of shape {tuple(arr.shape)}, not "
                               f"{tuple(t.shape)}")
            out[key] = arr.to(device=t.device, dtype=t.dtype)
        return out
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(template) - set(tree):
            raise mismatch(f"fields {sorted(template)}")
        return {k: opt_state_from_flax(v, tree[k], f"{path}/{k}", layouts)
                for k, v in template.items()}
    if isinstance(template, int) and not isinstance(template, bool):
        return int(np.asarray(tree))
    return tree


def save_checkpoint(ckpt_dir: str, variables: Dict[str, Any],
                    opt_state: Any, step: int, epoch: int,
                    layouts: Optional[Dict[str, str]] = None) -> str:
    """Write a snapshot of ``variables`` (a flax variables tree, e.g.
    ``bridge.variables_from_module(model)``) and the port's
    ``opt_state`` (``layouts``: the model's ``bridge.kernel_layouts``);
    returns the checkpoint path prefix."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _atomic_write(os.path.join(ckpt_dir, f"model.{step}"),
                  flax_msgpack.serialize(variables))
    _atomic_write(os.path.join(ckpt_dir, f"optim.{step}"),
                  flax_msgpack.serialize(opt_state_to_flax(opt_state,
                                                           layouts)))
    meta = {"step": int(step), "epoch": int(epoch)}
    _atomic_write(os.path.join(ckpt_dir, f"meta.{step}.json"),
                  json.dumps(meta).encode())
    _atomic_write(os.path.join(ckpt_dir, "latest"), str(step).encode())
    logger.info("checkpoint saved: %s step=%d", ckpt_dir, step)
    return os.path.join(ckpt_dir, f"model.{step}")


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return int(f.read().decode().strip())


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                    with_optim: bool = True) -> Tuple[Any, Any, Dict]:
    """Restore ``(variables, opt_tree, meta)`` as they are on disk: the
    flax variables tree and (unless ``with_optim`` is false, then None)
    the optimizer's state-dict tree, numpy leaves; the Estimator maps
    them onto its module (``bridge.load_flax_into``) and its optimizer's
    state (``opt_state_from_flax``)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")

    def read(name):
        with open(os.path.join(ckpt_dir, name), "rb") as f:
            return flax_msgpack.restore(f.read())

    variables = read(f"model.{step}")
    opt_tree = read(f"optim.{step}") if with_optim else None
    with open(os.path.join(ckpt_dir, f"meta.{step}.json"), "rb") as f:
        meta = json.loads(f.read().decode())
    logger.info("checkpoint restored: %s step=%d", ckpt_dir, step)
    return variables, opt_tree, meta


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        # fsync BEFORE the rename: without it a crash can leave the rename
        # durable but the data not, i.e. `latest` pointing at a truncated
        # checkpoint
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        # and the directory entry itself, so the rename survives too
        dir_fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError as e:
        logger.debug("directory fsync after %s skipped: %s", path, e)

"""Checkpoint save/restore.

The counterpart of ``analytics_zoo_tpu/learn/checkpoint.py``, with the
same directory layout and meta: ``<dir>/model.<step>`` and
``<dir>/optim.<step>`` (here ``torch.save`` blobs: the module's
``state_dict`` and the optimizer state), ``<dir>/meta.<step>.json``
(``{"step", "epoch", ...}``) and ``<dir>/latest`` naming the newest
step, each written atomically (temp file, fsync, rename). Reading the
reference's flax msgpack checkpoints is still to be ported (ROADMAP).
Local paths only; single process.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from analytics_zoo_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


def _to_bytes(obj: Any) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached onto the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def save_checkpoint(ckpt_dir: str, model_state: Dict[str, torch.Tensor],
                    opt_state: Any, step: int, epoch: int) -> str:
    """Write a snapshot; returns the checkpoint path prefix."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _atomic_write(os.path.join(ckpt_dir, f"model.{step}"),
                  _to_bytes(_host(model_state)))
    _atomic_write(os.path.join(ckpt_dir, f"optim.{step}"),
                  _to_bytes(_host(opt_state)))
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
                    map_location=None, with_optim: bool = True
                    ) -> Tuple[Dict[str, torch.Tensor], Any, Dict]:
    """Restore (model_state, opt_state, meta); ``opt_state`` is None
    unless ``with_optim``. Tensors land on ``map_location``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")

    def read(name):
        return torch.load(os.path.join(ckpt_dir, name),
                          map_location=map_location, weights_only=True)

    model_state = read(f"model.{step}")
    opt_state = read(f"optim.{step}") if with_optim else None
    with open(os.path.join(ckpt_dir, f"meta.{step}.json"), "rb") as f:
        meta = json.loads(f.read().decode())
    logger.info("checkpoint restored: %s step=%d", ckpt_dir, step)
    return model_state, opt_state, meta


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

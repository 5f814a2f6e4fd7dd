"""Weight bridge: the reference package's flax variables -> the port's
``state_dict``, and its TinyGenLM parameter tree -> the port's.

The trees are taken as nested dicts of numpy arrays (for instance
``jax.tree_util.tree_map(np.asarray, variables)``), so this module needs
no JAX. Module and parameter names correspond one for one (see
``keras/layers/transformer.py``); per leaf:

- Dense ``kernel`` ``[in, *out]`` -> ``weight`` ``[*out, in]`` (the input
  axis moves last: a transpose for ``[in, out]``, and the fused qkv
  ``[H_in, 3, H]`` becomes ``[3, H, H_in]``);
- LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
- ``bias`` and bare parameters (``position_embed``) as they are.

TinyGenLM's parameters are a plain tree in both packages (dicts and
lists with the same keys, weights as ``[in, out]`` matrices used as
``x @ w``), so ``gen_params_from_tree`` keeps the structure and turns
each leaf into an f32 tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device

_RENAME = {"scale": "weight", "embedding": "weight"}


def state_dict_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax variables tree (``{"params": {...}}`` or the params
    dict itself) onto the port's ``state_dict`` keys."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + [name])
                continue
            arr = np.asarray(child)
            if name == "kernel":
                arr = np.moveaxis(arr, 0, -1)
                name = "weight"
            else:
                name = _RENAME.get(name, name)
            out[".".join(path + [name])] = torch.tensor(
                arr, dtype=torch.float32)

    walk(tree, [])
    return out


def load_flax_into(module: torch.nn.Module,
                   tree: Mapping[str, Any]) -> torch.nn.Module:
    """Load a flax tree into ``module``. The one key the flax tree may
    lack is a BERT ``segment_embed`` (flax creates it only when the init
    batch had ``token_type_ids``); every other difference raises."""
    sd = state_dict_from_flax(tree)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("segment_embed.weight")]
    if missing or unexpected:
        raise KeyError(f"flax tree does not match the module: missing "
                       f"{missing}, unexpected {unexpected}")
    return module


def gen_params_from_tree(tree: Any, device=None) -> Any:
    """The reference's TinyGenLM parameter tree (nested dicts and lists
    of arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)``) as
    the port's: the same structure, each leaf an f32 tensor on
    ``device`` (None = CUDA)."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return torch.tensor(np.asarray(node, np.float32), device=device)

    return walk(tree)

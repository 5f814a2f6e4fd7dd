"""Weight bridge: the reference package's flax variables <-> the port's
modules, and its TinyGenLM parameter tree -> the port's.

The trees are taken as nested dicts of numpy arrays (for instance
``jax.tree_util.tree_map(np.asarray, variables)``), so this module needs
no JAX. Module and parameter names correspond one for one (see
``keras/layers/transformer.py``); per leaf:

- Dense ``kernel`` ``[in, *out]`` -> ``weight`` ``[*out, in]`` (the input
  axis moves last: a transpose for ``[in, out]``, and the fused qkv
  ``[H_in, 3, H]`` becomes ``[3, H, H_in]``);
- a 4-D ``kernel`` is a 2-D convolution's: flax ``[kh, kw, in, out]``
  -> torch ``[out, in, kh, kw]`` (no Dense of the port has a 4-D
  weight);
- these two rules go by the kernel's rank, for a module that declares
  nothing. A module whose kernel breaks them names its layout in
  ``flax_layout`` (``kernel_layouts`` collects them by path):
  ``"conv"``, a convolution of any rank (flax ``[*k, in, out]`` ->
  torch ``[out, in, *k]``: the Keras ``Convolution1D/3D``, the
  ``ConvLSTM`` cells' ``ih`` and ``hh``), or ``"flax"``, a kernel kept
  in flax's own axes (``LocallyConnected``'s ``[positions, patch,
  out]``);
- LayerNorm and BatchNorm ``scale`` -> ``weight``; Embed ``embedding``
  -> ``weight``;
- ``bias`` and bare parameters (``position_embed``) as they are;
- the ``batch_stats`` collection (a BatchNorm's running ``mean`` and
  ``var``) -> the BatchNorm's buffers of those names.

``variables_from_module`` goes the other way, for the checkpoints both
packages read (``learn/checkpoint.py``): each parameter under its
flax-style path from ``learn.optim.param_tree``, which names a leaf by
the module's type (a Dense, Linear or Conv ``weight`` is ``kernel``, a
LayerNorm's or BatchNorm's ``scale``, an Embed's ``embedding``), a
kernel in flax's axes, nested as ``{"params": {...}}``, plus
``"batch_stats"`` where the module has BatchNorms. The layout rules
(``to_flax_layout``, ``from_flax_layout``) also carry the optimizer's
per-parameter state.

TinyGenLM's parameters are a plain tree in both packages (dicts and
lists with the same keys, weights as ``[in, out]`` matrices used as
``x @ w``), so ``gen_params_from_tree`` keeps the structure and turns
each leaf into an f32 tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device

_RENAME = {"scale": "weight", "embedding": "weight"}
_COLLECTIONS = ("params", "batch_stats")


def state_dict_from_flax(tree: Mapping[str, Any],
                         layouts: Optional[Mapping[str, str]] = None
                         ) -> Dict[str, torch.Tensor]:
    """Map a flax variables tree (``{"params": {...}}``, with
    ``"batch_stats"`` beside it for a model with BatchNorm, or the
    params dict itself) onto the port's ``state_dict`` keys;
    ``layouts`` is the target module's ``kernel_layouts``."""
    if "params" in tree and set(tree) <= set(_COLLECTIONS):
        collections = [tree[c] for c in _COLLECTIONS if c in tree]
    else:
        collections = [tree]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + [name])
                continue
            arr = (child.float().numpy() if isinstance(child, torch.Tensor)
                   else np.asarray(child))
            if name == "kernel":
                arr = from_flax_layout("/".join(path + [name]), arr,
                                       layouts)
                name = "weight"
            else:
                name = _RENAME.get(name, name)
            out[".".join(path + [name])] = torch.tensor(
                arr, dtype=torch.float32)

    for node in collections:
        walk(node, [])
    return out


def _aliases(module: torch.nn.Module) -> Dict[str, str]:
    """{state_dict key: the first key naming the same tensor}, for the
    keys of a submodule registered under two names (a Keras layer
    called twice in one graph: flax keeps its parameters under the
    first name alone)."""
    first: Dict[int, str] = {}
    out: Dict[str, str] = {}
    for key, t in module.state_dict(keep_vars=True).items():
        out_key = first.setdefault(id(t), key)
        if out_key != key:
            out[key] = out_key
    return out


def load_flax_into(module: torch.nn.Module,
                   tree: Mapping[str, Any]) -> torch.nn.Module:
    """Load a flax tree into ``module``. The keys the flax tree may lack
    are a BERT ``segment_embed`` (flax creates it only when the init
    batch had ``token_type_ids``) and the second names of a shared
    submodule's tensors, loaded under their first; every other
    difference raises."""
    sd = state_dict_from_flax(tree, kernel_layouts(module))
    missing, unexpected = module.load_state_dict(sd, strict=False)
    aliases = _aliases(module)
    missing = [k for k in missing if not k.endswith("segment_embed.weight")
               and aliases.get(k) not in sd]
    if missing or unexpected:
        raise KeyError(f"flax tree does not match the module: missing "
                       f"{missing}, unexpected {unexpected}")
    return module


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` as ``{"a": {"b": {"c": leaf}}}``, keys sorted
    at every level (the order ``jax.tree_util`` gives a dict)."""
    out: Dict[str, Any] = {}
    for path in sorted(flat):
        *parents, leaf = path.split("/")
        node = out
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = flat[path]
    return out


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The inverse of ``nest``: every non-dict leaf under its path."""
    out: Dict[str, Any] = {}
    for name, child in tree.items():
        path = f"{prefix}{name}"
        if isinstance(child, Mapping):
            out.update(flatten(child, path + "/"))
        else:
            out[path] = child
    return out


def _is_kernel(path: str) -> bool:
    return path == "kernel" or path.endswith("/kernel")


def kernel_layouts(module: torch.nn.Module) -> Dict[str, str]:
    """{flax-style path of a kernel: its layout} for the submodules of
    ``module`` that declare ``flax_layout`` (see the module docstring);
    every other kernel goes by its rank."""
    from analytics_zoo_tpu_torch.learn.optim import flax_path

    return {flax_path(name, "kernel"): m.flax_layout
            for name, m in module.named_modules()
            if getattr(m, "flax_layout", None)}


def _layout(path: str, arr: np.ndarray,
            layouts: Optional[Mapping[str, str]]) -> Optional[str]:
    if not _is_kernel(path):
        return "flax"
    layout = (layouts or {}).get(path)
    if layout is not None:
        return layout
    return "conv" if arr.ndim == 4 else None


def to_flax_layout(path: str, arr: np.ndarray,
                   layouts: Optional[Mapping[str, str]] = None
                   ) -> np.ndarray:
    """A parameter-shaped array at flax-style ``path`` in flax's axes: a
    Dense kernel's input axis moved back to the front, a convolution's
    ``[out, in, *k]`` as ``[*k, in, out]``. ``layouts``: the module's
    ``kernel_layouts``."""
    layout = _layout(path, arr, layouts)
    if layout == "flax":
        return arr
    if layout == "conv":
        n = arr.ndim
        return np.ascontiguousarray(
            np.transpose(arr, tuple(range(2, n)) + (1, 0)))
    return np.ascontiguousarray(np.moveaxis(arr, -1, 0))


def from_flax_layout(path: str, arr: np.ndarray,
                     layouts: Optional[Mapping[str, str]] = None
                     ) -> np.ndarray:
    """The inverse of ``to_flax_layout``: the port's axes."""
    layout = _layout(path, arr, layouts)
    if layout == "flax":
        return arr
    if layout == "conv":
        n = arr.ndim
        return np.ascontiguousarray(
            np.transpose(arr, (n - 1, n - 2) + tuple(range(n - 2))))
    return np.ascontiguousarray(np.moveaxis(arr, 0, -1))


def variables_from_module(module: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of ``state_dict_from_flax``: ``module``'s parameters
    as a flax variables tree ``{"params": {...}}`` of f32 numpy arrays,
    with ``"batch_stats"`` (every BatchNorm's running ``mean`` and
    ``var``) where the module has any, which ``load_flax_into`` (and
    the JAX package) read back."""
    from analytics_zoo_tpu_torch.learn.optim import (batch_stats_tree,
                                                     param_tree)

    def host(t):
        return t.detach().float().cpu().numpy()

    layouts = kernel_layouts(module)
    out = {"params": nest({path: to_flax_layout(path, host(p), layouts)
                           for path, p in param_tree(module).items()})}
    stats = batch_stats_tree(module)
    if stats:
        out["batch_stats"] = nest({path: host(b)
                                   for path, b in stats.items()})
    return out


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

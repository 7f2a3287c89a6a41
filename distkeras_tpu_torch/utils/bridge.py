"""Weights carried across from the reference (JAX) package and back.

- :func:`params_from_jax` turns the reference's variable tree (nested dicts
  of arrays, ``{"params": ..., "batch_stats": ...}`` or the params subtree
  itself) into a flat ``state_dict`` for the port's modules, and
  :func:`params_to_jax` goes back. Module paths keep their names
  (``layer_0/attention/query`` -> ``layer_0.attention.query``); a flax
  ``Dense`` ``kernel`` ``[in, out]`` becomes a ``Linear`` ``weight``
  ``[out, in]``, a flax ``Conv`` ``kernel`` ``[kh, kw, in, out]`` a
  ``Conv2d`` ``weight`` ``[out, in, kh, kw]``, a LayerNorm or BatchNorm
  ``scale`` and an ``Embed`` ``embedding`` become ``weight``; every other
  leaf (``bias``, ``pos_embed`` ``[1, L, H]``, ``mlm_bias``) keeps its name
  and shape. The ``batch_stats`` collection (BatchNorm's ``mean`` and
  ``var``) maps to the module's buffers of the same names. A list node
  (a Keras model's ``{"params": {"w": [...]}, "keras_state": [...]}``,
  :meth:`~distkeras_tpu_torch.models.core.Model.from_keras`) maps to names
  ``w.<i>`` and ``keras_state.<i>`` and back to lists.
- :func:`cache_from_jax` and :func:`cache_to_jax` carry a decode cache
  (the reference's ``"cache"`` collection: ``layer_{i}/attention/
  cached_key`` and so on) into the port's flat layout
  (``layer_{i}.attention.cached_key``, see :mod:`distkeras_tpu_torch.models.bert`)
  and back, leaf for leaf and in each leaf's dtype.
- :func:`load_weights_file` reads either package's weight files
  (:mod:`distkeras_tpu_torch.checkpoint`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.checkpoint import load_weights_file
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["params_from_jax", "params_to_jax", "as_state_dict", "cache_from_jax",
           "cache_to_jax", "load_weights_file"]

_RENAMED = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _flatten(tree, prefix=()):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        path = (*prefix, str(key))
        if isinstance(value, (dict, list, tuple)):
            yield from _flatten(value, path)
        else:
            yield path, value


def _listify(node):
    """Nodes whose keys are ``0 .. n-1`` back to lists (a Keras model's
    ``{"w": [...]}`` and ``keras_state``)."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes array from the JAX side
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_jax(tree: dict, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Reference variables -> the port's ``state_dict`` on ``device`` (CUDA
    unless ``"cpu"`` is asked for), every leaf in its own dtype."""
    dev = resolve_device(device)
    out = {}
    for path, leaf in _flatten(tree.get("params", tree)):
        t = _as_tensor(leaf)
        if path[-1] == "kernel":
            t = (t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()).contiguous()
        name = ".".join((*path[:-1], _RENAMED.get(path[-1], path[-1])))
        out[name] = t.to(dev)
    if "params" in tree:
        for path, leaf in _flatten(tree.get("batch_stats", {})):
            out[".".join(path)] = _as_tensor(leaf).to(dev)
        for path, leaf in _flatten(tree.get("keras_state", []), ("keras_state",)):
            out[".".join(path)] = _as_tensor(leaf).to(dev)
    return out


def as_state_dict(variables, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Weights of either layout as the port's flat ``state_dict``: a flat
    dict of tensors passes through (moved to ``device`` when one is given);
    a reference-layout tree (``{"params": ...}`` as a weight file holds it,
    or the params tree itself) goes through :func:`params_from_jax`, onto
    ``device`` or the host."""
    if isinstance(variables, dict) and variables and all(
            isinstance(v, torch.Tensor) for v in variables.values()):
        if device is None:
            return dict(variables)
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in variables.items()}
    return params_from_jax(variables, device="cpu" if device is None else device)


def params_to_jax(state_dict: dict[str, torch.Tensor], module: nn.Module) -> dict:
    """The port's ``state_dict`` -> reference variables ``{"params": ...}``
    (plus ``"batch_stats"`` for the module's buffers), each leaf in its own
    dtype: a numpy array, or a CPU tensor for bfloat16, which numpy holds
    only through ``ml_dtypes`` (:func:`~distkeras_tpu_torch.utils.pytree.serialize_pytree`
    writes it as the reference does). ``module`` says which ``weight`` was
    a dense or conv kernel, a norm's scale or an embedding."""
    buffers = {name for name, _ in module.named_buffers()}
    out: dict = {}
    for name, t in state_dict.items():
        *parents, leaf = name.split(".")
        owner = module.get_submodule(".".join(parents)) if parents else module
        arr = t.detach().cpu()
        if leaf == "weight":
            if isinstance(owner, nn.Linear):
                leaf, arr = "kernel", arr.t()
            elif isinstance(owner, nn.Conv2d):
                leaf, arr = "kernel", arr.permute(2, 3, 1, 0)
            elif isinstance(owner, nn.Embedding):
                leaf = "embedding"
            elif arr.ndim == 1:  # LayerNorm, BatchNorm
                leaf = "scale"
        arr = arr.contiguous()
        arr = arr if arr.dtype == torch.bfloat16 else arr.numpy()
        collection = "batch_stats" if name in buffers else "params"
        if name in buffers and parents[:1] == ["keras_state"]:
            collection, parents = "keras_state", parents[1:]
        node = out.setdefault(collection, {})
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return {k: _listify(v) for k, v in out.items()}


def cache_from_jax(tree: dict, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """A reference decode cache (the ``"cache"`` collection, or a tree
    holding it under ``"cache"``) -> the port's flat cache on ``device``."""
    dev = resolve_device(device)
    return {".".join(path): _as_tensor(leaf).to(dev)
            for path, leaf in _flatten(tree.get("cache", tree))}


def cache_to_jax(cache: dict[str, torch.Tensor]) -> dict:
    """The port's flat cache -> the reference's nested ``"cache"``
    collection: numpy arrays, and CPU tensors for bfloat16 leaves."""
    out: dict = {}
    for name, t in cache.items():
        *parents, leaf = name.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        arr = t.detach().cpu().contiguous()
        node[leaf] = arr if arr.dtype == torch.bfloat16 else arr.numpy()
    return out

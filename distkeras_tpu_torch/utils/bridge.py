"""Weights carried across from the reference (JAX) package.

- :func:`params_from_jax` turns the reference's variable tree (nested dicts
  of numpy arrays, ``{"params": ...}`` or the params subtree itself) into a
  flat ``state_dict`` for the port's modules, and :func:`params_to_jax`
  goes back. Module paths keep their names (``layer_0/attention/query`` ->
  ``layer_0.attention.query``); a flax ``Dense`` ``kernel`` ``[in, out]``
  becomes a ``Linear`` ``weight`` ``[out, in]``, a flax ``Conv`` ``kernel``
  ``[kh, kw, in, out]`` a ``Conv2d`` ``weight`` ``[out, in, kh, kw]``, a
  LayerNorm ``scale`` and an ``Embed`` ``embedding`` become ``weight``;
  every other leaf (``bias``, ``pos_embed`` ``[1, L, H]``, ``mlm_bias``)
  keeps its name and shape.
- :func:`load_weights_file` reads the reference's weight files
  (``checkpoint.save_weights_file``: the ``serialize_pytree`` npz of
  ``leaf_i`` arrays plus a ``__treedef__`` JSON of tagged key paths and
  dtypes, bf16 stored as a ``uint16`` view, plus a provenance stamp member
  it ignores) with numpy alone.
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["params_from_jax", "params_to_jax", "load_weights_file"]

_RENAMED = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes array from the JAX side
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_jax(tree: dict, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Reference variables -> the port's ``state_dict`` on ``device`` (CUDA
    unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    params = tree.get("params", tree)
    out = {}
    for path, leaf in _flatten(params):
        t = _as_tensor(leaf)
        if path[-1] == "kernel":
            t = (t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()).contiguous()
        name = ".".join((*path[:-1], _RENAMED.get(path[-1], path[-1])))
        out[name] = t.to(dev)
    return out


def params_to_jax(state_dict: dict[str, torch.Tensor], module: nn.Module) -> dict:
    """The port's ``state_dict`` -> reference variables ``{"params": ...}``
    of numpy arrays (bfloat16 leaves widen to float32, exactly). ``module``
    says which ``weight`` was a dense or conv kernel, a scale or an
    embedding."""
    root: dict = {}
    for name, t in state_dict.items():
        *parents, leaf = name.split(".")
        owner = module.get_submodule(".".join(parents)) if parents else module
        arr = t.detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        arr = arr.numpy()
        if leaf == "weight":
            if isinstance(owner, nn.Linear):
                leaf, arr = "kernel", arr.T.copy()
            elif isinstance(owner, nn.Conv2d):
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0).copy()
            elif isinstance(owner, nn.LayerNorm):
                leaf = "scale"
            elif isinstance(owner, nn.Embedding):
                leaf = "embedding"
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return {"params": root}


def load_weights_file(path: str) -> dict:
    """Read a reference weight file into nested dicts (lists for sequence
    nodes) of CPU tensors, bfloat16 leaves rebuilt from their ``uint16``
    view."""
    with np.load(path) as npz:
        n = sum(1 for k in npz.files if k.startswith("leaf_"))
        leaves = [npz[f"leaf_{i}"] for i in range(n)]
        meta = json.loads(bytes(npz["__treedef__"]).decode("utf-8"))
    if isinstance(meta, dict):
        paths, dtypes = meta["paths"], meta["dtypes"]
    else:  # legacy format: paths only
        paths, dtypes = meta, [leaf.dtype.name for leaf in leaves]
    tensors = []
    for leaf, dt in zip(leaves, dtypes):
        if dt == "bfloat16":
            tensors.append(torch.from_numpy(leaf.view(np.int16)).view(torch.bfloat16))
        elif dt == leaf.dtype.name:
            tensors.append(torch.from_numpy(leaf))
        else:
            raise ValueError(f"unsupported weight dtype {dt!r} in {path}")
    if len(tensors) == 1 and paths and paths[0] == "":
        return tensors[0]
    root: dict = {}
    for path_str, t in zip(paths, tensors):
        keys = path_str.split("/") if path_str else []
        node = root
        for j, ks in enumerate(keys):
            tag, name = ks[0], ks[2:]
            if j == len(keys) - 1:
                node[(tag, name)] = t
            else:
                node = node.setdefault((tag, name), {})

    def _fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(t == "s" for t, _ in node):
            return [_fix(node[("s", str(i))]) for i in range(len(node))]
        return {name: _fix(v) for (_, name), v in node.items()}

    return _fix(root)


"""Host tree arithmetic and the pickle-free tree serializer.

Counterpart of ``distkeras_tpu/utils/pytree.py``. :func:`serialize_pytree`
and :func:`deserialize_pytree` write and read the reference's byte layout
(an npz of ``leaf_i`` arrays and a ``__treedef__`` JSON of tagged key paths
and dtype names), so a file written by either package loads in the other.
The arithmetic below is the building blocks of every PS protocol's update
(reference ``:34-110``). A tree there is the
port's flat ``dict[str, Tensor]`` (a ``state_dict``). Host trees are CPU
tensors, not numpy arrays: bfloat16 wire trees have to live on the host, and
numpy holds bfloat16 only through ``ml_dtypes``, which the port does not use.
Every function keeps the leaves' dtypes (bf16 + f32 widens to f32, as numpy
with ``ml_dtypes`` does) and builds new tensors: nothing is changed in place,
so a tree handed to the parameter server can never alias a worker's weights
that an optimizer is stepping.
"""

from __future__ import annotations

import io
import json
import math
import zipfile
from typing import Any

import numpy as np
import torch

__all__ = ["to_host", "add", "sub", "scale", "l2", "mean", "serialize_pytree",
           "deserialize_pytree"]

Tree = dict[str, torch.Tensor]


def to_host(tree: Tree) -> Tree:
    """The tree as CPU tensors of the same dtypes: CPU leaves as they are
    (detached), CUDA leaves copied into pinned host memory on the current
    stream, which is then waited for. The one host-materialisation helper:
    the PS loop and the protocols must agree on it bit for bit."""
    out, copied = {}, False
    for k, v in tree.items():
        v = v.detach()
        if v.device.type == "cpu":
            out[k] = v
        else:
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            out[k] = host.copy_(v, non_blocking=True)
            copied = True
    if copied:
        torch.cuda.current_stream().synchronize()
    return out


def add(a: Tree, b: Tree) -> Tree:
    """``a + b`` leaf-wise."""
    return {k: torch.add(a[k], b[k]) for k in a}


def sub(a: Tree, b: Tree) -> Tree:
    """``a - b`` leaf-wise (weight deltas: ``w_after - w_before``)."""
    return {k: torch.sub(a[k], b[k]) for k in a}


def scale(a: Tree, s: float) -> Tree:
    """``s * a`` leaf-wise, in each leaf's dtype."""
    return {k: v * s for k, v in a.items()}


def l2(tree: Tree) -> float:
    """Whole-tree L2 norm ``sqrt(sum_leaves sum(x^2))`` as a host float,
    accumulated in float64 (bf16 wire trees widen exactly). The one norm the
    training-health layer uses for update mass, divergence and goodput."""
    total = 0.0
    for leaf in tree.values():
        if not isinstance(leaf, torch.Tensor):
            continue
        x = leaf.detach().to("cpu", torch.float64).reshape(-1)
        total += float(x @ x)
    return math.sqrt(total)


def mean(trees: list[Tree]) -> Tree:
    """Arithmetic mean of a list of trees (the reference's
    ``AveragingTrainer`` semantics)."""
    if not trees:
        raise ValueError("mean of an empty list of trees")
    acc = trees[0]
    for t in trees[1:]:
        acc = add(acc, t)
    return scale(acc, 1.0 / len(trees))


# ---------------------------------------------------------------------------
# Serialization: a tree of arrays -> bytes without pickle (reference
# ``utils/pytree.py:104-210``). A tree is nested dicts (flattened in sorted
# key order, as ``jax.tree.flatten`` does), lists and tuples of leaves;
# ``None`` is an empty node. A leaf is a tensor on any device, a numpy array
# or a number.
# ---------------------------------------------------------------------------


def _flatten_with_paths(tree: Any, prefix: tuple = ()):
    """``(path, leaf)`` pairs in ``jax.tree.flatten``'s order; a path is a
    tuple of the reference's tagged keys (``"d:name"``, ``"s:index"``)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten_with_paths(tree[key], (*prefix, f"d:{key}"))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten_with_paths(value, (*prefix, f"s:{i}"))
    elif tree is not None:
        yield prefix, tree


def _unflatten_like(like: Any, leaves) -> Any:
    """``leaves`` (an iterator) poured into the structure of ``like``."""
    if isinstance(like, dict):
        out = {key: _unflatten_like(like[key], leaves) for key in sorted(like)}
        return {key: out[key] for key in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array numpy can store, and its true dtype's name:
    bfloat16 travels as its ``uint16`` bits, as in the reference."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V":
        raise TypeError(f"unsupported leaf dtype {arr.dtype}: pass bfloat16 as a torch tensor")
    return arr, arr.dtype.name


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if dtype != arr.dtype.name:
        raise ValueError(f"unsupported leaf dtype {dtype!r} (stored as {arr.dtype.name})")
    return torch.from_numpy(np.array(arr))


_ZIP_EPOCH = (1980, 1, 1, 0, 0, 0)


def serialize_pytree(tree: Any) -> bytes:
    """Serialize a tree of arrays to the reference's npz layout (no pickle):
    ``leaf_i`` members in flatten order and a ``__treedef__`` member of
    ``{"paths": [...], "dtypes": [...]}``, each member's bytes those the
    reference writes for the same tree."""
    arrays, paths, dtypes = {}, [], []
    for i, (path, leaf) in enumerate(_flatten_with_paths(tree)):
        arr, dtype = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        paths.append("/".join(path))
        dtypes.append(dtype)
    meta = json.dumps({"paths": paths, "dtypes": dtypes})
    arrays["__treedef__"] = np.frombuffer(meta.encode("utf-8"), dtype=np.uint8)
    # np.savez's members, with a fixed timestamp in place of the clock's,
    # so the same tree always gives the same bytes (and digest).
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_STORED) as z:
        for name, arr in arrays.items():
            info = zipfile.ZipInfo(f"{name}.npy", date_time=_ZIP_EPOCH)
            info.external_attr = 0o600 << 16
            with z.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)
    return buf.getvalue()


def deserialize_pytree(data: bytes, like: Any | None = None) -> Any:
    """Inverse of :func:`serialize_pytree`, for either package's bytes: CPU
    tensors of the recorded dtypes (bfloat16 rebuilt from its bits). With
    ``like`` the leaves fill that structure; without, nested dicts (lists
    for sequence nodes) are rebuilt from the tagged key paths."""
    with np.load(io.BytesIO(data)) as npz:
        n = sum(1 for k in npz.files if k.startswith("leaf_"))
        arrays = [npz[f"leaf_{i}"] for i in range(n)]
        meta = json.loads(bytes(npz["__treedef__"]).decode("utf-8"))
    if isinstance(meta, dict):
        paths, dtypes = meta["paths"], meta["dtypes"]
    else:  # legacy format: paths only
        paths, dtypes = meta, [a.dtype.name for a in arrays]
    leaves = [_from_numpy(a, dt) for a, dt in zip(arrays, dtypes)]
    if like is not None:
        n_like = sum(1 for _ in _flatten_with_paths(like))
        if n_like != len(leaves):
            raise ValueError(f"like has {n_like} leaves, the data {len(leaves)}")
        return _unflatten_like(like, iter(leaves))
    if len(leaves) == 1 and paths and paths[0] == "":
        return leaves[0]  # the tree was a bare leaf
    # The tag travels with the key, so a dict whose keys happen to be
    # digits is never mistaken for a list.
    root: dict = {}
    for path_str, leaf in zip(paths, leaves):
        keys = path_str.split("/") if path_str else []
        node = root
        for j, ks in enumerate(keys):
            tag, name = ks[0], ks[2:]
            if j == len(keys) - 1:
                node[(tag, name)] = leaf
            else:
                node = node.setdefault((tag, name), {})

    def _fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(t == "s" for t, _ in node):
            return [_fix(node[("s", str(i))]) for i in range(len(node))]
        return {name: _fix(v) for (_, name), v in node.items()}

    return _fix(root)

"""Logical-axis to mesh-axis sharding rules: counterpart of
``distkeras_tpu/parallel/sharding.py``.

A tensor annotated with logical axes (``("batch", "seq", "embed")``)
resolves against these rules to a partition spec over the mesh's axes, and
that spec to DTensor placements (:attr:`NamedSharding.placements`) or to
the part each rank holds (:meth:`NamedSharding.index`). The reference's
models carry their logical axes in flax boxes; the port's carry a table,
name -> axes (``model.param_axes``, :data:`distkeras_tpu_torch.models.bert.PARAM_AXES`),
which :func:`infer_variable_shardings` resolves for model parallelism
(:mod:`distkeras_tpu_torch.parallel.gspmd`).
"""

from __future__ import annotations

from collections.abc import Sequence

from distkeras_tpu_torch.parallel.mesh import Mesh, NamedSharding

__all__ = [
    "DEFAULT_RULES",
    "kv_pytree_shardings",
    "logical_axis_rules",
    "logical_sharding",
    "infer_variable_shardings",
    "replicated",
]

# logical axis -> mesh axis (None = replicate)
DEFAULT_RULES: tuple[tuple[str, str | None], ...] = (
    ("batch", "dp"),
    ("seq", "sp"),
    ("embed", None),     # keep the residual stream replicated
    ("heads", "tp"),
    ("mlp", "tp"),
    ("kv", None),
    ("vocab", "tp"),
    ("expert", "ep"),
)


def logical_axis_rules(mesh: Mesh, overrides=None):
    """Filter DEFAULT_RULES down to axes the mesh actually has."""
    rules = []
    seen = set()
    for logical, phys in tuple(overrides or ()) + DEFAULT_RULES:
        if logical in seen:
            continue
        seen.add(logical)
        rules.append((logical, phys if phys in mesh.axis_names else None))
    return tuple(rules)


def logical_sharding(mesh: Mesh, logical_axes: Sequence[str | None],
                     overrides=None) -> NamedSharding:
    """The sharding of a tensor whose dimensions carry ``logical_axes``
    (None for an unnamed one), resolved as flax's ``logical_to_mesh_axes``
    resolves them: the rules of :func:`logical_axis_rules` in order of
    precedence, each giving its dimension its mesh axis unless an earlier
    rule took that axis; a dimension no rule assigns is replicated."""
    names = list(logical_axes)
    dups = tuple(dict.fromkeys(n for n in names if isinstance(n, str) and names.count(n) > 1))
    if dups:
        raise ValueError(f"Unsupported: Dimensions {dups} occur more than once in array names.")
    spec: list = [None] * len(names)
    for logical, phys in logical_axis_rules(mesh, overrides):
        if logical in names and phys is not None and phys not in spec:
            spec[names.index(logical)] = phys
    return NamedSharding(mesh, tuple(spec))


# The config field behind each logical axis, for a refusal's message.
_AXIS_FIELDS = {"vocab": "vocab_size", "heads": "hidden_size", "mlp": "mlp_dim",
                "embed": "hidden_size", "seq": "max_seq_len"}


def infer_variable_shardings(mesh: Mesh, abstract_variables, param_axes, overrides=None):
    """Each variable's sharding: ``abstract_variables`` maps names to
    anything with a ``shape``, ``param_axes(name)`` gives a name's logical
    axes or None (a model's ``param_axes``; None for a model without
    annotations). A leaf without axes is replicated, as the reference's
    un-annotated leaves are. A split dimension that does not divide over
    its mesh axis raises ``ValueError`` naming the leaf and its size (JAX
    refuses such a placement)."""
    out = {}
    for name, leaf in abstract_variables.items():
        axes = param_axes(name) if param_axes is not None else None
        if axes is None:
            out[name] = replicated(mesh)
            continue
        sharding = logical_sharding(mesh, axes, overrides)
        shape = tuple(leaf.shape)
        for dim, entry in enumerate(sharding.spec):
            n = mesh.shape[entry] if entry is not None else 1
            if shape[dim] % n:
                field = _AXIS_FIELDS.get(axes[dim], axes[dim])
                raise ValueError(
                    f"{name}: its {axes[dim]!r} dimension {dim} has size {shape[dim]} "
                    f"({field}), which does not divide over the mesh's {entry}={n}")
        out[name] = sharding
    return out


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def kv_pytree_shardings(mesh: Mesh, tree, axis: str = "tp"):
    """Shardings for a decode KV cache/pool tree: every K/V leaf (the
    ``ndim >= 3`` tensors: dense caches ``[B, L, H, D]``, prefill rows and
    paged pools ``[C, block_tokens, H, D]``, heads at axis ``-2``) is sharded
    over its heads, and only when the head count divides the mesh axis;
    everything else is replicated. ``tree`` is a dict/list/tuple tree of
    anything with a ``shape``."""
    n = mesh.shape.get(axis, 1)

    def rule(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if (axis in mesh.axis_names and n > 1 and len(shape) >= 3
                and shape[-2] % n == 0):
            spec = [None] * len(shape)
            spec[-2] = axis
            return NamedSharding(mesh, tuple(spec))
        return NamedSharding(mesh, ())

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return rule(node)

    return walk(tree)

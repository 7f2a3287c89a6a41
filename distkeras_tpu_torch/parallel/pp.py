"""Pipeline-stage planning for pp-sharded serving.

Counterpart of ``distkeras_tpu/parallel/pp.py``. A ``pp=M`` serving mesh
(:func:`~distkeras_tpu_torch.parallel.mesh.serving_mesh`) splits the model
into M contiguous layer *stages*, each owning its slice of the encoder
trunk plus the ends that anchor it: stage 0 owns the embedding
(``token_embed``, ``pos_embed`` and, dense decode, the ``pos_index``
counter), the last stage owns the final LayerNorm, the ``mlm_bias`` head
and a second copy of ``token_embed`` (the tied head reads the embedding
matrix).

The plan is pure bookkeeping over the port's flat parameter and cache
names (``layer_3.attention.query.weight``, ``pos_index``): the model is
always *initialized* whole, then :meth:`StagePlan.split_params` and
:meth:`StagePlan.split_tree` carve the flat dicts into per-stage dicts
whose keys are exactly what a stage-sliced forward
(:class:`~distkeras_tpu_torch.models.bert.Bert`, ``stage=(lo, hi, first,
last)``) reads.
"""

from __future__ import annotations

import dataclasses

__all__ = ["StagePlan", "plan_stages"]


def _top(key: str) -> str:
    """The top-level module of a flat parameter or cache name."""
    return key.split(".", 1)[0]


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Contiguous equal-size layer assignment of ``num_layers`` encoder
    layers onto ``num_stages`` pipeline stages."""

    num_layers: int
    num_stages: int

    @property
    def layers_per_stage(self) -> int:
        return self.num_layers // self.num_stages

    def layer_range(self, stage: int) -> tuple[int, int]:
        """``[lo, hi)`` layer indices owned by ``stage``."""
        if not 0 <= stage < self.num_stages:
            raise ValueError(f"stage {stage} out of range for pp={self.num_stages}")
        lo = stage * self.layers_per_stage
        return lo, lo + self.layers_per_stage

    def stage_arg(self, stage: int) -> tuple[int, int, bool, bool]:
        """The ``stage=`` argument for a stage-sliced model apply."""
        lo, hi = self.layer_range(stage)
        return (lo, hi, stage == 0, stage == self.num_stages - 1)

    def stage_of_layer(self, layer: int) -> int:
        if not 0 <= layer < self.num_layers:
            raise ValueError(f"layer {layer} out of range for {self.num_layers} layers")
        return layer // self.layers_per_stage

    def owner_stages(self, key: str) -> tuple[int, ...]:
        """Which stage(s) hold parameter ``key`` (a flat name, or its
        top-level module)."""
        top = _top(key)
        last = self.num_stages - 1
        if top == "token_embed":
            # Stage 0 embeds; the last stage's tied head reads the same
            # matrix: both hold a copy.
            return (0,) if last == 0 else (0, last)
        if top == "pos_embed":
            return (0,)
        if top in ("ln_final", "mlm_bias"):
            return (last,)
        if top.startswith("layer_"):
            return (self.stage_of_layer(int(top[len("layer_"):])),)
        raise KeyError(f"no stage assignment for param key {key!r}")

    def split_params(self, params) -> list[dict]:
        """Per-stage parameter dicts (``token_embed`` on both stage 0 and
        the last stage)."""
        parts: list[dict] = [{} for _ in range(self.num_stages)]
        for key in params:
            for s in self.owner_stages(key):
                parts[s][key] = params[key]
        return parts

    def split_tree(self, tree) -> list[dict]:
        """Per-stage cache dicts: ``layer_i`` leaves go to the layer's
        owning stage, the dense ``pos_index`` counter to stage 0 (it feeds
        the embedding's positional slice)."""
        parts: list[dict] = [{} for _ in range(self.num_stages)]
        for key in tree:
            top = _top(key)
            if top.startswith("layer_"):
                s = self.stage_of_layer(int(top[len("layer_"):]))
            elif top == "pos_index":
                s = 0
            else:
                raise KeyError(f"no stage assignment for cache key {key!r}")
            parts[s][key] = tree[key]
        return parts


def plan_stages(num_layers: int, num_stages: int) -> StagePlan:
    """Validated stage plan; raises ``ValueError`` when the layer count
    cannot split into ``num_stages`` contiguous equal stages (the
    reference's messages)."""
    num_layers = int(num_layers)
    num_stages = int(num_stages)
    if num_stages < 1:
        raise ValueError(f"pp={num_stages} must be >= 1")
    if num_layers < num_stages:
        raise ValueError(
            f"pp={num_stages} stages need at least one layer each but "
            f"the model has {num_layers} layers")
    if num_layers % num_stages != 0:
        raise ValueError(
            f"num_layers={num_layers} does not divide into pp="
            f"{num_stages} contiguous equal stages; choose a pp that "
            f"divides the layer count")
    return StagePlan(num_layers=num_layers, num_stages=num_stages)

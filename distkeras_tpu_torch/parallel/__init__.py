"""Parallelism: meshes over process ranks (``mesh``), the process group
and the sequence-parallel collectives (``distributed``), sharding rules
(``sharding``), model- and sequence-parallel training (``gspmd``), pipeline
parallelism (``pipeline``: GPipe and interleaved stages; ``pipeline_1f1b``;
``pp``, the serving engine's stage plan),
and the parameter-server protocols, services and transports. The mesh
helpers import eagerly; ``distributed``, ``sharding``, ``gspmd``,
``pipeline``, ``pipeline_1f1b`` and ``pp`` (and the collectives ``axis_ring``,
``sp_permute``, ``sp_all_to_all``, ``pp_exchange``, and the engines
``pipeline_apply`` and ``pipeline_1f1b_value_and_grad``) resolve on first
use, as in ``distkeras_tpu/parallel/__init__.py``."""

from distkeras_tpu_torch.parallel.mesh import (
    best_mesh,
    data_parallel_shardings,
    make_mesh,
)

_LAZY_MODULES = {
    "distributed": "distkeras_tpu_torch.parallel.distributed",
    "gspmd": "distkeras_tpu_torch.parallel.gspmd",
    "sharding": "distkeras_tpu_torch.parallel.sharding",
    "pipeline": "distkeras_tpu_torch.parallel.pipeline",
    "pipeline_1f1b": "distkeras_tpu_torch.parallel.pipeline_1f1b",
    "pp": "distkeras_tpu_torch.parallel.pp",
}


_LAZY_NAMES = {
    **{name: "distkeras_tpu_torch.parallel.distributed"
       for name in ("axis_ring", "sp_permute", "sp_all_to_all", "pp_exchange")},
    "pipeline_apply": "distkeras_tpu_torch.parallel.pipeline",
    "pipeline_1f1b_value_and_grad": "distkeras_tpu_torch.parallel.pipeline_1f1b",
}


def __getattr__(name):
    import importlib

    if name in _LAZY_MODULES:
        return importlib.import_module(_LAZY_MODULES[name])
    if name in _LAZY_NAMES:
        return getattr(importlib.import_module(_LAZY_NAMES[name]), name)
    raise AttributeError(name)


__all__ = ["make_mesh", "best_mesh", "data_parallel_shardings"]

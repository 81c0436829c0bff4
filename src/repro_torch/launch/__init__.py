"""Launchers (port of ``repro/launch/``): the LM's serving loop, its train
step and train loop (``launch/train.py``), the meshes over
``torch.distributed``, the sharding rules (``sharding.py``), the dry-run
specs and runner (``specs.py``, ``dryrun.py``, ``hillclimb.py``) and the
per-device cost accounting (``hlo_analysis.py``)."""
from . import hlo_analysis, mesh, sharding  # noqa: F401
from .mesh import (  # noqa: F401
    ServingMesh,
    make_host_mesh,
    make_production_mesh,
    make_serving_mesh,
    spawn_ranks,
)

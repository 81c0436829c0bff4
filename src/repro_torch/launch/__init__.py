"""Launchers (port of ``repro/launch/``): the LM's serving loop, its train
step and train loop (``launch/train.py``), and the serving mesh over
``torch.distributed``."""
from . import mesh  # noqa: F401
from .mesh import ServingMesh, make_serving_mesh, spawn_ranks  # noqa: F401

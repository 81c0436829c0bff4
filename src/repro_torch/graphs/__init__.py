from . import formats, generators, signals  # noqa: F401
from .formats import Graph, from_edges, normalized_laplacian, to_dense  # noqa: F401

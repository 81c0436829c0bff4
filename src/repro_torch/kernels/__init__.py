# Hand-written CUDA kernels (csrc/) for the TPU kernels on the port's path,
# each as csrc/<name>.cu + ops.py (wrapper, launch count) + ref.py (plain
# PyTorch version).  Dispatch is by device: see dispatch.py.
from . import dispatch  # noqa: F401

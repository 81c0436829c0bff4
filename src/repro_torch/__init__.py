"""PyTorch + CUDA port of the GRF-GP system (first slice: the serving path).

The package mirrors ``src/repro/`` module for module and never imports JAX
or the JAX package.  Graph random-feature walk sampling, the sparse Φ / Φᵀ /
K̂ products, Jacobi CG and the pathwise-conditioned posterior run on a CUDA
card through hand-written kernels (``kernels/csrc/``); a tensor that lies on
the CPU goes to each kernel's plain PyTorch version instead.
"""

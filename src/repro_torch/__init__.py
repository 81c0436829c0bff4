"""PyTorch + CUDA port of the GRF-GP system and its LM scaffold.

The package mirrors ``src/repro/`` module for module and never imports JAX
or the JAX package.  Ported so far: graph random-feature walk sampling, the
sparse Φ / Φᵀ / K̂ products, Jacobi CG and the pathwise-conditioned posterior;
the LML fit, online GP serving and Thompson-sampling BO; the Nyström/SLQ
solver stack; the LM scaffold's serving path (``models``, ``configs``,
``launch.serve``); the paper's baselines; the observability (``obs``)
and resilience (``resilience``, ``checkpoint``) layers; and the async GP
fleet, the sharded serving state and the distributed GP over
``torch.distributed`` (``serving.fleet``, ``serving.sharded``,
``distributed``, ``launch.mesh``).  Every
kernel runs on a CUDA card as hand-written CUDA (``kernels/csrc/``); a
tensor that lies on the CPU goes to each kernel's plain PyTorch version
instead.
"""

"""Distributed GRF-GP over ``torch.distributed`` (port of
``repro/distributed``)."""
from .gp_shard import (  # noqa: F401
    psum_dot,
    psum_reduce,
    sharded_cg_solve,
    sharded_cg_solve_chunked,
    sharded_h_operator,
    sharded_posterior_sample,
)

"""Online GP serving (port of ``repro/serving``): incremental Cholesky
state, lazy query-row features and a micro-batching front end.  The async,
sharded and fleet serving of the JAX package are not ported yet."""
from . import engine, state, update  # noqa: F401
from .engine import GPRequest, GPServeLoop, thompson_draw  # noqa: F401
from .state import ServeState, init_state, posterior_moments  # noqa: F401
from .update import (  # noqa: F401
    forget,
    forget_batch,
    ingest,
    observe,
    observe_batch,
    refit,
    refit_alpha,
)

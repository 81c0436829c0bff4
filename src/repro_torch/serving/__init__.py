"""Online GP serving (port of ``repro/serving``): incremental Cholesky
state, lazy query-row features, a micro-batching front end, and the async
fleet over one state or a state sharded over a serving mesh."""
from . import engine, fleet, sharded, state, update  # noqa: F401
from .engine import GPRequest, GPServeLoop, thompson_draw  # noqa: F401
from .fleet import GPFleetLoop  # noqa: F401
from .sharded import ShardedServeState  # noqa: F401
from .state import ServeState, init_state, posterior_moments  # noqa: F401
from .update import (  # noqa: F401
    forget,
    forget_batch,
    forget_batch_async,
    ingest,
    observe,
    observe_batch,
    observe_batch_async,
    refit,
    refit_alpha,
)

"""Host data pipeline of the LM scaffold (port of ``repro/data/``)."""
from .pipeline import TokenStream  # noqa: F401

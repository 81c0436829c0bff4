from .registry import get_config, list_archs, reduce_config  # noqa: F401

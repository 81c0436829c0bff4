from . import attention, config, layers, model  # noqa: F401
from .config import SHAPES, LayerSpec, ModelConfig  # noqa: F401
from .model import decode_step, forward, init_cache, init_params, prefill  # noqa: F401

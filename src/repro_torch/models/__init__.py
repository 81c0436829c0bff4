from . import attention, config, layers, mla, model, moe, ssm  # noqa: F401
from .config import SHAPES, LayerSpec, ModelConfig  # noqa: F401
from .model import (  # noqa: F401
    decode_step, forward, init_cache, init_params, loss_fn, prefill)

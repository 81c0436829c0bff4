"""h2o-danube-1.8b [dense] — arXiv:2401.16818: 24L d_model=2560 32H (GQA kv=8)
d_ff=6912 vocab=32000, llama+mistral mix with sliding-window attention."""
from ..models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="decoder",
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32_000,
        stages=((24, (LayerSpec(kind="attn", window=4096),)),),
        remat="dots",
        subquadratic=True,
    )

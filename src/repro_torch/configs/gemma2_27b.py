"""gemma2-27b [dense] — arXiv:2408.00118: 46L d_model=4608 32H (GQA kv=16)
d_ff=36864 vocab=256000, local(4096):global alternating, logit softcaps."""
from ..models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="decoder",
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_ff=36864,
        vocab_size=256_000,
        stages=((23, (LayerSpec(kind="attn", window=4096), LayerSpec(kind="attn"))),),
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        remat="dots",
        fsdp=True,
        subquadratic=True,
    )

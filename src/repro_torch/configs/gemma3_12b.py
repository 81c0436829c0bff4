"""gemma3-12b [dense] — [hf:google/gemma-3-1b-pt; unverified]: 48L d_model=3840
16H (GQA kv=8) d_ff=15360 vocab=262144, 5:1 local:global (window 1024)."""
from ..models.config import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=1024)
_GLOBAL = LayerSpec(kind="attn")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="decoder",
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        d_ff=15360,
        vocab_size=262_144,
        stages=((8, (_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL)),),
        rope_theta=1_000_000.0,
        remat="dots",
        fsdp=True,
        subquadratic=True,
    )

"""gemma3-4b [dense] — [hf:google/gemma-3-1b-pt; unverified]: 34L d_model=2560
8H (GQA kv=4) d_ff=10240 vocab=262144, 5:1 local:global (window 1024), 128k."""
from ..models.config import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=1024)
_GLOBAL = LayerSpec(kind="attn")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="decoder",
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        d_ff=10240,
        vocab_size=262_144,
        # 34 layers = 5 × (5 local + 1 global) + 4 trailing local.
        stages=(
            (5, (_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL)),
            (4, (_LOCAL,)),
        ),
        rope_theta=1_000_000.0,
        remat="dots",
        subquadratic=True,
    )

"""llama-3.2-vision-11b [vlm] — [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256,
cross-attention image layers every 5th layer.  The vision frontend is a STUB:
input_specs() provides precomputed patch embeddings [B, 1600, d_model]."""
from ..models.config import LayerSpec, ModelConfig

_SELF = LayerSpec(kind="attn")
_CROSS = LayerSpec(kind="cross_attn")


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="decoder",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128_256,
        # 40 layers = 8 × (1 cross-attn + 4 self-attn).
        stages=((8, (_CROSS, _SELF, _SELF, _SELF, _SELF)),),
        n_vis_tokens=1600,
        rope_theta=500_000.0,
        remat="dots",
        fsdp=True,
        subquadratic=False,
    )

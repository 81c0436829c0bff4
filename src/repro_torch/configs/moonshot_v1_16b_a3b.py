"""moonshot-v1-16b-a3b [moe] — kimi/moonlight 16B-A3B
[hf:moonshotai/Moonlight-16B-A3B; hf]: 48L d_model=2048 16H (GQA kv=16)
expert d_ff=1408 vocab=163840, MoE 64 routed / top-6."""
from ..models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="decoder",
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=163_840,
        stages=((48, (LayerSpec(kind="attn", moe=True),)),),
        n_experts=64,
        top_k=6,
        moe_d_ff=1408,
        remat="dots",
        fsdp=True,
        subquadratic=False,
    )

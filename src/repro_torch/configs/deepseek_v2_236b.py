"""deepseek-v2-236b [moe] — arXiv:2405.04434: 60L d_model=5120 128H MLA
(kv_lora=512), expert d_ff=1536, vocab=102400, 2 shared + 160 routed top-6."""
from ..models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="decoder",
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=1536,
        vocab_size=102_400,
        stages=((60, (LayerSpec(kind="mla", moe=True),)),),
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1536,
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        remat="dots",
        fsdp=True,
        subquadratic=False,
    )

"""mamba2-2.7b [ssm] — arXiv:2405.21060 (SSD): 64L d_model=2560 attn-free,
vocab=50280, ssm_state=128, head_dim 64, expand 2."""
from ..models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="decoder",
        d_model=2560,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50_280,
        stages=((64, (LayerSpec(kind="mamba", has_mlp=False),)),),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_chunk=256,
        expand=2,
        remat="dots",
        subquadratic=True,
    )

"""zamba2-7b [hybrid] — arXiv:2411.15242: 81L d_model=3584, Mamba2 backbone
(ssm_state=64) + a SHARED attention block (32H, d_ff=14336) applied every 6th
layer.  81 = 13 × (5 mamba + shared attn) + 3 trailing mamba."""
from ..models.config import LayerSpec, ModelConfig

_MAMBA = LayerSpec(kind="mamba", has_mlp=False)
_SHARED = LayerSpec(kind="shared_attn")


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="decoder",
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32_000,
        stages=(
            (13, (_MAMBA, _MAMBA, _MAMBA, _MAMBA, _MAMBA, _SHARED)),
            (3, (_MAMBA,)),
        ),
        ssm_state=64,
        ssm_head_dim=64,
        ssm_chunk=256,
        expand=2,
        remat="dots",
        fsdp=True,
        subquadratic=True,
    )

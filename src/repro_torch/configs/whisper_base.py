"""whisper-base [audio] — arXiv:2212.04356: enc-dec, 6L encoder + 6L decoder,
d_model=512 8H d_ff=2048 vocab=51865.  The conv frontend is a STUB:
input_specs() provides precomputed frame embeddings [B, 1500, d_model].
Decoder layer = self-attn + cross-attn + MLP (pattern of two LayerSpecs).
Adaptation note (DESIGN.md): RoPE stands in for Whisper's learned absolute
positions; 32k decode cells are mechanical (real Whisper context is ≤448)."""
from ..models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51_865,
        stages=(
            (6, (LayerSpec(kind="attn", has_mlp=False), LayerSpec(kind="cross_attn"))),
        ),
        n_enc_layers=6,
        enc_seq=1500,
        remat="none",
        subquadratic=False,
    )

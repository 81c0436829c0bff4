"""Architecture registry + reduced-config derivation (the port's own copy
of ``repro/configs/registry.py``).

``get_config(name)`` returns the full published config; ``reduce_config``
shrinks width/depth/vocab/experts while preserving the stage structure, so
the CPU tests run a real forward and decode, and the same reduced config
means the same model in both packages."""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig
from . import (
    deepseek_v2_236b,
    gemma2_27b,
    gemma3_4b,
    gemma3_12b,
    h2o_danube_1_8b,
    llama_3_2_vision_11b,
    mamba2_2_7b,
    moonshot_v1_16b_a3b,
    whisper_base,
    zamba2_7b,
)

_MODULES = {
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "gemma3-4b": gemma3_4b,
    "gemma2-27b": gemma2_27b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "gemma3-12b": gemma3_12b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "mamba2-2.7b": mamba2_2_7b,
    "zamba2-7b": zamba2_7b,
    "whisper-base": whisper_base,
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list(_MODULES)}")
    return _MODULES[name].config()


def reduce_config(cfg: ModelConfig, max_repeat: int = 2) -> ModelConfig:
    """Tiny same-family config: small width, few experts, short stages."""
    def shrink_stage(repeat, pattern):
        new_pattern = tuple(
            dataclasses.replace(s, window=16 if s.window else None) for s in pattern
        )
        return (min(repeat, max_repeat), new_pattern)

    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=503,  # deliberately non-round to catch padding bugs
        stages=tuple(shrink_stage(r, p) for r, p in cfg.stages),
        n_experts=8 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=2 if cfg.top_k else 0,
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        kv_lora_rank=24 if cfg.kv_lora_rank else 0,
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        rope_head_dim=8 if cfg.kv_lora_rank else cfg.rope_head_dim,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=8 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=8,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=24 if cfg.enc_seq else 0,
        n_vis_tokens=12 if cfg.n_vis_tokens else 0,
        remat="none",
        fsdp=False,
        dtype="float32",
    )

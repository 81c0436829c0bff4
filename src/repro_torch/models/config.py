"""Model configuration of the LM scaffold (the port's own copy of
``repro/models/config.py``: the same fields, defaults and analytic counts).

Every architecture is a sequence of **stages**; a stage is a
``(repeat, pattern)`` pair where ``pattern`` is a short list of
:class:`LayerSpec`.  Parameters and caches are stacked per stage with a
leading ``[repeat]`` axis, as in the JAX package, so that its parameter
pytree carries across leaf for leaf.  Fields that steer XLA only
(``remat``, ``fsdp``, ``zero1``, ``sp_attn``, ``scan_unroll``,
``enc_pattern_mult``, ``use_pallas_attn``) are kept so that a config means
the same thing in both packages."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer slot inside a stage pattern."""

    kind: str = "attn"            # attn | mla | mamba | shared_attn | cross_attn
    window: Optional[int] = None  # sliding-window size (None = full)
    causal: bool = True
    moe: bool = False             # FFN is a routed MoE for this layer
    has_mlp: bool = True          # mamba blocks carry no separate MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # decoder | encdec
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Tuple[int, Tuple[LayerSpec, ...]], ...]
    head_dim: int = 0             # 0 ⇒ d_model // n_heads
    # --- attention extras ---
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"      # einsum (GShard baseline) | gather (§Perf)
    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    mla_absorb: bool = False      # absorbed decode (beyond-paper §Perf)
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    d_conv: int = 4
    expand: int = 2
    # --- enc-dec / frontend stubs ---
    n_enc_layers: int = 0
    enc_seq: int = 0              # whisper conv-frontend output frames (stub)
    n_vis_tokens: int = 0         # llama-vision patch embeddings (stub)
    # --- training / runtime ---
    dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    remat: str = "none"           # none | dots | full
    fsdp: bool = False            # shard params+opt over the data axis (ZeRO-3)
    zero1: bool = True            # shard optimizer m/v over the data axis
    use_pallas_attn: bool = False # route train attention through the kernel
    sp_attn: bool = False         # sequence/head-parallel attention activations (§Perf)
    attn_impl: str = "ref"        # ref | chunked (XLA online-softmax) | pallas
    attn_block_k: int = 1024      # chunked-attention KV block size
    scan_unroll: int = 1          # SSD chunk-scan unroll factor (dry-run cost probes)
    enc_pattern_mult: int = 1     # encoder-body multiplier (dry-run cost probe)
    tie_embeddings: bool = True
    # --- long-context capability (DESIGN.md §4 shape-grid skips) ---
    subquadratic: bool = False    # can run long_500k decode

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return sum(r * len(p) for r, p in self.stages)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer), for roofline."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for repeat, pattern in self.stages:
            for spec in pattern:
                total += repeat * self._layer_params(spec)
        # shared attention counted once, not per application
        if any(s.kind == "shared_attn" for _, p in self.stages for s in p):
            total -= (self._layer_params(LayerSpec(kind="shared_attn"))
                      * (self._count_kind("shared_attn") - 1))
        if self.n_enc_layers:
            enc_spec = LayerSpec(kind="attn", causal=False)
            total += self.n_enc_layers * self._layer_params(enc_spec)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        dense_expert = 3 * d * self.moe_d_ff
        per_layer_skip = (self.n_experts - self.top_k) * dense_expert
        n_moe_layers = sum(
            r for r, p in self.stages for s in p if s.moe
        )
        return self.param_count() - n_moe_layers * per_layer_skip

    def _count_kind(self, kind: str) -> int:
        return sum(r for r, p in self.stages for s in p if s.kind == kind)

    def _layer_params(self, spec: LayerSpec) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n = 0
        if spec.kind in ("attn", "shared_attn", "cross_attn"):
            n += d * self.n_heads * hd            # q
            n += 2 * d * self.n_kv_heads * hd     # k, v
            n += self.n_heads * hd * d            # o
            n += 2 * d                            # norms
        elif spec.kind == "mla":
            rk, rq, rd = self.kv_lora_rank, self.q_lora_rank, self.rope_head_dim
            qd = hd + rd
            n += d * rq + rq * self.n_heads * qd          # q down/up
            n += d * (rk + rd)                            # kv down + shared k_rope
            n += rk * self.n_heads * (hd + hd)            # k_nope/v up
            n += self.n_heads * hd * d                    # o
            n += 2 * d
        elif spec.kind == "mamba":
            din = self.expand * d
            nh = din // self.ssm_head_dim
            n += d * (2 * din + 2 * self.ssm_state + nh)  # in_proj(x,z), B,C, dt
            n += self.d_conv * din                        # conv
            n += din * d + 2 * d + nh                     # out proj, norms, A/D
        if spec.has_mlp and spec.kind != "mamba":
            if spec.moe:
                n += d * self.n_experts                               # router
                n += self.n_experts * 3 * d * self.moe_d_ff           # routed
                n += self.n_shared_experts * 3 * d * self.moe_d_ff    # shared
            else:
                n += 3 * d * self.d_ff
            n += d                                                    # mlp norm
        return n


# ----------------------------------------------------------------------------
# Input-shape grid (assigned): every cell is (name, kind, seq, global_batch).
# ----------------------------------------------------------------------------
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4_096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32_768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524_288, global_batch=1),
}

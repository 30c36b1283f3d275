"""Grok-1 314B. [hf:xai-org/grok-1]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts top-2.
"""
from repro_torch.types import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, shared_expert=False,
                  capacity_factor=1.25, router_aux_weight=0.01),
    tie_embeddings=False,
    source="hf:xai-org/grok-1",
)

"""Llama-4 Scout 17B-active, 16 experts. [hf:meta-llama/Llama-4-Scout-17B-16E]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1,
plus a Llama-4-style shared expert (early-fusion multimodal in the original;
the text backbone is what is assigned).
"""
from repro_torch.types import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=1, shared_expert=True,
                  capacity_factor=1.25, router_aux_weight=0.01),
    tie_embeddings=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

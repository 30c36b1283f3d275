"""Hymba 1.5B. [arXiv:2411.13676]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16 —
parallel attention + Mamba heads in every block; sliding-window attention on
all but three global layers (first / middle / last, per the paper).
Meta tokens and cross-layer KV sharing are omitted (DESIGN.md §7).
"""
from repro_torch.types import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    sliding_window=1024,
    global_layers=(0, 15, 31),
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk=128),
    tie_embeddings=True,
    source="arXiv:2411.13676",
)

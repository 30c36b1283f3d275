"""Gemma-3 12B. [hf:google/gemma-3-1b-pt family card]

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 — 5:1 local:global
attention (sliding window 1024 on local layers, every 6th layer global),
128k context in the original; long_500k runs via the SWA-dominant pattern.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15_360,
    vocab_size=262_144,
    sliding_window=1024,
    global_every=6,           # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    act="gelu",
    source="hf:google/gemma-3-1b-pt",
)

"""Minitron 4B (pruned Nemotron-4 15B). [arXiv:2407.14679]

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256_000,
    rope_theta=10_000.0,
    tie_embeddings=False,
    act="relu",               # Nemotron uses squared-relu; relu2 in models
    source="arXiv:2407.14679",
)

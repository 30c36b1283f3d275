"""H2O-Danube3 4B. [arXiv:2401.16818 (danube series)]

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 — llama+mistral mix
with sliding-window attention (window 4096) -> long_500k runs.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10_240,
    vocab_size=32_000,
    sliding_window=4096,
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2401.16818",
)

"""PaliGemma 3B language backbone. [arXiv:2407.07726]

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216 — SigLIP vision
encoder + projector are a STUB per the assignment carve-out:
``input_specs()`` provides precomputed patch embeddings (batch, 256, d_model)
prepended to the text tokens; we build the Gemma-style decoder that consumes
them.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16_384,
    vocab_size=257_216,
    prefix_len=256,           # SigLIP 224px -> 256 patch tokens
    rope_theta=10_000.0,
    tie_embeddings=True,
    act="gelu",
    source="arXiv:2407.07726",
)

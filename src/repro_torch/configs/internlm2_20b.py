"""InternLM2 20B. [arXiv:2403.17297]

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_544,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="arXiv:2403.17297",
)

"""Mamba2 130M. [arXiv:2405.21060]

24L d_model=768 (attention-free) vocab=50280, ssm_state=128 — SSD
(state-space duality) blocks: d_inner = 2*d_model = 1536, head_dim 64
-> 24 SSD heads.
"""
from repro_torch.types import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

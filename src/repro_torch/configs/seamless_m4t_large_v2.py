"""SeamlessM4T-Large v2 text/speech backbone. [arXiv:2308.11596]

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 — encoder-decoder,
multimodal. The mel-spectrogram + conformer feature frontend is a STUB per
the assignment carve-out: ``input_specs()`` provides precomputed frame
embeddings of shape (batch, src_len, d_model); we build the transformer
backbone (24 encoder + 24 decoder layers of the given width).
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,            # decoder layers
    num_encoder_layers=24,    # encoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    tie_embeddings=False,
    act="relu",
    source="arXiv:2308.11596",
)

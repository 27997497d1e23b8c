"""whisper-medium — encoder-decoder audio transformer backbone [arXiv:2212.04356].

24 decoder layers, d_model=1024, 16 heads (kv=16), d_ff=4096, vocab=51865.
The conv/mel frontend is a stub: the caller supplies precomputed frame
embeddings of shape (B, 1500, 1024) as ``enc_embeds``; the port runs the
transformer that consumes them (encoder self-attention stack + diffusion
decoder with cross-attention).
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="encdec",
    source="arXiv:2212.04356",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    rope="sinusoidal",
    norm="layernorm",
    act="gelu",
    encdec=EncDecConfig(encoder_layers=24, encoder_seq=1500, frontend="audio_stub"),
    max_seq_len=4096,
    remat="block",
)

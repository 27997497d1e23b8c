"""chatglm3-6b — dense GQA decoder with 2d (half-dim) RoPE [arXiv:2406.12793].

28 layers, d_model=4096, 32 heads (GQA kv=2), d_ff=13696, vocab=65024.
RoPE is applied to half of each head dim (GLM's 2d rotary).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    source="arXiv:2406.12793",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope="half",
    max_seq_len=32768,
    remat="block",
)

"""stablelm-3b — dense decoder, MHA-like (kv=32)
[hf:stabilityai/stablelm-2-1_6b family].

32 layers, d_model=2560, 32 heads (kv=32), d_ff=6912, vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    max_seq_len=32768,
    remat="block",
)

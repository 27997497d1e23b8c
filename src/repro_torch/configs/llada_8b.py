"""llada-8b — the paper's own model [arXiv:2502.09992].

LLaDA-8B: 32 layers, d_model=4096, 32 heads (MHA), d_ff=12288, vocab=126464,
bidirectional attention, mask-prediction head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llada-8b",
    arch_type="dense",
    source="arXiv:2502.09992",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=12288,
    vocab_size=126464,
    max_seq_len=4096,
    remat="block",
)

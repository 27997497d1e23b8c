"""stablelm-12b — dense GQA decoder [hf:stabilityai/stablelm-2-1_6b family].

40 layers, d_model=5120, 32 heads (GQA kv=8), d_ff=13824, vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    max_seq_len=32768,
    remat="block",
)

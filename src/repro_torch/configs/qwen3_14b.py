"""qwen3-14b — dense GQA decoder with per-head q/k RMSNorm [hf:Qwen/Qwen3-8B family].

40 layers, d_model=5120, 40 heads (GQA kv=8), d_ff=17408, vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    remat="block",
)

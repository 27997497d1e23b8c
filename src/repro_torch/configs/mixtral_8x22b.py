"""mixtral-8x22b — sparse MoE with sliding-window attention [arXiv:2401.04088].

56 layers, d_model=6144, 48 heads (GQA kv=8), per-expert d_ff=16384,
vocab=32768, 8 experts top-2.  SWA makes this arch eligible for long_500k.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    source="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,                     # dense-equivalent hidden (experts use moe_d_ff)
    vocab_size=32768,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, num_experts_per_tok=2, moe_d_ff=16384),
    max_seq_len=65536,
    remat="block",
)

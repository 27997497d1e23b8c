"""hymba-1.5b — hybrid-head model: attention and mamba heads in parallel
within every block, outputs fused [arXiv:2411.13676].

32 layers, d_model=1600, 25 attn heads (GQA kv=5), d_ff=5504, vocab=32001,
ssm_state=16.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,          # Hymba uses SWA on most attn layers
    hybrid_ssm_heads=8,
    ssm=SSMConfig(state_size=16, conv_kernel=4, expand=2, num_ssm_heads=8),
    max_seq_len=524288,
    remat="block",
)

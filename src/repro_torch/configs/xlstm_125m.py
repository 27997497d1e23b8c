"""xlstm-125m — recurrent xLSTM stack (sLSTM + mLSTM blocks) [arXiv:2405.04517].

12 layers, d_model=768, 4 heads, vocab=50304, d_ff=0 (the projections
live inside the xLSTM blocks).  Attention-free: no RoPE, no KV cache.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    source="arXiv:2405.04517",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    attention="none",
    rope="none",
    ssm=SSMConfig(state_size=16, expand=2, num_ssm_heads=4,
                  xlstm_pattern="mmmmmms"),   # sLSTM every 7th block (xLSTM[7:1])
    max_seq_len=524288,
    remat="block",
)

"""deepseek-v2-236b — MLA + fine-grained MoE [arXiv:2405.04434].

60 layers, d_model=5120, 128 heads, MLA (kv_lora=512, q_lora=1536,
qk_nope=128, qk_rope=64, v_head=128), per-expert d_ff=1536,
2 shared + 160 routed experts top-6, vocab=102400.  First layer dense.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,            # MLA: per-head KV reconstructed from 512-d latent
    head_dim=192,                # qk_nope + qk_rope
    d_ff=12288,                  # the single dense (first_k_dense) layer
    vocab_size=102400,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, num_experts_per_tok=6, num_shared_experts=2,
                  moe_d_ff=1536, first_k_dense=1),
    max_seq_len=131072,
    remat="block",
)

"""qwen2-vl-72b — VLM language backbone with M-RoPE [arXiv:2409.12191].

80 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=29568, vocab=152064.
The vision encoder is a stub: the caller supplies precomputed patch
embeddings (B, P, d) as ``patch_embeds`` (1024 stand-in patches at full
size); a (d, d) projector maps them into the token stream, in front of
the text, with 3-section M-RoPE (temporal/height/width) position ids.
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    rope="mrope",
    mrope_sections=(16, 24, 24),   # t,h,w split of head_dim/2 = 64
    rope_theta=1_000_000.0,
    encdec=EncDecConfig(frontend="vision_stub", num_patch_tokens=1024),
    max_seq_len=32768,
    remat="block",
)

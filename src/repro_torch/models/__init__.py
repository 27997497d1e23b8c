"""Model zoo of the port: the dense (LLaDA, the GQA family), MoE
(Mixtral, DeepSeek-V2's MLA), hybrid (Hymba), encoder-decoder (whisper),
VLM (qwen2-vl) and xLSTM bidirectional stacks; the attention stacks'
block cache (``capture_cache``/``forward_cached``); and every family's
decode state (``init_decode_state``, ``decode_step``, ``forward_window``,
``set_valid_length``)."""
from repro_torch.models.model import (CacheState, DecodeState,
                                      capture_cache, decode_step, encode,
                                      encoder_config, forward,
                                      forward_cached, forward_window,
                                      init_decode_state, init_model,
                                      make_positions, set_valid_length)

__all__ = ["CacheState", "DecodeState", "capture_cache", "decode_step",
           "encode", "encoder_config", "forward", "forward_cached",
           "forward_window", "init_decode_state", "init_model",
           "make_positions", "set_valid_length"]

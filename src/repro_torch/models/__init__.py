"""Model zoo of the port: the dense (LLaDA, the GQA family), MoE
(Mixtral, DeepSeek-V2's MLA), hybrid (Hymba) and encoder-decoder
(whisper) bidirectional stacks so far, and the attention stacks' block
cache."""
from repro_torch.models.model import (DecodeState, capture_cache, encode,
                                      encoder_config, forward,
                                      forward_cached, init_model,
                                      make_positions)

__all__ = ["DecodeState", "capture_cache", "encode", "encoder_config",
           "forward", "forward_cached", "init_model", "make_positions"]

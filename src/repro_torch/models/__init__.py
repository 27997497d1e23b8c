"""Model zoo of the port: the dense (LLaDA, the GQA family), MoE
(Mixtral) and hybrid (Hymba) bidirectional stacks so far, and the dense
and MoE stacks' block cache."""
from repro_torch.models.model import (DecodeState, capture_cache, forward,
                                      forward_cached, init_model,
                                      make_positions)

__all__ = ["DecodeState", "capture_cache", "forward", "forward_cached",
           "init_model", "make_positions"]

"""Model zoo of the port: the dense (LLaDA) and hybrid (Hymba)
bidirectional stacks so far, and the dense stack's block cache."""
from repro_torch.models.model import (DecodeState, capture_cache, forward,
                                      forward_cached, init_model,
                                      make_positions)

__all__ = ["DecodeState", "capture_cache", "forward", "forward_cached",
           "init_model", "make_positions"]

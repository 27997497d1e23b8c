"""Model zoo of the port: the dense (LLaDA) and hybrid (Hymba)
bidirectional stacks so far."""
from repro_torch.models.model import forward, init_model, make_positions

__all__ = ["forward", "init_model", "make_positions"]

"""Serving layer of the port: the batched ``ServingEngine``."""
from repro_torch.serving.engine import (Batch, CorruptOutputError, Request,
                                        ServingEngine, validate_block_tokens)

__all__ = ["Batch", "CorruptOutputError", "Request", "ServingEngine",
           "validate_block_tokens"]

"""Training of the port (reference: ``src/repro/training/``): AdamW, the
masked-diffusion train step and loop, and ``.npz`` checkpoints in the
reference's key layout."""
from repro_torch.training.checkpoint import load, save
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update, cosine_schedule,
                                            global_norm)
from repro_torch.training.trainer import TrainStep, make_train_step, train

__all__ = ["load", "save", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "TrainStep", "make_train_step",
           "train"]

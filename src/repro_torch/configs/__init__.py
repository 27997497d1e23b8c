"""Config registry of the port: ``get_config(name)``.

Only the architectures the port runs are listed; the others arrive with
the slices that port their layers.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (DecodeConfig, DegradeConfig,
                                      EncDecConfig, ExecutionConfig,
                                      LadderRung, MLAConfig, ModelConfig,
                                      MoEConfig, RouterConfig, ServerConfig,
                                      SSMConfig, SupervisorConfig,
                                      TrainConfig, default_block_size)

_MODULES: Dict[str, str] = {
    "llada-8b": "repro_torch.configs.llada_8b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
}


def get_config(name: str) -> ModelConfig:
    """``name`` or ``name-tiny`` (the ``reduced()`` variant)."""
    if name.endswith("-tiny"):
        return get_config(name[: -len("-tiny")]).reduced()
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def list_configs() -> List[str]:
    return sorted(_MODULES)


__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "EncDecConfig",
    "DecodeConfig", "ExecutionConfig", "TrainConfig", "default_block_size",
    "SupervisorConfig", "LadderRung", "DegradeConfig", "ServerConfig",
    "RouterConfig", "get_config", "list_configs",
]

"""Config registry of the port: ``get_config(name)``.

Every architecture of the reference's registry, each a copy of its
config module; ``ASSIGNED_ARCHS`` is the reference's list (all but the
paper's own LLaDA), in its order.
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
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}

ASSIGNED_ARCHS: List[str] = [
    "whisper-medium", "mixtral-8x22b", "stablelm-12b", "stablelm-3b",
    "qwen3-14b", "xlstm-125m", "chatglm3-6b", "deepseek-v2-236b",
    "hymba-1.5b", "qwen2-vl-72b"]


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
    "RouterConfig", "get_config", "list_configs", "ASSIGNED_ARCHS",
]

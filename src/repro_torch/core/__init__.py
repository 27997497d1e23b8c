"""Foreseeing decoding for masked-diffusion LMs, in PyTorch.

  masking     — the training corruption and inference start states
  loss        — the masked-diffusion objective (Eq. 4) and accuracy
  confidence  — C_local metrics + the C_global (foreseeing) estimator
  strategies  — the Strategy protocol + registry; Random/Probability/
                Margin/Entropy + EB + WINO baselines
  fdm         — Algorithm 1 (FDM)
  fdm_a       — Algorithm 2 (FDM-A)
  graphs      — ``run_masked`` and the CUDA-graph set of a decode runner
  loop        — the eager and the graph block drivers
  decoder     — ``Decoder``, ``SampleStats`` and the runner cache
"""
from repro_torch.core.confidence import (Scores, global_confidence,
                                         local_confidence, score_logits)
from repro_torch.core.decoder import (BlockEvent, CacheInfo, Decoder,
                                      RunnerCache, SampleStats,
                                      clear_decode_cache, decode_cache_info,
                                      decode_cache_scope,
                                      reset_decode_cache_stats,
                                      validate_cache_policy)
from repro_torch.core.fdm import fdm_select, fdm_step
from repro_torch.core.fdm_a import FDMAStrategy, fdm_a_plan
from repro_torch.core.strategies import (Strategy, available_strategies,
                                         commit_topn, rank_desc,
                                         register_strategy, resolve_strategy,
                                         unregister_strategy)

__all__ = [
    "Scores", "score_logits", "local_confidence", "global_confidence",
    "Decoder", "SampleStats", "BlockEvent", "validate_cache_policy",
    "RunnerCache", "CacheInfo", "decode_cache_info", "clear_decode_cache",
    "reset_decode_cache_stats", "decode_cache_scope",
    "fdm_select", "fdm_step", "FDMAStrategy", "fdm_a_plan",
    "Strategy", "commit_topn", "rank_desc", "register_strategy",
    "resolve_strategy", "unregister_strategy", "available_strategies",
]

"""Foreseeing decoding for masked-diffusion LMs, in PyTorch.

  masking     — the training corruption and inference start states
  loss        — the masked-diffusion objective (Eq. 4) and accuracy
  confidence  — C_local metrics + the C_global (foreseeing) estimator
  strategies  — the Strategy protocol + registry; Random/Probability/
                Margin/Entropy + EB + WINO baselines
  fdm         — Algorithm 1 (FDM)
  fdm_a       — Algorithm 2 (FDM-A)
  wino        — ``wino_r``: WINO revocation, the pending set in the carry
  extrapolate — confidence extrapolation: skips forwards from the carry
  tracebuffer — on-device step telemetry (``dcfg.trace``) and its
                host read-back, ``DecodeTrace``
  graphs      — ``run_masked`` and the CUDA-graph set of a decode runner
  loop        — the eager and the graph block drivers
  decoder     — ``Decoder``, ``SampleStats`` and the runner cache
  sampler     — ``make_model_fn``: a conditioned forward from params
"""
from repro_torch.core.confidence import (Scores, global_confidence,
                                         local_confidence, score_logits)
from repro_torch.core.decoder import (BlockEvent, CacheInfo, Decoder,
                                      RunnerCache, SampleStats,
                                      clear_decode_cache, decode_cache_info,
                                      decode_cache_scope,
                                      reset_decode_cache_stats,
                                      validate_cache_policy)
from repro_torch.core.extrapolate import ExtrapolationStrategy
from repro_torch.core.fdm import fdm_select, fdm_step
from repro_torch.core.fdm_a import FDMAStrategy, fdm_a_plan
from repro_torch.core.sampler import make_model_fn
from repro_torch.core.strategies import (StatelessStrategy, Strategy,
                                         as_strategy, available_strategies,
                                         commit_topn, rank_desc,
                                         register_strategy, resolve_strategy,
                                         unregister_strategy)
from repro_torch.core.tracebuffer import (DecodeTrace, TracingStrategy,
                                          trace_capacity, tracing)
from repro_torch.core.wino import WINORevocationStrategy

__all__ = [
    "Scores", "score_logits", "local_confidence", "global_confidence",
    "Decoder", "SampleStats", "BlockEvent", "validate_cache_policy",
    "make_model_fn",
    "RunnerCache", "CacheInfo", "decode_cache_info", "clear_decode_cache",
    "reset_decode_cache_stats", "decode_cache_scope",
    "fdm_select", "fdm_step", "FDMAStrategy", "fdm_a_plan",
    "WINORevocationStrategy", "ExtrapolationStrategy",
    "Strategy", "StatelessStrategy", "as_strategy", "commit_topn",
    "rank_desc", "register_strategy", "resolve_strategy",
    "unregister_strategy", "available_strategies",
    "DecodeTrace", "TracingStrategy", "tracing", "trace_capacity",
]

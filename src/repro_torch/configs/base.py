"""Config dataclasses for the PyTorch port.

A field-for-field copy of the reference package's ``configs/base.py``
(model, decode and training configs), kept here so the port imports
nothing of the reference.  Configs are frozen dataclasses, so they hash
and can key the serving engine's batch buckets.  The serving stack's
configs (supervision, degradation ladder, server, router) are the
reference's too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0              # routed experts (0 = dense)
    num_experts_per_tok: int = 0      # top-k
    num_shared_experts: int = 0       # DeepSeek-style always-on experts
    moe_d_ff: int = 0                 # per-expert hidden size
    first_k_dense: int = 0            # leading layers that stay dense
    router_aux_coef: float = 0.01     # load-balance loss weight


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """xLSTM / Mamba-family knobs."""
    state_size: int = 16
    conv_kernel: int = 4
    expand: int = 2
    xlstm_pattern: str = "mmmmmms"
    num_ssm_heads: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 0
    encoder_seq: int = 0
    frontend: str = "none"            # 'audio_stub' | 'vision_stub' | 'none'
    num_patch_tokens: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""                  # citation for the dims

    head_dim: int = 0                 # 0 -> d_model // num_heads
    attention: str = "gqa"            # gqa | mla | none (pure ssm)
    rope: str = "standard"            # standard | half | mrope |
                                      # sinusoidal | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    qk_norm: bool = False
    sliding_window: int = 0           # 0 = full attention
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                 # silu (SwiGLU) | gelu (plain MLP)
    tie_embeddings: bool = False

    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    hybrid_ssm_heads: int = 0

    # diffusion
    mask_token_id: int = -1           # -1 -> vocab_size - 1 (reserved)
    max_seq_len: int = 4096
    dtype: str = "bfloat16"
    remat: str = "none"               # none | block: checkpoint each
                                      # block when training (model.forward)
    unroll: bool = False              # kept for field parity; unused here

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.mask_token_id < 0:
            object.__setattr__(self, "mask_token_id", self.vocab_size - 1)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    @property
    def is_moe(self) -> bool:
        return self.moe.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encdec is not None and self.encdec.encoder_layers > 0

    def reduced(self, **over) -> "ModelConfig":
        """The smoke-test variant: same family, tiny dims (identical to the
        reference's ``ModelConfig.reduced``)."""
        small: dict = dict(
            name=self.name + "-tiny",
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=min(self.max_seq_len, 128),
            head_dim=0,
            mask_token_id=-1,
            dtype="float32",
            remat="none",
        )
        small["num_kv_heads"] = min(self.num_kv_heads, small["num_heads"])
        if small["num_heads"] % small["num_kv_heads"]:
            small["num_kv_heads"] = 1
        if self.is_moe:
            small["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                num_experts_per_tok=min(self.moe.num_experts_per_tok, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                moe_d_ff=min(self.moe.moe_d_ff, 256),
                first_k_dense=min(self.moe.first_k_dense, 1),
            )
        if self.mla is not None:
            small["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                                     qk_nope_head_dim=32, qk_rope_head_dim=16,
                                     v_head_dim=32)
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, state_size=min(self.ssm.state_size, 16),
                num_ssm_heads=min(self.ssm.num_ssm_heads, 2))
        if self.encdec is not None:
            small["encdec"] = dataclasses.replace(
                self.encdec,
                encoder_layers=min(self.encdec.encoder_layers, 2),
                encoder_seq=min(self.encdec.encoder_seq, 32) or 0,
                num_patch_tokens=min(self.encdec.num_patch_tokens, 16))
        if self.hybrid_ssm_heads:
            small["hybrid_ssm_heads"] = 1
        if self.sliding_window:
            small["sliding_window"] = 32
        if self.mrope_sections:
            hd = small["d_model"] // small["num_heads"]
            small["mrope_sections"] = (hd // 4, hd // 8, hd // 8)
        small.update(over)
        return dataclasses.replace(self, **small)


CACHE_POLICIES = ("none", "prefix", "dual")
CACHE_REFRESH_MODES = ("block", "off")


@dataclass(frozen=True)
class ExecutionConfig:
    """The validated execution surface of a :class:`DecodeConfig` (same
    rules as the reference).  In the port, ``fused_loop``/``fused_blocks``
    have no effect (the driver is one eager loop, whose decodes the
    reference's three drivers all match), and ``use_pallas_kernel`` only
    guards against running the plain versions on a card: see
    ``core.decoder.check_kernel_flag``."""
    fused_loop: bool = True
    fused_blocks: bool = True
    use_pallas_kernel: Optional[bool] = None
    cache_policy: str = "none"
    cache_refresh: str = "block"

    def __post_init__(self):
        if self.cache_policy not in CACHE_POLICIES:
            raise ValueError(
                f"unknown cache_policy {self.cache_policy!r}; "
                f"expected one of {CACHE_POLICIES}")
        if self.cache_refresh not in CACHE_REFRESH_MODES:
            raise ValueError(
                f"unknown cache_refresh {self.cache_refresh!r}; "
                f"expected one of {CACHE_REFRESH_MODES}")
        if self.cache_policy == "dual" and self.cache_refresh == "off":
            raise ValueError(
                "cache_policy='dual' requires cache_refresh='block': the "
                "dual cache freezes committed blocks AND the masked "
                "suffix, so skipping block-boundary refreshes would "
                "decode every block against the prefill-time canvas")

    @property
    def cached(self) -> bool:
        return self.cache_policy != "none"


@dataclass(frozen=True)
class DecodeConfig:
    """Sampler / strategy hyperparameters (paper §5.1 defaults); the same
    fields and defaults as the reference's ``DecodeConfig``."""
    gen_length: int = 256
    block_size: int = 64
    steps: int = 256                   # T
    strategy: str = "fdm"              # random|probability|margin|entropy|
                                       # eb|wino|fdm|fdm_a|wino_r|extrapolate
    temperature: float = 0.0
    fused_loop: bool = True
    fused_blocks: bool = True
    use_pallas_kernel: Optional[bool] = None
                                       # None/True: hand-written kernels on
                                       # a CUDA device; False is refused on
                                       # one (no silent plain path on a card)
    cache_policy: str = "none"         # none | prefix | dual
    cache_refresh: str = "block"       # block | off
    # FDM (Algorithm 1)
    k: int = 2                         # search width K
    gamma: float = 0.6                 # dynamic pruning threshold
    # FDM-A (Algorithm 2)
    k1: int = 2
    gamma1: float = 0.5
    eta1: float = 0.8
    eta2: float = 0.7
    n_max: int = 8                     # N: decode-count upper bound
    # EB baseline
    eb_threshold: float = 0.5
    # WINO baseline
    wino_tau1: float = 0.7
    wino_tau2: float = 0.9
    # wino_r (revocation; not yet ported)
    wino_revoke_tau: float = 0.3
    wino_revoke_budget: int = 8
    # extrapolate (forward skipping; not yet ported)
    extrap_tau: float = 0.92
    extrap_beta: float = 0.5
    extrap_horizon: float = 2.0
    extrap_min_obs: int = 2
    # step telemetry (not yet ported)
    trace: bool = False

    def __post_init__(self):
        _ = self.execution

    @property
    def execution(self) -> ExecutionConfig:
        """Grouped, validated execution sub-config (see ExecutionConfig)."""
        return ExecutionConfig(
            fused_loop=self.fused_loop, fused_blocks=self.fused_blocks,
            use_pallas_kernel=self.use_pallas_kernel,
            cache_policy=self.cache_policy, cache_refresh=self.cache_refresh)


def default_block_size(gen_length: int) -> int:
    """Largest block ≤ gen_length/2 that divides gen_length; 1 for primes."""
    return next((b for b in range(gen_length // 2, 1, -1)
                 if gen_length % b == 0), 1)


@dataclass(frozen=True)
class SupervisorConfig:
    """Engine supervision (``repro.serving.supervisor``) knobs.

    The async scheduler runs every batch under this policy: decode
    failures are caught at the batch boundary, transient ones retried
    with capped exponential backoff, persistent ones bisected until the
    poison request is isolated and quarantined (it alone gets a terminal
    ``error`` event; its co-batched neighbours are re-queued and
    survive).  Engine-fatal failures (OOM-shaped errors, watchdog
    timeouts) feed a sliding-window crash counter; at
    ``breaker_threshold`` crashes inside ``breaker_window_s`` the
    circuit breaker trips and the engine is rebuilt through the router's
    hot-swap path while ``/healthz`` reports the model degraded (until
    the next clean batch completes).
    """
    max_retries: int = 2               # same-batch retries for transient
                                       # failures before bisection; also the
                                       # per-request re-queue cap on the
                                       # engine-fatal path
    backoff_base_s: float = 0.05       # retry delay: base * 2^(attempt-1),
    backoff_cap_s: float = 2.0         # capped here, with seeded jitter
    watchdog_s: float = 0.0            # per-BLOCK decode timeout (0 = off).
                                       # A block that exceeds it abandons
                                       # the batch: engine-fatal (the engine
                                       # may be wedged), requests re-queued
    breaker_threshold: int = 3         # engine-fatal crashes inside the
    breaker_window_s: float = 60.0     # window that trip the breaker
    drain_deadline_s: float = 5.0      # graceful-drain bound: queued work
                                       # gets this long to finish before the
                                       # remainder is shut down


@dataclass(frozen=True)
class LadderRung:
    """One graceful-degradation rung: when queue depth reaches
    ``at_depth`` (as a fraction of ``max_queue_depth``), effective steps
    are scaled by ``steps_scale``.  Fewer denoising steps over the same
    ``gen_length`` means MORE tokens committed in parallel per step —
    the cheapen-before-shed response ParallelBench's workload-dependent
    quality/latency frontier calls for."""
    at_depth: float
    steps_scale: float


@dataclass(frozen=True)
class DegradeConfig:
    """Graceful-degradation ladder (scheduler admission path).

    Under queue-depth or deadline-headroom pressure the scheduler
    progressively cheapens per-request effective configs before
    resorting to 429: rung 1 halves the step budget, rung 2 quarters it
    (never below one step per block).  The default rungs are the
    reference's: a decode's work is linear in its step budget, so halving
    steps roughly halves queue drain time, which is the lever that keeps
    the 429 count down at pressure.
    """
    enabled: bool = True
    rungs: Tuple[LadderRung, ...] = (LadderRung(at_depth=0.5,
                                                steps_scale=0.5),
                                     LadderRung(at_depth=0.8,
                                                steps_scale=0.25))


@dataclass(frozen=True)
class ServerConfig:
    """Async serving front end (``repro.serving.server``) knobs.

    Admission control is three-sided: ``max_queue_depth`` bounds the
    per-model engine queue (submits beyond it are rejected with HTTP 429
    — closed-loop clients back off instead of growing an unbounded
    queue), ``default_deadline_s`` expires requests that sit QUEUED
    longer than their deadline (they are dropped at batch-selection time,
    never decoded, and their streams get a terminal ``expired`` event),
    and the ``degrade`` ladder cheapens per-request step budgets under
    pressure BEFORE the queue fills (shed steps before shedding
    requests).  All act at the scheduling grain of blockwise diffusion
    decoding — between batches — because a running batch is
    batch-synchronous and cannot be preempted mid-decode.
    """
    host: str = "127.0.0.1"
    port: int = 8000                   # 0 = pick an ephemeral port
    max_queue_depth: int = 64          # queued (not yet decoding) requests
                                       # per model; beyond it submits get 429
    default_deadline_s: float = 0.0    # 0 = no deadline; per-request
                                       # "deadline_s" overrides
    max_gen_length: int = 1024         # request-validation cap on gen_length
    max_steps: int = 4096              # cap on the per-request steps
                                       # override: one request must not be
                                       # able to park the model's single
                                       # decode worker on an absurd step
                                       # budget (deadlines only bound
                                       # QUEUED time)
    stream_retain: int = 256           # finished event streams kept for a
                                       # late GET /v1/stream/{rid}
    max_body_bytes: int = 1 << 20      # POST body cap (413 beyond; chunked
                                       # bodies are rejected outright)
    retry_after_s: float = 1.0         # Retry-After header on 429/503
    profile_dir: str = ""              # non-empty = bracket each decoded
                                       # batch with torch.profiler, one
                                       # Chrome trace per batch written
                                       # here (ops use: flip on,
                                       # reproduce, flip off)
    supervisor: SupervisorConfig = SupervisorConfig()
    degrade: DegradeConfig = DegradeConfig()


@dataclass(frozen=True)
class RouterConfig:
    """Multi-model router (``repro.serving.router``) knobs.

    ``budget_bytes`` caps the summed parameter bytes of RESIDENT engines:
    admitting or rebuilding a model evicts idle least-recently-used
    engines until the batch fits (a busy engine — queued or mid-decode —
    is never evicted; the budget may transiently overshoot if everything
    is busy, and converges as decodes drain).  Evicting an engine drops
    the process's last strong reference to its params, so the Decoder's
    weak runner cache frees the compiled executables too —
    ``decode_cache_info()`` observably shrinks.
    """
    budget_bytes: int = 0              # 0 = unlimited
    max_models: int = 0                # 0 = unlimited registered models


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    seq_len: int = 64
    steps: int = 300
    lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    seed: int = 0
    log_every: int = 50
    eval_every: int = 100
    ckpt_dir: str = ""

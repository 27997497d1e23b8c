"""Decoding strategies of the port: the ``Strategy`` protocol, the registry
and the heuristic, EB and WINO baselines (reference:
``src/repro/core/strategies.py``).

The protocol (the reference's, with ``fused_step`` named
``device_step``):

  * ``init_carry(cfg, dcfg, device) -> carry`` — per-decode state
    (``()`` for the stateless builtins; FDM-A counts its phases in a
    tensor).  A strategy whose carry is positional (per canvas column)
    overrides ``init_carry_shaped(cfg, dcfg, batch, length, device)``
    instead, which every driver calls, and sets ``positional_carry``;
  * ``begin_block(carry, x, in_block) -> carry`` — fired by every driver
    before a block's first step; identity by default;
  * ``step(rng, carry, x, active, model_fn, cfg, dcfg, n)
    -> (new_x, new_carry, forwards)`` — one denoising step of the eager
    driver; ``rng`` is a ``torch.Generator`` on the canvas's device, ``n``
    the nominal commit width (an int); it may branch on the host;
  * ``device_step(...)`` — the same step for the graph drivers (the
    reference's ``fused_step``): ``n`` is a 0-dim int32 tensor on the
    device and the forward count comes back as a 0-dim f32 tensor there;
    no host sync, no host branch on data (FDM-A's search skip is a
    device-side select, ``graphs.run_masked``), and no write into the
    carry's tensors: the drivers write the returned carry where the step
    is live;
  * host-side stats read from the final carry into ``SampleStats``:
    ``phase_counts(carry)`` and ``carry_stats(carry)`` (``revocations``,
    ``skipped_forwards``);
  * for the step telemetry (``core/tracebuffer.py``):
    ``trace_confidence_tap``, ``trace_confidence(carry, dcfg)`` and
    ``trace_phase(before, after)``;
  * metadata: ``supports_fused`` (the strategy has a graph-safe step; one
    without decodes on the eager driver) and ``positional_carry`` (the
    cached path slices the carry's positional half with its window).

Registered strategies: the heuristics (random, probability, margin,
entropy), ``eb`` and ``wino`` here; ``fdm`` (``core/fdm.py``), ``fdm_a``
(``core/fdm_a.py``), ``wino_r`` (``core/wino.py``) and ``extrapolate``
(``core/extrapolate.py``) register themselves.  Third-party strategies
register through ``register_strategy`` or the ``repro_torch.strategies``
entry-point group.  The registry is the port's own; the reference's
registry is never touched.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.confidence import local_confidence, score_logits

ModelFn = Callable[[torch.Tensor], torch.Tensor]   # tokens (B,L) -> logits

NEG = -1e30


def rank_desc(conf: torch.Tensor) -> torch.Tensor:
    """Dense descending rank per row: rank 0 = highest confidence; equal
    scores rank by position (a stable sort, as ``jnp.argsort``)."""
    order = torch.argsort(-conf, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def commit_topn(x: torch.Tensor, conf: torch.Tensor, cand: torch.Tensor,
                eligible: torch.Tensor,
                n: Union[int, torch.Tensor]) -> torch.Tensor:
    """Commit cand tokens at the top-n eligible positions per example.

    conf (B,L) ranking score; eligible (B,L) bool; n (B,) or 0-dim on
    the device, or an int.
    """
    c = torch.where(eligible, conf, torch.full_like(conf, NEG))
    ranks = rank_desc(c)
    n_arr = n if isinstance(n, torch.Tensor) else \
        torch.full((x.shape[0],), n, device=x.device)
    commit = eligible & (ranks < n_arr.reshape(-1, 1))
    return torch.where(commit, cand.to(x.dtype), x)


class Strategy:
    """Base class for decoding strategies (see module docstring)."""

    name: str = ""
    # False = no graph-safe ``device_step``: the decoder runs the eager
    # driver whatever ``fused_loop`` says
    supports_fused: bool = True
    # True = the carry is ``(positional, global)``: ``positional`` a tree of
    # (B, L, ...) tensors column-aligned with the canvas, which the cached
    # path slices with its live window (``core/loop.py:carry_window``);
    # ``global`` rides every driver whole
    positional_carry: bool = False
    # True = the step's first full-canvas ``model_fn`` call is
    # unconditional, so the tracing adapter may capture its logits for the
    # commit confidence; False = ``trace_confidence`` gives it (or NaN)
    trace_confidence_tap: bool = False

    def init_carry(self, cfg: ModelConfig, dcfg: DecodeConfig, device):
        return ()

    def init_carry_shaped(self, cfg: ModelConfig, dcfg: DecodeConfig,
                          batch: int, length: int, device):
        """The carry for a (batch, length) canvas on ``device``: what every
        driver calls.  A positional strategy overrides this and returns
        ``(positional, global)``; the default is ``init_carry``."""
        return self.init_carry(cfg, dcfg, device)

    def begin_block(self, carry, x, in_block):
        """Block-entry hook, fired by every driver before a block's first
        step; ``in_block`` is the (L,) bool column mask of the new block
        over ``x``'s columns.  Identity by default."""
        return carry

    def phase_counts(self, carry) -> Dict[str, int]:
        """Per-phase step counts from the final carry (on the host)."""
        return {}

    def carry_stats(self, carry) -> Dict[str, float]:
        """Counters from the final carry (on the host), merged onto the
        ``SampleStats`` fields of the same names (``revocations``,
        ``skipped_forwards``)."""
        return {}

    def trace_confidence(self, carry, dcfg: DecodeConfig):
        """The (B, L) commit confidence read from the post-step carry, for
        a strategy without a confidence tap; None = NaN in the trace."""
        return None

    def trace_phase(self, carry_before, carry_after):
        """The step's phase id (a 0-dim int tensor) from its carry
        transition; None = -1 in the trace."""
        return None

    def step(self, rng, carry, x, active, model_fn: ModelFn,
             cfg: ModelConfig, dcfg: DecodeConfig, n) -> Tuple:
        raise NotImplementedError

    def device_step(self, rng, carry, x, active, model_fn: ModelFn,
                    cfg: ModelConfig, dcfg: DecodeConfig,
                    n: torch.Tensor) -> Tuple:
        """The graph drivers' step (the reference's ``fused_step``): ``n``
        a 0-dim int32 tensor, the forward count a 0-dim f32 tensor, both
        on ``x``'s device.  By default ``step`` with its count moved to
        the device, which suits a step that never syncs."""
        new_x, new_carry, fwd = self.step(rng, carry, x, active, model_fn,
                                          cfg, dcfg, n)
        if not isinstance(fwd, torch.Tensor):
            # a fill, not a host-to-device copy (which would sync)
            fwd = torch.full((), float(fwd), device=x.device)
        return new_x, new_carry, fwd.to(torch.float32)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class StatelessStrategy(Strategy):
    """Lifts ``step_fn(rng, x, active, model_fn, cfg, dcfg, n) -> (x,
    forwards)`` into the protocol."""

    # every builtin stateless step opens with one unconditional
    # full-canvas model_fn(x), which the tracing adapter may tap
    trace_confidence_tap = True

    def __init__(self, name: str, step_fn: Callable):
        self.name = name
        self._step_fn = step_fn

    def step(self, rng, carry, x, active, model_fn, cfg, dcfg, n):
        new_x, fwd = self._step_fn(rng, x, active, model_fn, cfg, dcfg, n)
        return new_x, carry, fwd


def as_strategy(obj) -> Strategy:
    """A ``Strategy``, a registered name, or a legacy step callable
    (``step_fn(rng, x, active, model_fn, cfg, dcfg, n) -> (x, forwards)``)
    as a ``Strategy``."""
    if isinstance(obj, Strategy):
        return obj
    if isinstance(obj, str):
        return resolve_strategy(obj)
    if callable(obj):
        return StatelessStrategy(getattr(obj, "__name__", "anonymous"), obj)
    raise TypeError(f"cannot interpret {obj!r} as a decoding strategy")


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, Strategy] = {}
_BUILTINS_LOADED = False
_ENTRY_POINTS_LOADED = False
ENTRY_POINT_GROUP = "repro_torch.strategies"


def register_strategy(strategy=None, *, name: Optional[str] = None,
                      replace: bool = False):
    """Register a ``Strategy`` instance, or a zero-argument ``Strategy``
    class (instantiated here), under ``name`` or its own ``name``.
    Returns its argument, so it also decorates a class::

        @register_strategy
        class Mine(Strategy):
            name = "mine"

    ``register_strategy(name=..., replace=...)`` returns such a
    decorator."""
    if strategy is None:
        return lambda s: register_strategy(s, name=name, replace=replace)
    obj = strategy() if isinstance(strategy, type) else strategy
    if not isinstance(obj, Strategy):
        raise TypeError(f"{strategy!r} is not a Strategy")
    key = name or obj.name
    if not key:
        raise ValueError(f"{obj!r} has no name")
    old = _REGISTRY.get(key)
    if old is not None and old is not obj and not replace:
        raise ValueError(f"strategy {key!r} already registered "
                         "(pass replace=True to override)")
    _REGISTRY[key] = obj
    return strategy


def unregister_strategy(name: str) -> None:
    """Drop ``name`` from the registry (a no-op if it is not there)."""
    _REGISTRY.pop(name, None)


def _ensure_builtins() -> None:
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    import repro_torch.core.extrapolate  # noqa: F401  ("extrapolate")
    import repro_torch.core.fdm          # noqa: F401  ("fdm")
    import repro_torch.core.fdm_a        # noqa: F401  ("fdm_a")
    import repro_torch.core.wino         # noqa: F401  ("wino_r")


def _load_entry_points() -> None:
    """Register the strategies published under ``ENTRY_POINT_GROUP``,
    once; a plugin that fails to load or register is skipped."""
    global _ENTRY_POINTS_LOADED
    if _ENTRY_POINTS_LOADED:
        return
    _ENTRY_POINTS_LOADED = True
    try:
        from importlib.metadata import entry_points
        eps = entry_points(group=ENTRY_POINT_GROUP)
    except Exception:
        return
    for ep in eps:
        try:
            register_strategy(ep.load(), name=ep.name)
        except Exception:
            continue                  # a broken plugin must not stop decode


def resolve_strategy(name) -> Strategy:
    """Look up a registered ``Strategy`` by name (a ``Strategy`` passes
    through); the entry points are loaded at the first unknown name."""
    if isinstance(name, Strategy):
        return name
    _ensure_builtins()
    if name not in _REGISTRY:
        _load_entry_points()
    if name not in _REGISTRY:
        raise KeyError(f"unknown strategy {name!r}; "
                       f"have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_strategies() -> Tuple[str, ...]:
    """The names ``resolve_strategy`` accepts, sorted."""
    _ensure_builtins()
    _load_entry_points()
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------------------
# baseline step functions
# --------------------------------------------------------------------------

def heuristic_step(metric: str):
    def step(rng, x, active, model_fn: ModelFn, cfg: ModelConfig,
             dcfg: DecodeConfig, n) -> Tuple[torch.Tensor, int]:
        s = score_logits(model_fn(x))
        if metric == "random":
            conf = torch.rand(x.shape, generator=rng, device=x.device)
        else:
            conf = local_confidence(s, metric)
        return commit_topn(x, conf, s.argmax, active, n), 1
    return step


def eb_step(rng, x, active, model_fn: ModelFn, cfg: ModelConfig,
            dcfg: DecodeConfig, n) -> Tuple[torch.Tensor, int]:
    """Entropy-bounded: commit everything with H < bound, at least one."""
    s = score_logits(model_fn(x))
    low_entropy = (-s.neg_entropy) < dcfg.eb_threshold
    conf = torch.where(active, s.neg_entropy,
                       torch.full_like(s.neg_entropy, NEG))
    best = rank_desc(conf) == 0                       # guarantee progress
    commit = active & (low_entropy | best)
    return torch.where(commit, s.argmax.to(x.dtype), x), 1


def wino_step(rng, x, active, model_fn: ModelFn, cfg: ModelConfig,
              dcfg: DecodeConfig, n) -> Tuple[torch.Tensor, int]:
    """Wide-in (commit > τ₁) then narrow-out (revoke < τ₂ on re-score)."""
    s = score_logits(model_fn(x))
    conf = torch.where(active, s.max_prob, torch.full_like(s.max_prob, NEG))
    best = rank_desc(conf) == 0
    wide = active & ((s.max_prob > dcfg.wino_tau1) | best)
    x_wide = torch.where(wide, s.argmax.to(x.dtype), x)
    # verify: the probability of each committed token in its new context —
    # a gather at the committed token, not the confidence kernel's argmax
    # reduction, so plain PyTorch as in the reference's jnp
    logp2 = torch.log_softmax(model_fn(x_wide).float(), dim=-1)
    p_committed = torch.exp(torch.gather(
        logp2, -1, x_wide[..., None].long())[..., 0])
    revoke = wide & (p_committed < dcfg.wino_tau2) & ~best
    return torch.where(revoke, torch.full_like(x_wide, cfg.mask_token_id),
                       x_wide), 2


for _metric in ("random", "probability", "margin", "entropy"):
    register_strategy(StatelessStrategy(_metric, heuristic_step(_metric)))
register_strategy(StatelessStrategy("eb", eb_step))
register_strategy(StatelessStrategy("wino", wino_step))

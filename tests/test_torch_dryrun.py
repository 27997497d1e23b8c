"""The one-card dry-run (``repro_torch.launch.{specs,roofline,dryrun}``)
against the reference's ``repro.launch`` on the CPU.

* ``SHAPES``, ``shape_admissible`` and ``model_flops_per_step`` equal the
  reference's for LLaDA and every config of ``ASSIGNED_ARCHS``;
* the meta stand-ins hold what ``jax.eval_shape`` gives: the params'
  elements per top-level group at full size, the decode state's at
  decode_32k and long_500k; AdamW's state holds twice the params;
* a step run on meta returns the shapes and dtypes of the same step run
  on the CPU (every reduced config, every step kind);
* ``step_cost``'s flops equal ``FlopCounterMode``'s count of the plain
  step on the CPU (it counts matrix products only), less what the plain
  version computes beyond the work: a band's masked pairs, MoE padding
  slots, the mLSTM chunk's masked half;
* the live-bytes tracker, the op cache and the peak model, exactly;
* full width only for LLaDA-8B's prefill_32k and decode_32k at batch 1,
  and the command line on xlstm-125m at long_500k.
"""
import contextlib
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.models import model as jm
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.kernels import confidence as conf_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import selective_scan as scan_mod
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch.steps import make_steps
from repro_torch.models import model as tm
from repro_torch.models import moe
from repro_torch.models.ssm import CHUNK, xlstm_kind

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["llada-8b"] + list(ASSIGNED_ARCHS)
SERVE_SHAPES = [(a, s) for a in ARCHS for s in ("decode_32k", "long_500k")
                if specs.shape_admissible(get_config(a), s)]
# dense attention with no band and no MoE: a training step's count is
# exact (the reduced configs do not checkpoint)
TRAIN_EXACT = ["llada-8b", "qwen3-14b", "chatglm3-6b", "stablelm-3b",
               "stablelm-12b", "whisper-medium", "qwen2-vl-72b"]
L, B = 64, 2


def _elements(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def test_shapes_match_reference():
    assert specs.SHAPES == jspecs.SHAPES
    assert len(SERVE_SHAPES) == len(ARCHS) + 3    # 3 sub-quadratic configs


@pytest.mark.parametrize("arch", ARCHS)
def test_admissibility_and_model_flops_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape, (kind, seq, batch) in specs.SHAPES.items():
        assert specs.shape_admissible(cfg, shape) == \
            jspecs.shape_admissible(jcfg, shape)
        assert roofline.model_flops_per_step(cfg, kind, seq, batch) == \
            jroof.model_flops_per_step(jcfg, kind, seq, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_params_match_eval_shape(arch):
    """Full size: the elements of each top-level group (DeepSeek-V2's tree
    holds 235,741,434,880, not ``param_count()``'s 235,741,306,880)."""
    sds = jax.eval_shape(functools.partial(jm.init_model,
                                           cfg=jax_get_config(arch)),
                         jax.random.PRNGKey(0))
    want = {k: sum(int(np.prod(x.shape)) for x in jax.tree.leaves(v))
            for k, v in sds.items()}
    params = specs.input_specs(get_config(arch), "prefill_32k", 1).args[0]
    assert {k: _elements(v) for k, v in params.items()} == want
    if arch == "deepseek-v2-236b":
        assert sum(want.values()) == 235_741_434_880


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_state_holds_twice_the_params(arch):
    params, opt, _, batch = specs.step_args(get_config(arch).reduced(),
                                            "train", 16, 1)
    assert all(t.dtype == torch.float32 and t.requires_grad
               for t in tree_leaves(params))
    assert _elements((opt.mu, opt.nu)) == 2 * _elements(params)
    assert batch["tokens"].device.type == "meta"


@pytest.mark.parametrize("arch,shape", SERVE_SHAPES,
                         ids=[f"{a}-{s}" for a, s in SERVE_SHAPES])
def test_decode_state_matches_eval_shape(arch, shape):
    """The state's floating-point elements at batch 1 (the reference's
    valid lengths are int32 leaves, the port's host ints)."""
    _, seq, _ = specs.SHAPES[shape]
    jcfg = jax_get_config(arch)
    sds = jax.eval_shape(lambda: jm.init_decode_state(jcfg, 1, seq,
                                                      jnp.bfloat16))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(sds)
               if jnp.issubdtype(x.dtype, jnp.floating))
    state = tm.init_decode_state(get_config(arch), 1, seq, device="meta")
    assert _elements(state.layer_states) == want
    if (arch, shape) == ("llada-8b", "decode_32k"):
        assert roofline.tree_bytes(state.layer_states) == 17_179_869_184


def _outputs(out):
    return [(tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t
            for t in tree_leaves(out)]


@pytest.mark.parametrize("kind", ["train", "prefill", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_step_outputs_match_cpu(arch, kind):
    cfg = get_config(arch).reduced()
    step = make_steps(cfg)[kind]
    cpu = _outputs(step(*specs.step_args(cfg, kind, L, B, "cpu")))
    meta_out = step(*specs.step_args(cfg, kind, L, B, "meta"))
    assert all(t.device.type == "meta" for t in tree_leaves(meta_out)
               if isinstance(t, torch.Tensor))
    assert _outputs(meta_out) == cpu


def _beyond_the_work(cfg, kind):
    """Products the plain step computes that ``step_cost`` does not count:
    a band's masked (query, key) pairs, MoE slots past the routed pairs,
    the masked half of each mLSTM chunk (and its padding past L)."""
    extra = 0
    if cfg.sliding_window and L > cfg.sliding_window:
        d = cfg.head_dim
        extra += cfg.num_layers * 2 * B * cfg.num_heads * (
            L * L - roofline.band_pairs(L, L, cfg.sliding_window)) * 2 * d
    if cfg.is_moe:
        m, t = cfg.moe, B * L
        slots = m.num_experts * moe.capacity(t, cfg, 1.25)
        n_moe = cfg.num_layers - m.first_k_dense
        extra += n_moe * 2 * (slots - t * m.num_experts_per_tok) * 3 * \
            cfg.d_model * m.moe_d_ff
    if cfg.arch_type == "ssm":
        s = cfg.ssm
        hd = s.expand * cfg.d_model       # heads × head dim
        nc = -(-L // CHUNK)
        n_m = sum(xlstm_kind(cfg, i) == "m" for i in range(cfg.num_layers))
        extra += n_m * nc * 2 * B * hd * CHUNK * (CHUNK - 1)
    return extra


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_flops_match_flop_counter(arch):
    """Exact for every reduced config (reduced LLaDA with nothing beyond
    the work)."""
    cfg = get_config(arch).reduced()
    with FlopCounterMode(display=False) as fc:
        make_steps(cfg)["prefill"](*specs.step_args(cfg, "prefill", L, B,
                                                    "cpu"))
    flops, _ = roofline.step_cost(cfg, "prefill", L, B)
    if arch == "llada-8b":
        assert _beyond_the_work(cfg, "prefill") == 0
    assert fc.get_total_flops() == flops + _beyond_the_work(cfg, "prefill")


@pytest.mark.parametrize("arch", TRAIN_EXACT)
def test_train_flops_match_flop_counter(arch):
    """Forward, backward (the VLM's projector without an input gradient)
    and no recomputation: the reduced configs set ``remat="none"``."""
    cfg = get_config(arch).reduced()
    assert cfg.remat == "none"
    with FlopCounterMode(display=False) as fc:
        make_steps(cfg)["train"](*specs.step_args(cfg, "train", L, B, "cpu"))
    assert fc.get_total_flops() == roofline.step_cost(cfg, "train", L, B)[0]


def test_serve_bound_is_the_serve_phase_s():
    """LLaDA-8B at 2 × 32k: 49.36 GB a step, 14.733 ms at 3.35 TB/s."""
    _, nbytes = roofline.step_cost(get_config("llada-8b"), "serve", 32768, 2)
    assert round(1e3 * nbytes / roofline.HBM_BW, 3) == 14.733


def test_live_bytes_counts_a_toy_sequence():
    """A storage counts once across views, from its first op to its
    death; an argument's storage from ``hold``."""
    arg = torch.empty(25, device="meta")              # 100 bytes
    mode = dryrun.LiveBytes()
    mode.hold((arg, arg[1:], {"again": arg.view(5, 5)}))
    assert mode.trace == [100]
    with mode:
        a = torch.empty(100, device="meta")           # +400
        v = a.view(10, 10)                            # a view: +0
        b = v + 1                                     # +400
        arg.mul_(2)                                   # in place: +0
        del a
        c = b.sum()                                   # +4 (v holds a's)
        del v
        d = torch.empty(10, dtype=torch.bfloat16, device="meta")  # +20
        del b, c, d
    assert mode.trace == [100, 500, 500, 900, 900, 904, 524]
    assert mode.peak == 904 and mode.live == 100


def test_meta_op_cache_keeps_the_live_bytes():
    """The cache answers functional ops with fresh tensors of the same
    layout and never answers an op that returned an alias
    (``_unsafe_view``)."""
    cfg = get_config("llada-8b").reduced()
    traces = []
    for cache in (False, True):
        args = specs.step_args(cfg, "train", L, B, "meta")
        mode = dryrun.LiveBytes()
        mode.hold(args)
        with dryrun.MetaOpCache() if cache else contextlib.nullcontext():
            with mode:
                make_steps(cfg)["train"](*args)
        traces.append(mode.trace)
    assert traces[0] == traces[1]
    cache = dryrun.MetaOpCache()
    x = torch.empty(4, 6, device="meta")
    with cache:
        y = torch.ops.aten._unsafe_view(x, [24])
        z = torch.ops.aten._unsafe_view(x, [24])
    assert y.untyped_storage()._cdata == x.untyped_storage()._cdata == \
        z.untyped_storage()._cdata


def test_peak_model_extrapolates_op_by_op():
    t1 = np.array([10, 50, 30])      # an optimizer's peak first ...
    t2 = np.array([10, 50, 45])      # ... an activation's that grows
    model = dryrun.PeakModel({1: t1, 2: t2})
    assert (model.peak(1), model.peak(2), model.peak(4)) == (50, 50, 75)
    assert model.max_batch(8, 60) == 3 and model.max_batch(8, 40) == 0
    # batch 1 made other ops: the line goes through 2 and 3
    model = dryrun.PeakModel({1: np.array([7]), 2: np.array([10, 20]),
                              3: np.array([10, 26])})
    assert (model.peak(1), model.peak(2), model.peak(5)) == (7, 20, 38)
    with pytest.raises(RuntimeError, match="cannot be paired"):
        dryrun.PeakModel({1: np.array([1]), 2: np.array([1, 2]),
                          3: np.array([1])})


def test_llada_full_width_prefill_and_decode_on_meta():
    """LLaDA-8B at full width and depth, batch 1: the prefill's peak holds
    the weights and the (1, 32768, 126464) f32 logits; the decode's the
    weights and the 17.18 GB cache."""
    cfg = get_config("llada-8b")
    logits = 4 * 32768 * cfg.vocab_size
    args = specs.input_specs(cfg, "prefill_32k", 1).args
    weights = roofline.tree_bytes(args[0])
    peak = dryrun.meta_trace(cfg, "prefill_32k", 1).max()
    assert weights + logits < peak < weights + 2 * logits
    scores = make_steps(cfg)["prefill"](*args)
    assert _outputs(scores) == [((1, 32768), torch.int32)] + \
        [((1, 32768), torch.float32)] * 3
    peak = dryrun.meta_trace(cfg, "decode_32k", 1).max()
    assert weights + 17_179_869_184 < peak < weights + 17_179_869_184 + \
        2 * 4 * cfg.vocab_size + 2 ** 30


def test_positions_past_the_table_are_refused():
    params = specs.input_specs(get_config("whisper-medium"), "train_4k",
                               1).args[0]
    assert dryrun.refusal(params, 4096) is None
    assert "4096 rows" in dryrun.refusal(params, 32768)
    params = specs.input_specs(get_config("llada-8b"), "prefill_32k",
                               1).args[0]
    assert dryrun.refusal(params, 32768) is None


def test_dryrun_command_line():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-125m", "--shape", "long_500k"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "1 ok, 0 failed" in res.stdout
    assert "[xlstm-125m × long_500k] serve L=524288 B=1" in res.stdout
    assert "| xlstm-125m | long_500k | 1 |" in res.stdout


def test_kernel_meta_stand_ins_have_the_plain_shapes():
    """On meta tensors each wrapper returns empty outputs of its kernel's
    shapes and dtypes, counts no launch and never runs the plain version;
    flash's stand-in is differentiable through ``attention_backward``."""
    before = (conf_mod.launches, fa_mod.launches, scan_mod.launches)

    def both(fn, *shapes_dtypes, **kw):
        cpu = [torch.zeros(s, dtype=d) for s, d in shapes_dtypes]
        meta = [t.to("meta") for t in cpu]
        kw_meta = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
                   for k, v in kw.items()}
        assert _outputs(fn(*meta, **kw_meta)) == _outputs(fn(*cpu, **kw))
    bf = torch.bfloat16
    both(conf_mod.confidence_fused, ((3, 5, 40), bf))
    both(fa_mod.flash_attention, ((2, 8, 4, 32), bf), ((2, 12, 2, 32), bf),
         ((2, 12, 2, 32), bf))
    both(fa_mod.flash_attention, ((2, 1, 4, 48), bf), ((2, 12, 2, 48), bf),
         ((2, 12, 2, 32), bf),
         kv_len=torch.tensor([5], dtype=torch.int32))
    scan = ((1, 20, 8), bf), ((1, 20, 8), torch.float32), \
        ((1, 20, 16), torch.float32), ((1, 20, 16), torch.float32), \
        ((8, 16), torch.float32)
    both(scan_mod.selective_scan, *scan)
    both(scan_mod.selective_scan, *scan,
         h0=torch.zeros(1, 8, 16), return_state=True)
    q = torch.empty(1, 8, 4, 32, device="meta", requires_grad=True)
    kv = torch.empty(1, 8, 2, 32, device="meta", requires_grad=True)
    out = fa_mod.flash_attention(q, kv, kv)
    (dq, dkv) = torch.autograd.grad(out.sum(), (q, kv))
    assert dq.shape == q.shape and dkv.shape == kv.shape
    assert (conf_mod.launches, fa_mod.launches, scan_mod.launches) == before

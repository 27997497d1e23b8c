"""Roofline terms of one step on one H100 (reference:
``src/repro/launch/roofline.py``, with the constants of
``launch/mesh.py``).

Two terms per (arch × shape), in seconds:

    compute = flops / PEAK_FLOPS
    memory  = bytes / HBM_BW

One card forms no mesh, so there is no collective term.  The reference
reads its flops and bytes from XLA's ``cost_analysis`` of the compiled
step; the port has no compiler to ask, so ``step_cost`` reckons both from
the config and the shapes.  They are the work the step must do, the same
whatever implements it: they count neither the masked tiles a plain
version computes nor an MoE layer's padded slots.

``model_flops_per_step`` is the reference's yardstick: 6·N_active·D to
train, 2·N_active·B·L to prefill, 2·N_active·B to serve one token.  Its
ratio to ``step_cost``'s flops (``useful_ratio``) flags recomputation
(``remat``) and attention's share.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import layer_cache
from repro_torch.models.layers import compute_dtype
from repro_torch.models.model import init_decode_state, init_model
from repro_torch.models.ssm import CHUNK as MLSTM_CHUNK
from repro_torch.models.ssm import xlstm_kind

# one NVIDIA H100 SXM (data sheet, dense rates, at its 700 W limit)
PEAK_FLOPS = 989e12          # bf16 on the tensor cores, FLOP/s
F32_FLOPS = 67e12            # f32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12             # HBM3, bytes/s
# exp on the SFU: 16 per clock per SM x 132 SMs x 1.98 GHz (boost)
SFU_OPS_PER_S = 16 * 132 * 1.98e9
HBM_BYTES = 80 * 2 ** 30     # the card's HBM3


@dataclass
class Roofline:
    arch: str
    shape: str
    batch: int
    flops: float                  # step_cost's flops
    bytes_accessed: float         # step_cost's bytes
    model_flops: float = 0.0      # model_flops_per_step

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def useful_ratio(self) -> float:
        """model_flops / step flops (recomputation and attention)."""
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.batch} | "
                f"{self.t_compute * 1e3:.2f} | {self.t_memory * 1e3:.2f} | "
                f"**{self.bottleneck}** | {self.useful_ratio:.3f} |")


def model_flops_per_step(cfg: ModelConfig, shape_kind: str, seq: int,
                         batch: int) -> float:
    """6·N_active·D for train (fwd+bwd), 2·N_active·D for inference."""
    n = cfg.active_param_count()
    if shape_kind == "train":
        d = batch * seq
        return 6.0 * n * d
    if shape_kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch * 1       # serve: one token


# --------------------------------------------------------------------------
# bytes
# --------------------------------------------------------------------------

def _tensors(tree) -> list:
    """The tensors among the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _tensors(t)]
    return [tree] if hasattr(tree, "element_size") else []


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def weight_bytes(cfg: ModelConfig, params) -> int:
    """Bytes of the weights a step reads: every weight but the token table
    (the step gathers B of its rows; tied, it is the head and counts)."""
    nbytes = tree_bytes(params)
    tok = params["embed"]["tok"]
    if not cfg.tie_embeddings:
        nbytes -= tok.numel() * tok.element_size()
    return nbytes


def state_bytes(state) -> int:
    """Bytes one serve step moves of its decode state: each attention
    layer's K/V read (every slot of its cache or ring), the recurrent
    states read and written."""
    nbytes = 0
    for st in state.layer_states:
        kv = layer_cache(st)
        rec = _tensors(st)
        if kv is not None:
            nbytes += tree_bytes((kv.k, kv.v))
            rec = [t for t in rec if t is not kv.k and t is not kv.v]
        nbytes += 2 * tree_bytes(rec)
    return nbytes


# --------------------------------------------------------------------------
# flops
# --------------------------------------------------------------------------

def band_pairs(lq: int, lk: int, window: int = 0) -> int:
    """(query, key) pairs a query may see: all Lq·Lk, or with a band
    those with |i − j| < window."""
    if not window:
        return lq * lk
    i = np.arange(lq, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0)
    hi = np.minimum(i + window - 1, lk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _weight_elements(params, cfg: ModelConfig) -> dict:
    """Weight elements each position of a stream multiplies by: ``dec``
    (a decoder position), ``enc`` (an encoder frame: the encoder's layers
    and the cross-attention's K/V), ``head`` (a scored position) and
    ``patch`` (a VLM's patch row).  Every weight of two or more axes is a
    matrix product's operand but Mamba's depthwise ``conv_w`` and its
    ``a_log`` (elementwise); an MoE layer's expert stacks (E, a, b) count
    the k experts a token visits."""
    out = {"dec": 0, "enc": 0, "head": 0, "patch": 0}

    def walk(tree, group, stream):
        for name, w in tree.items():
            if isinstance(w, dict):
                walk(w, group, stream)
            elif w.dim() < 2 or name in ("conv_w", "a_log"):
                continue
            elif group == "xattn" and name in ("wk", "wv"):
                out["enc"] += w.numel()
            elif w.dim() == 3:
                m = cfg.moe
                out[stream] += w.numel() * m.num_experts_per_tok \
                    // m.num_experts
            else:
                out[stream] += w.numel()
    for blk in params["blocks"]:
        for group, sub in blk.items():
            if isinstance(sub, dict):
                walk(sub, group, "dec")
    if "encoder" in params:
        for blk in params["encoder"]["blocks"]:
            for group, sub in blk.items():
                if isinstance(sub, dict):
                    walk(sub, group, "enc")
    emb = params["embed"]
    out["head"] = (emb["tok"] if cfg.tie_embeddings else emb["head"]).numel()
    if "projector" in params:
        out["patch"] = params["projector"]["w"].numel()
    return out


def _attention_flops(cfg: ModelConfig, kind: str, seq: int, batch: int,
                     dec_len: int) -> int:
    """Attention's score and value products (and the mLSTM's chunk
    products) over the keys each query may see: the decoder's self-
    attention (its band; at serve the live slots of the cache or the
    ring; MLA's (dqk, dv), at serve its absorbed latent form), the
    cross-attention over the encoder's frames and the encoder's own."""
    b, h = batch, cfg.num_heads
    flops = 0
    if cfg.arch_type == "ssm":
        s = cfg.ssm
        hh = s.num_ssm_heads
        dh = s.expand * cfg.d_model // hh
        n_m = sum(xlstm_kind(cfg, i) == "m" for i in range(cfg.num_layers))
        if kind == "serve":
            per = 4 * b * hh * dh * dh + 2 * b * hh * dh
        else:
            c = MLSTM_CHUNK
            nc = -(-seq // c)
            # inter-chunk q·C and q·n, the state's kᵀv, and the causal
            # half of each chunk's scores and values
            per = nc * (4 * b * c * hh * dh * dh + 2 * b * c * hh * dh
                        + 2 * b * hh * dh * c * (c + 1))
        return n_m * per
    if cfg.attention == "mla":
        m = cfg.mla
        dqk, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    else:
        dqk = dv = cfg.head_dim
    if kind == "serve":
        if cfg.attention == "mla":
            r = m.kv_lora_rank
            per = 2 * b * h * seq * (2 * r + m.qk_rope_head_dim)
        else:
            cap = min(seq, cfg.sliding_window) if cfg.sliding_window \
                else seq
            per = 2 * b * h * cap * (dqk + dv)
    else:
        per = 2 * b * h * band_pairs(dec_len, dec_len,
                                     cfg.sliding_window) * (dqk + dv)
    flops = cfg.num_layers * per
    if cfg.is_encdec and cfg.encdec.frontend == "audio_stub":
        frames = cfg.encdec.encoder_seq
        lq = 1 if kind == "serve" else seq
        hd = cfg.head_dim
        flops += cfg.num_layers * 2 * b * h * lq * frames * 2 * hd
        if kind != "serve":
            flops += cfg.encdec.encoder_layers * 2 * b * h * frames * \
                frames * 2 * hd
    return flops


def forward_flops(cfg: ModelConfig, params, kind: str, seq: int,
                  batch: int) -> Dict[str, int]:
    """A ``kind`` step's forward flops at ``seq`` and ``batch``, by part:
    ``head`` (the LM head), ``patch`` (a VLM's projector) and ``blocks``
    (the layers, the encoder's among them)."""
    patches = cfg.encdec.num_patch_tokens if (
        cfg.encdec is not None and cfg.encdec.frontend == "vision_stub"
        and kind != "serve") else 0
    audio = cfg.encdec is not None and cfg.encdec.frontend == "audio_stub"
    frames = cfg.encdec.encoder_seq if audio else 0
    rows = 1 if kind == "serve" else seq
    w = _weight_elements(params, cfg)
    dec_len = rows + patches
    return {"head": 2 * batch * rows * w["head"],
            "patch": 2 * batch * patches * w["patch"],
            "blocks": 2 * batch * (dec_len * w["dec"] + frames * w["enc"])
            + _attention_flops(cfg, kind, seq, batch, dec_len)}


def step_cost(cfg: ModelConfig, kind: str, seq: int,
              batch: int) -> Tuple[float, float]:
    """(flops, bytes) of one ``kind`` step at ``seq`` and ``batch``.

    *flops* are the step's matrix products — every weight of the step's
    parameters once per position it applies to (an MoE token's k experts,
    not its padded slots) — plus ``_attention_flops``; the embedding's
    gather, norms, the Mamba recurrence and every other elementwise op
    count nothing.  ``train`` is the forward three times (its backward
    twice; once for the projector, whose input needs no gradient) plus
    the blocks' forward once more when ``cfg.remat == "block"`` (the
    checkpoint's recomputation; PyTorch's stops early and skips each
    block's last product, which this still counts).

    *bytes*: every kind reads ``weight_bytes`` of its parameters (in the
    compute dtype; to train the f32 masters).  ``serve`` adds
    ``state_bytes`` of its state (``init_decode_state(cfg, batch, seq)``
    in the compute dtype, every slot live); ``prefill`` adds its f32
    logits (B, L, V), written and read; ``train`` adds prefill's logits,
    the masters' gradients (written, then read), the masters read and
    written by the update and AdamW's two moments read and written.  The stub frontends'
    inputs and the activations count nothing.  The parameters and the
    state are built on the ``meta`` device: nothing is allocated."""
    params = init_model(cfg, device="meta",
                        dtype=torch.float32 if kind == "train" else None)
    part = forward_flops(cfg, params, kind, seq, batch)
    flops = sum(part.values())
    if kind == "train":
        flops = 3 * flops - part["patch"] + (
            part["blocks"] if cfg.remat == "block" else 0)
    nbytes = weight_bytes(cfg, params)
    if kind == "serve":
        nbytes += state_bytes(init_decode_state(
            cfg, batch, seq, compute_dtype(cfg), device="meta"))
    else:
        nbytes += 2 * 4 * batch * seq * cfg.vocab_size
    if kind == "train":
        nbytes += 8 * tree_bytes(params)
    return float(flops), float(nbytes)

"""Architecture config system of the port: every arch is a frozen ArchConfig.

The port's own copy of the reference's ``configs/base.py`` (the port imports
nothing of the reference package), field for field, so a config built here
equals the reference's (``tests/test_torch_configs.py`` holds them equal).

A model is a repeated ``pattern`` of LayerSpecs (the stacked-repeat layout:
block parameters carry a leading ``(n_repeats,)`` axis); heterogeneous
schedules (jamba 1:7, gemma3 5:1) are expressed as longer patterns.
``get_config``/``list_configs`` resolve registry names; ``SHAPES`` supplies
``(seq_len, global_batch, kind)`` per shape; ``param_count()`` /
``active_param_count()`` are the reference's analytic counts (units:
parameters, not bytes).  Note: ``param_count()`` leaves out the dense MLP
(and its norm) of a non-MoE Mamba layer (jamba) and two of the three
(d_inner,) vectors of every Mamba layer, all of which
``models.model.param_shapes`` materializes; the copy keeps the reference's
formula unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

__all__ = ["LayerSpec", "ArchConfig", "register", "get_config", "list_configs",
           "SHAPES", "ShapeSpec", "cells_for"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"             # "attn" | "mamba"
    moe: bool = False
    window: Optional[int] = None   # sliding-window size; None = full attention


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_layers: int
    pattern: Tuple[LayerSpec, ...]
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, ...]] = None   # M-RoPE (qwen2-vl)
    # dense mlp
    d_ff: int = 0
    mlp_act: str = "silu"          # silu -> SwiGLU | gelu -> GeGLU
    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # EP all-to-all payload dtype; "float8_e4m3fn" halves dispatch traffic
    # (per-slot-scaled, DeepSeek-V3 style). "bfloat16" = paper-faithful baseline.
    moe_dispatch_dtype: str = "bfloat16"
    # ssm (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # dtype of the in-chunk associative scan elements; bf16 halves the
    # dominant HBM term of SSM training (decay factors are <= 1 so the
    # product chain is benign; the carry h stays f32 across chunks)
    ssm_scan_dtype: str = "float32"
    # "assoc": parallel associative scan in-chunk (~log(c) full passes);
    # "seq": sequential in-chunk scan emitting y directly (~2-3 passes of
    # HBM traffic; the time recurrence serializes on the VPU — the Pallas
    # mamba_scan kernel gives the best of both)
    ssm_impl: str = "assoc"
    # embedding / head / misc
    tie_embeddings: bool = False
    causal: bool = True            # False = encoder-only (hubert)
    frontend: str = "none"         # none | vision_stub | audio_stub
    norm_eps: float = 1e-6
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    # training-step internals
    loss_chunk: int = 512          # sequence-chunked xent
    attn_chunk: int = 512          # flash-style block size (pure-JAX path)
    mamba_chunk: int = 256
    remat: bool = True

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: pattern {len(self.pattern)} !| layers {self.n_layers}"

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    @property
    def has_attention(self) -> bool:
        return any(s.kind == "attn" for s in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer needs an unbounded full-attention KV cache at
        decode... i.e. all attention layers are windowed or the model is
        SSM/hybrid-with-few-global (gemma3/jamba run long_500k; see DESIGN.md)."""
        full_attn = [s for s in self.pattern if s.kind == "attn" and s.window is None]
        return len(full_attn) == 0 or (len(full_attn) / len(self.pattern)) <= 0.2

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head).

        Returns the exact number of scalar parameters (dimensionless count;
        multiply by the ``param_dtype`` byte width for memory / gradient
        traffic).  Matches the materialized ``models.model.param_shapes``
        tree for attention-only models; see the module docstring for the
        Mamba terms this formula (the reference's) leaves out.
        """
        D, V = self.d_model, self.vocab_size
        total = V * D                      # embedding
        if not self.tie_embeddings:
            total += D * V                 # head
        total += D                         # final norm
        for s in self.pattern:
            n = self.n_repeats
            if s.kind == "attn":
                qkv = D * self.n_heads * self.head_dim + 2 * D * self.n_kv_heads * self.head_dim
                o = self.n_heads * self.head_dim * D
                if self.qkv_bias:
                    qkv += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                total += n * (qkv + o + D)             # + norm
            else:  # mamba
                Di, N, R = self.d_inner, self.ssm_state, self.dt_rank
                total += n * (D * 2 * Di + Di * self.ssm_conv + Di * (R + 2 * N)
                              + R * Di + Di * N + Di + Di * D + D)
            if s.moe:
                total += n * (D * self.n_experts
                              + self.n_experts * 3 * D * self.moe_d_ff + D)
            elif s.kind == "attn" and self.d_ff:
                total += n * (3 * D * self.d_ff + D)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only).

        Returns ``param_count()`` with the expert MLPs rescaled from
        ``n_experts`` to ``experts_per_token`` — the count that enters the
        ``6 * active_params * tokens`` training-FLOP estimate used by
        the reference's workload lowering and roofline model.
        """
        if self.n_experts == 0:
            return self.param_count()
        dense = self.param_count()
        moe_layers = sum(1 for s in self.pattern if s.moe) * self.n_repeats
        all_experts = moe_layers * self.n_experts * 3 * self.d_model * self.moe_d_ff
        active = moe_layers * self.experts_per_token * 3 * self.d_model * self.moe_d_ff
        return dense - all_experts + active


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    """Add ``cfg`` to the registry under ``cfg.name``; returns it unchanged."""
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    """The registered ``ArchConfig`` for an exact registry ``name``.

    Raises ``KeyError`` for unknown names; see ``list_configs()`` for the
    valid set.
    """
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs():
    """Sorted list of every registered architecture name (loads on demand)."""
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import (falcon_mamba_7b, gemma3_12b, gemma_2b, grok1_314b,  # noqa: F401
                   h2o_danube3_4b, hubert_xlarge, jamba_v01_52b, kimi_k2_1t,
                   lm100m, qwen2_7b, qwen2_vl_7b)


# --------------------------------------------------------------------------
# assigned input shapes (LM family: seq_len x global_batch)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape: ``global_batch`` sequences of ``seq_len``
    tokens each; ``kind`` gates which passes run it (workload lowering
    accepts only ``kind == "train"``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig, repeats: int = 2) -> ArchConfig:
    """Smoke-test shrink of the same family: tiny widths/experts/vocab, scaled
    windows, one-or-two pattern repeats.  Structure (pattern, GQA ratio,
    activation, frontend, biases, M-RoPE) is preserved."""
    kv = 1 if cfg.n_kv_heads == 1 else 2
    heads = 4 if cfg.n_heads else 0
    head_dim = 16
    pattern = tuple(dataclasses.replace(s, window=(8 if s.window else None))
                    for s in cfg.pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        d_model=64, n_layers=len(cfg.pattern) * repeats, pattern=pattern,
        n_heads=heads, n_kv_heads=kv if heads else 0,
        head_dim=head_dim if heads else 0,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else None,
        d_ff=128 if cfg.d_ff else 0,
        n_experts=4 if cfg.n_experts else 0,
        experts_per_token=2 if cfg.n_experts else 0,
        moe_d_ff=32 if cfg.n_experts else 0,
        # capacity >= group size so forward/prefill/decode route identically
        # (capacity drops are group-size dependent by design; tests need exact
        # teacher-forcing equivalence)
        capacity_factor=4.0,
        ssm_state=8 if cfg.ssm_state else 0,
        vocab_size=211,
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=16, attn_chunk=8, mamba_chunk=8,
    )


def cells_for(cfg: ArchConfig):
    """The (arch x shape) cells this arch runs (skip rules per DESIGN.md)."""
    out = []
    for s in SHAPES.values():
        if not cfg.causal and s.kind == "decode":
            continue                       # encoder-only: no decode step
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue                       # pure full-attention: skip 500k
        out.append(s)
    return out

"""Unified model configuration covering all assigned architecture families
(the port of ``repro.models.config``; dtypes are torch dtypes).

One dataclass parameterizes dense GQA transformers, MoE (token-choice
top-k, optional parallel dense residual), Mamba2/SSD, Jamba-style hybrids,
encoder-decoder, and modality-stub (vlm/audio) variants.  Every assigned
arch in ``repro_torch.configs`` is an instance of this dataclass.

TP head padding: with a fixed 16-way "model" mesh axis, head counts that
are not multiples of 16 (deepseek 56H, llama3.2 24H, arctic 56H, mamba2's
24 SSD heads) are padded up at *parameter-build* time (``tp``).
Padded heads have zero weights in and out, so outputs are exact; the
wasted FLOPs are real work on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 128
    qkv_bias: bool = False       # qwen1.5
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    moe_top_k: int = 0
    expert_ff: int = 0           # per-expert hidden dim
    moe_every: int = 1           # layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    dense_residual: bool = False  # arctic: parallel dense MLP beside the MoE
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss_weight: float = 1e-2

    # --- SSM / hybrid ---
    ssm_state: int = 0           # N; 0 -> no ssm layers
    ssm_headdim: int = 64        # P
    ssm_expand: int = 2          # d_inner = expand * d_model
    ssm_conv_width: int = 4
    ssm_chunk: int = 256         # SSD chunk length
    attn_every: int = 0          # hybrid: layer i is attention iff
    attn_offset: int = 0         #   i % attn_every == attn_offset (jamba: 8, 4)

    # --- encoder-decoder ---
    encoder_layers: int = 0      # 0 -> decoder-only

    # --- modality frontend stub ---
    frontend: str = "none"       # none | vision | audio
    num_prefix: int = 256        # vlm: patch embeddings per image

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # -------------------------------------------------------------- derived
    @property
    def gqa_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def padded_heads(self, tp: int) -> int:
        """Query heads padded to a multiple of the model-axis size."""
        return _round_up(self.num_heads, tp)

    def padded_ssm_heads(self, tp: int) -> int:
        return _round_up(self.ssm_heads, tp)

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every == 0:
            return True
        return i % self.attn_every == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return i % self.moe_every == self.moe_offset

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: {attn|ssm} x {dense|moe} product."""
        kinds = []
        for i in range(self.num_layers):
            mix = "attn" if self.is_attn_layer(i) else "ssm"
            ff = "moe" if self.is_moe_layer(i) else "mlp"
            kinds.append(f"{mix}+{ff}")
        return tuple(kinds)

    def superblock_period(self) -> int:
        """Smallest period of the layer-kind pattern (scan unrolling unit).

        Homogeneous stacks -> 1 (pure scan); jamba -> 8 (scan over
        superblocks of 8 unrolled sub-layers)."""
        kinds = self.layer_kinds()
        for p in range(1, len(kinds) + 1):
            if len(kinds) % p == 0 and all(
                    kinds[i] == kinds[i % p] for i in range(len(kinds))):
                return p
        return len(kinds)

    # ------------------------------------------------------------ counting
    def param_count(self) -> int:
        """Total parameters (unpadded), for 6·N·D roofline accounting."""
        d, v = self.d_model, self.vocab_size
        n = v * d                                    # embedding
        if not self.tie_embeddings:
            n += v * d                               # lm head
        attn = (d * self.num_heads * self.head_dim   # q
                + 2 * d * self.num_kv_heads * self.head_dim   # kv
                + self.num_heads * self.head_dim * d  # o
                + (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
                * (1 if self.qkv_bias else 0))
        mlp = 3 * d * self.d_ff                       # swiglu
        moe = (self.num_experts * 3 * d * self.expert_ff
               + d * self.num_experts) if self.num_experts else 0
        h = self.ssm_heads
        ssm = (d * (2 * self.d_inner + 2 * self.ssm_state + h)  # in_proj
               + self.ssm_conv_width * (self.d_inner + 2 * self.ssm_state)
               + 3 * h                                # A, D, dt_bias
               + self.d_inner * d)                    # out_proj
        layers = 0
        for i in range(self.num_layers):
            layers += 2 * d                           # norms
            layers += attn if self.is_attn_layer(i) else ssm
            if self.is_moe_layer(i):
                layers += moe + (mlp if self.dense_residual else 0)
            else:
                layers += mlp
        enc = 0
        if self.encoder_layers:
            enc_attn = attn
            enc = self.encoder_layers * (2 * d + enc_attn + mlp)
            # decoder cross-attention blocks
            layers += self.num_layers * (d + attn)
        return n + layers + enc + d                   # final norm

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.num_experts:
            return self.param_count()
        full_moe = self.num_experts * 3 * self.d_model * self.expert_ff
        active_moe = self.moe_top_k * 3 * self.d_model * self.expert_ff
        n_moe_layers = sum(self.is_moe_layer(i)
                           for i in range(self.num_layers))
        return self.param_count() - n_moe_layers * (full_moe - active_moe)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Is this (arch, shape) cell runnable?  long_500k needs sub-quadratic
    attention (SSM / hybrid); pure full-attention archs skip it."""
    if shape == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        return False, ("full-attention arch: decoding against a 512k dense "
                       "KV cache is the quadratic-memory regime long_500k "
                       "excludes")
    return True, ""

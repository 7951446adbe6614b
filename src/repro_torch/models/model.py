"""The unified LM, serving half: parameters, prefill and decode for every
architecture family (dense, moe, ssm, hybrid, encdec, vlm).  The port of
``repro.models.model``.

Where the reference stacks parameters over superblocks (the smallest
repeating pattern of layer kinds) and scans them, the port keeps one
module a layer in an ``nn.ModuleList``: layer ``s·period + j`` is
superblock s's sub-layer j.  The decode state holds one cache a layer
(K/V for attention, (ssm, conv) for Mamba2, cross K/V for the decoder of
an encoder-decoder) and a host-side position; caches are written in
place.

All dense compute is in the config's compute dtype with f32
softmax/norm/router, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig

State = Dict[str, Any]


def _sub_kind(cfg: ModelConfig, i: int) -> str:
    mix = "attn" if cfg.is_attn_layer(i) else "ssm"
    if cfg.num_experts and cfg.is_moe_layer(i):
        ff = "moe+mlp" if cfg.dense_residual else "moe"
    elif cfg.d_ff > 0:
        ff = "mlp"
    else:
        ff = "none"
    return f"{mix}|{ff}"


def _ones(d: int, dtype, device) -> nn.Parameter:
    p = L._param((d,), dtype, device)
    with torch.no_grad():
        p.fill_(1.0)
    return p


class Block(nn.Module):
    """One layer: norm1 and a mixer (attention or Mamba2), then norm2 and a
    feed-forward (MLP, MoE, or both in parallel for arctic) unless the
    kind has none."""

    def __init__(self, cfg: ModelConfig, kind: str, tp: int, device=None):
        super().__init__()
        mix, ff = kind.split("|")
        d, dt = cfg.d_model, cfg.pdtype
        self.norm1 = _ones(d, dt, device)
        self.attn = L.Attention(
            d, cfg.padded_heads(tp), cfg.num_kv_heads, cfg.head_dim,
            cfg.num_heads, bias=cfg.qkv_bias, dtype=dt, device=device) \
            if mix == "attn" else None
        self.ssm = ssm_mod.Mamba2(
            d, cfg.d_inner, cfg.ssm_state, cfg.padded_ssm_heads(tp),
            cfg.ssm_heads, cfg.ssm_conv_width, dt, device) \
            if mix == "ssm" else None
        self.norm2 = _ones(d, dt, device) if ff != "none" else None
        self.moe = moe_mod.Moe(d, cfg.num_experts, cfg.expert_ff, dt,
                               device) if ff in ("moe", "moe+mlp") else None
        self.mlp = L.Mlp(d, cfg.d_ff, dt, device) \
            if ff in ("mlp", "moe+mlp") else None

    def reset(self, gen: torch.Generator) -> None:
        for m in (self.attn, self.ssm, self.moe, self.mlp):
            if m is not None:
                m.reset(gen)


class CrossAttention(nn.Module):
    """The cross-attention insert after each decoder layer of an
    encoder-decoder: its norm and attention weights (no bias)."""

    def __init__(self, cfg: ModelConfig, tp: int, device=None):
        super().__init__()
        self.norm = _ones(cfg.d_model, cfg.pdtype, device)
        self.attn = L.Attention(
            cfg.d_model, cfg.padded_heads(tp), cfg.num_kv_heads,
            cfg.head_dim, cfg.num_heads, bias=False, dtype=cfg.pdtype,
            device=device)

    def reset(self, gen: torch.Generator) -> None:
        self.attn.reset(gen)


class LM(nn.Module):
    """The model's weights.  ``tp`` pads query heads, SSD heads and the
    vocabulary as the reference's ``init_params(..., tp)`` does.  Built
    uninitialised on ``device`` (the card unless the caller names
    another): :func:`init_params` draws the weights, and
    ``carry.lm_params_from_numpy`` copies the reference's in."""

    def __init__(self, cfg: ModelConfig, tp: int = 1, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.pdtype
        v = padded_vocab(cfg, tp)
        self.embed = L._param((v, d), dt, device)
        self.final_norm = _ones(d, dt, device)
        self.lm_head = None if cfg.tie_embeddings \
            else L._param((v, d), dt, device)
        self.layers = nn.ModuleList(
            Block(cfg, _sub_kind(cfg, i), tp, device)
            for i in range(cfg.num_layers))
        self.cross = nn.ModuleList(
            CrossAttention(cfg, tp, device) for _ in range(cfg.num_layers)
        ) if cfg.encoder_layers else None
        self.enc_layers = nn.ModuleList(
            Block(cfg, "attn|mlp", tp, device)
            for _ in range(cfg.encoder_layers)) \
            if cfg.encoder_layers else None
        self.enc_final_norm = _ones(d, dt, device) \
            if cfg.encoder_layers else None
        self.patch_proj = L._param((d, d), dt, device) \
            if cfg.frontend == "vision" else None

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.lm_head is None else self.lm_head

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> None:
        L._normal_(self.embed, gen, 0.02)
        if self.lm_head is not None:
            L._normal_(self.lm_head, gen, 0.02)
        for group in (self.layers, self.cross, self.enc_layers):
            for m in group or ():
                m.reset(gen)
        if self.patch_proj is not None:
            L._normal_(self.patch_proj, gen,
                       float(1.0 / math.sqrt(self.cfg.d_model)))


def padded_vocab(cfg: ModelConfig, tp: int) -> int:
    """Vocab rounded up to the model-axis size; padded logits are masked."""
    return ((cfg.vocab_size + tp - 1) // tp) * tp


def init_params(cfg: ModelConfig, generator: torch.Generator, tp: int = 1,
                device=None) -> LM:
    """The model on ``device`` (the card unless the caller names another)
    with weights drawn from ``generator``, which must lie there too:
    normals scaled as the reference's ``init_params`` scales them, norms
    at 1, TP-padded heads zeroed (the draws themselves are torch's, not
    JAX's threefry)."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator lies on {generator.device}, the "
                         f"model is asked for on {device}")
    model = LM(cfg, tp, device)
    model.reset(generator)
    return model


# ========================================================== block application
def _apply_ff(cfg: ModelConfig, blk: Block, x: torch.Tensor) -> torch.Tensor:
    if blk.norm2 is None:
        return x
    h = L.rms_norm(x, blk.norm2, cfg.norm_eps)
    delta = None
    if blk.moe is not None:
        delta, _ = moe_mod.moe_apply(blk.moe, h, top_k=cfg.moe_top_k,
                                     capacity_factor=cfg.capacity_factor)
    if blk.mlp is not None:
        m = blk.mlp(h)
        delta = m if delta is None else delta + m
    return x + delta


def _apply_cross(cfg: ModelConfig, cr: CrossAttention, x: torch.Tensor,
                 enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention against the cached encoder K/V: every slot of the
    cache, the zero tail past the encoder's length included (the
    reference attends there too, with ``kv_valid_len=None``)."""
    h = L.rms_norm(x, cr.norm, cfg.norm_eps)
    q = cr.attn.q_proj(h)
    ctx = L.attention(q, enc_k, enc_v,
                      torch.zeros(x.shape[1], dtype=torch.long,
                                  device=x.device), None,
                      causal=False, q_chunk=1024)
    return x + cr.attn.out_proj(ctx)


def encode(cfg: ModelConfig, model: LM, src_embeds: torch.Tensor
           ) -> torch.Tensor:
    """Encoder stack (bidirectional attention) over stub frame embeddings."""
    x = src_embeds.to(cfg.cdtype)
    positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for blk in model.enc_layers:
        h = L.rms_norm(x, blk.norm1, cfg.norm_eps)
        q, k, v = blk.attn.qkv_proj(h)
        ctx = L.attention(L.rotate(q, cos, sin), L.rotate(k, cos, sin), v,
                          positions, None, causal=False, q_chunk=4096)
        x = x + blk.attn.out_proj(ctx)
        x = _apply_ff(cfg, blk, x)
    return L.rms_norm(x, model.enc_final_norm, cfg.norm_eps)


# ================================================================= decoding
def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      tp: int = 1, dtype=None, device=None) -> State:
    """Zeroed caches, one a layer, on ``device`` (the card unless the
    caller names another): ``{"pos": 0, "layers": [...], "cross": [...]
    (encoder-decoder only)}``."""
    device = resolve_device(device)
    dt = dtype or cfg.pdtype
    kv_shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)

    def kv():
        return {"k": torch.zeros(kv_shape, dtype=dt, device=device),
                "v": torch.zeros(kv_shape, dtype=dt, device=device)}

    def ssm():
        h = cfg.padded_ssm_heads(tp)
        hd = cfg.d_inner // cfg.ssm_heads
        lb = cfg.ssm_conv_width - 1
        return {"ssm": torch.zeros((batch, h, hd, cfg.ssm_state),
                                   dtype=torch.float32, device=device),
                "conv_x": torch.zeros((batch, lb, h * hd), dtype=dt,
                                      device=device),
                "conv_bc": torch.zeros((batch, lb, 2 * cfg.ssm_state),
                                       dtype=dt, device=device)}

    state: State = {"pos": 0, "layers": [
        kv() if cfg.is_attn_layer(i) else ssm()
        for i in range(cfg.num_layers)]}
    if cfg.encoder_layers:
        state["cross"] = [kv() for _ in range(cfg.num_layers)]
    return state


def _apply_sub_step(cfg: ModelConfig, blk: Block, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor], pos: int,
                    rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """One layer on (B, S_new, D) with its cache read and written in place
    (S_new = 1 decode, or the whole prompt during prefill)."""
    h = L.rms_norm(x, blk.norm1, cfg.norm_eps)
    s_new = x.shape[1]
    if blk.attn is not None:
        q, k, v = blk.attn.qkv_proj(h)
        q, k = L.rotate(q, *rope), L.rotate(k, *rope)
        k_cache = L.update_cache(cache["k"], k, pos)
        v_cache = L.update_cache(cache["v"], v, pos)
        positions = torch.arange(pos, pos + s_new, device=x.device)
        ctx = L.attention(q, k_cache, v_cache, positions, pos + s_new,
                          causal=True, q_chunk=1024)
        x = x + blk.attn.out_proj(ctx)
    else:
        st = ssm_mod.SsmState(ssm=cache["ssm"], conv_x=cache["conv_x"],
                              conv_bc=cache["conv_bc"])
        if s_new == 1:
            out, st = ssm_mod.ssm_decode_step(blk.ssm, h, st)
        else:
            out, st = ssm_mod.ssm_forward(
                blk.ssm, h, chunk=min(cfg.ssm_chunk, s_new), state=st)
        x = x + out
        cache.update(st._asdict())
    return _apply_ff(cfg, blk, x)


def forward_step(cfg: ModelConfig, model: LM, tokens: torch.Tensor,
                 state: State, prefix_embeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, State]:
    """Cache-carrying forward (prefill: tokens (B, S); decode: (B, 1)).
    Returns (f32 logits for the final position (B, V), the state), the
    state's caches and position updated in place."""
    pos = state["pos"]
    x = model.embed[tokens].to(cfg.cdtype)
    if prefix_embeds is not None:
        pe = prefix_embeds.to(cfg.cdtype)
        if cfg.frontend == "vision":
            pe = pe @ model.patch_proj
        x = torch.cat([pe, x], dim=1)
    s_new = x.shape[1]
    rope = L.rope_tables(torch.arange(pos, pos + s_new, device=x.device),
                         cfg.head_dim, cfg.rope_theta) \
        if cfg.num_heads else None
    for i, blk in enumerate(model.layers):
        x = _apply_sub_step(cfg, blk, x, state["layers"][i], pos, rope)
        if cfg.encoder_layers:        # cross K/V filled by fill_cross_caches
            ck = state["cross"][i]
            x = _apply_cross(cfg, model.cross[i], x, ck["k"], ck["v"])
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    head = model.head
    logits = (x[:, -1, :] @ head.T).float()
    if head.shape[0] != cfg.vocab_size:                     # mask vocab pad
        logits[:, cfg.vocab_size:] = L.MASKED
    state["pos"] = pos + s_new
    return logits, state


def fill_cross_caches(cfg: ModelConfig, model: LM, state: State,
                      enc_out: torch.Tensor) -> State:
    """Write every decoder layer's encoder K/V at slots [0, S_src) of its
    cross cache (in place)."""
    for cr, ck in zip(model.cross, state["cross"]):
        L.update_cache(ck["k"], L._proj_in(enc_out, cr.attn.wk), 0)
        L.update_cache(ck["v"], L._proj_in(enc_out, cr.attn.wv), 0)
    return state


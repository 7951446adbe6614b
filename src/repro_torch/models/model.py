"""The unified LM: parameters, the training forward (loss and aux losses,
with remat), prefill and decode for every architecture family (dense,
moe, ssm, hybrid, encdec, vlm).  The port of ``repro.models.model``.

Where the reference stacks parameters over superblocks (the smallest
repeating pattern of layer kinds) and scans them, the port keeps one
module a layer in an ``nn.ModuleList``: layer ``s·period + j`` is
superblock s's sub-layer j.  The decode state holds one cache a layer
(K/V for attention, (ssm, conv) for Mamba2, cross K/V for the decoder of
an encoder-decoder) and a host-side position; caches are written in
place.

Serving weights are built with ``requires_grad=False`` and run under
``inference_mode``; a train step switches them on.  The reference
checkpoints one superblock at a time (``jax.checkpoint`` over the scanned
body); :func:`forward_train` checkpoints each superblock's ``period``
layers and each encoder layer with ``torch.utils.checkpoint``.

All dense compute is in the config's compute dtype with f32
softmax/norm/router, as in the reference.

A model cut to a rank's blocks by ``launch.sharding.shard_model`` trains
on its mesh (``launch/sharding.py`` says how): :func:`forward_train`
takes this rank's rows of the batch and returns the global batch's loss
on every rank.  Each superblock gathers its layers' FSDP blocks over
"data" inside its checkpoint; the residual stream crosses a superblock
boundary in the layout its policy's ``act_mode`` names; the embedding
and the LM head are vocab-parallel over "model", the cross-entropy's
max and log-sum-exp reduced over "model" and its sums over the data
axes.  One body serves both: off a mesh the model's ``par`` is
``sharding.LOCAL`` and every collective is skipped.

Serving on a mesh (:func:`forward_step`) follows the same rules, one
layer's FSDP blocks gathered at a time, and a decode state cut at its
allocation (``init_decode_state(mesh=)``, ``sharding.DecodeLayout``):
the batch over the data axes when it fills them, the caches' sequence
over "model" (over every axis for a batch of one), the SSM states over
"model" by head.  Attention gathers the queries of every head over
"model", attends over the rank's slots, combines the softmax over the
sequence's ranks and keeps its head block for the row-parallel output;
the vocab-parallel head's logits are gathered over "model".
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core import mesh as mesh_mod
from repro_torch.core.device import resolve_device
from repro_torch.launch import sharding as sh
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


class Block(nn.Module):
    """One layer: norm1 and a mixer (attention or Mamba2), then norm2 and a
    feed-forward (MLP, MoE, or both in parallel for arctic) unless the
    kind has none."""

    def __init__(self, cfg: ModelConfig, kind: str, tp: int, device=None):
        super().__init__()
        mix, ff = kind.split("|")
        d, dt = cfg.d_model, cfg.pdtype
        self.norm1 = L._param((d,), dt, device)
        self.attn = L.Attention(
            d, cfg.padded_heads(tp), cfg.num_kv_heads, cfg.head_dim,
            cfg.num_heads, bias=cfg.qkv_bias, dtype=dt, device=device) \
            if mix == "attn" else None
        self.ssm = ssm_mod.Mamba2(
            d, cfg.d_inner, cfg.ssm_state, cfg.padded_ssm_heads(tp),
            cfg.ssm_heads, cfg.ssm_conv_width, dt, device) \
            if mix == "ssm" else None
        self.norm2 = L._param((d,), dt, device) if ff != "none" else None
        self.moe = moe_mod.Moe(d, cfg.num_experts, cfg.expert_ff, dt,
                               device) if ff in ("moe", "moe+mlp") else None
        self.mlp = L.Mlp(d, cfg.d_ff, dt, device) \
            if ff in ("mlp", "moe+mlp") else None

    def reset(self, gen: torch.Generator) -> None:
        for n in (self.norm1, self.norm2):
            if n is not None:
                n.fill_(1.0)
        for m in (self.attn, self.ssm, self.moe, self.mlp):
            if m is not None:
                m.reset(gen)


class CrossAttention(nn.Module):
    """The cross-attention insert after each decoder layer of an
    encoder-decoder: its norm and attention weights (no bias)."""

    def __init__(self, cfg: ModelConfig, tp: int, device=None):
        super().__init__()
        self.norm = L._param((cfg.d_model,), cfg.pdtype, device)
        self.attn = L.Attention(
            cfg.d_model, cfg.padded_heads(tp), cfg.num_kv_heads,
            cfg.head_dim, cfg.num_heads, bias=False, dtype=cfg.pdtype,
            device=device)

    def reset(self, gen: torch.Generator) -> None:
        self.norm.fill_(1.0)
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
        self.final_norm = L._param((d,), dt, device)
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
        self.enc_final_norm = L._param((d,), dt, device) \
            if cfg.encoder_layers else None
        self.patch_proj = L._param((d, d), dt, device) \
            if cfg.frontend == "vision" else None

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.lm_head is None else self.lm_head

    def _parts(self) -> List[Tuple[str, Callable]]:
        """(name, draw) of each top-level weight and each layer, in the
        order the reference draws them (the norms draw nothing)."""
        def normal(name, scale):
            return lambda g: L._normal_(getattr(self, name), g, scale)

        def ones(name):
            return lambda g: getattr(self, name).fill_(1.0)
        out = [("embed", normal("embed", 0.02))]
        if self.lm_head is not None:
            out.append(("lm_head", normal("lm_head", 0.02)))
        out.append(("final_norm", ones("final_norm")))
        for group in ("layers", "cross", "enc_layers"):
            for i, m in enumerate(getattr(self, group) or ()):
                out.append((f"{group}.{i}", m.reset))
        if self.enc_final_norm is not None:
            out.append(("enc_final_norm", ones("enc_final_norm")))
        if self.patch_proj is not None:
            out.append(("patch_proj", normal(
                "patch_proj", float(1.0 / math.sqrt(self.cfg.d_model)))))
        return out

    @torch.no_grad()
    def reset(self, gen: torch.Generator, device=None,
              cut: Optional[Callable[[List[str]], Any]] = None) -> None:
        """Draw every weight from ``gen`` (norms at 1).  With ``cut``, on
        a model built on "meta": each part (a top-level weight or a layer)
        is made on ``device``, drawn, and handed to ``cut`` (its
        parameters' names) before the next part is made, so the whole
        model is never held at once; the draws are those of a model built
        on ``device``."""
        for name, draw in self._parts():
            if cut is not None:
                if name in self._parameters:
                    p = self._parameters[name]
                    self._parameters[name] = nn.Parameter(
                        torch.empty(p.shape, dtype=p.dtype, device=device),
                        requires_grad=p.requires_grad)
                else:
                    self.get_submodule(name).to_empty(device=device)
            draw(gen)
            if cut is not None:
                mod = self.get_submodule(name) \
                    if name not in self._parameters else None
                cut([name] if mod is None else
                    [f"{name}.{n}" for n, _ in mod.named_parameters()])


def padded_vocab(cfg: ModelConfig, tp: int) -> int:
    """Vocab rounded up to the model-axis size; padded logits are masked."""
    return ((cfg.vocab_size + tp - 1) // tp) * tp


def init_params(cfg: ModelConfig, generator: torch.Generator, tp: int = 1,
                device=None, mesh=None,
                policy: Optional[sh.ShardingPolicy] = None) -> LM:
    """The model on ``device`` (the card unless the caller names another)
    with weights drawn from ``generator``, which must lie there too:
    normals scaled as the reference's ``init_params`` scales them, norms
    at 1, TP-padded heads zeroed (the draws themselves are torch's, not
    JAX's threefry).  With a ``mesh``: this rank's blocks under
    ``policy`` (``sharding.shard_model``), each part cut as soon as it is
    drawn, so a rank holds its blocks and one full part (a layer or the
    vocabulary) at most; the draw is one device's, heads and vocabulary
    padded by the mesh's "model" size."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator lies on {generator.device}, the "
                         f"model is asked for on {device}")
    if mesh is None:
        model = LM(cfg, tp, device)
        model.reset(generator)
        return model
    from repro_torch.launch.mesh import tp_size
    pol = policy or sh.ShardingPolicy()
    model = LM(cfg, max(tp, tp_size(mesh)), "meta")
    model.reset(generator, device,
                cut=lambda names: sh.shard_model(model, mesh, pol, names))
    return model


def model_par(model: nn.Module) -> sh.Par:
    """The mesh a model was cut for (``sharding.shard_model``), or
    ``sharding.LOCAL`` for one device's."""
    return getattr(model, "par", None) or sh.LOCAL


def embed_rows(model: LM, tokens: torch.Tensor,
               embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The embedding rows of ``tokens``, in the weights' dtype.  On a mesh
    the lookup is vocab-parallel: each model rank looks the tokens up in
    its block of the vocabulary (``embed``: that block with its FSDP
    blocks gathered; gathered here when not given), zeros the rows of
    tokens outside it, and the rows are summed over "model"."""
    par = model_par(model)
    if embed is None:
        embed = sh.gather_weight(model.embed, par.mesh, par.fs, 1)
    if par.tp is None:
        return F.embedding(tokens, embed)
    rows = embed.shape[0]
    local = tokens - par.tp_rank * rows
    inside = (local >= 0) & (local < rows)
    return par.from_tp(F.embedding(local.clamp(0, rows - 1), embed)
                       * inside[..., None].to(embed.dtype))


def param_stacks(cfg: ModelConfig, model: LM) -> List[Tuple[str, ...]]:
    """The names of the weights the reference stacks into one leaf, each
    group in superblock order: sub-layer j's weight of every superblock
    (``blocks/sub{j}``, ``blocks/cross{j}``) and each encoder weight over
    the encoder layers (``enc_blocks/sub0``)."""
    period = cfg.superblock_period()
    stacks = []
    for group, step in (("layers", period), ("cross", period),
                        ("enc_layers", 1)):
        mods = getattr(model, group)
        if mods is None:
            continue
        for j in range(step):
            for rest, _ in mods[j].named_parameters():
                stacks.append(tuple(f"{group}.{i}.{rest}"
                                    for i in range(j, len(mods), step)))
    return stacks


# ========================================================== block application
def _apply_ff(cfg: ModelConfig, blk: Block, x: torch.Tensor,
              aux: Optional[Dict[str, torch.Tensor]] = None,
              moe_par: Optional[sh.Par] = None) -> torch.Tensor:
    """The feed-forward half of a layer; with ``aux`` the MoE's
    load-balance and router z losses and its dropped share are added
    into it.  ``moe_par``: the MoE's mesh context when the batch is not
    split as the layer's ``par`` says (a decode step's)."""
    if blk.norm2 is None:
        return x
    h = L.rms_norm(x, blk.norm2, cfg.norm_eps)
    delta = None
    if blk.moe is not None:
        delta, routing = moe_mod.moe_apply(
            blk.moe, h, top_k=cfg.moe_top_k,
            capacity_factor=cfg.capacity_factor, par=moe_par)
        if aux is not None:
            a = moe_mod.moe_aux(routing, moe_par or blk.moe.par)
            aux["lb_loss"] = aux["lb_loss"] + a.load_balance_loss
            aux["z_loss"] = aux["z_loss"] + a.z_loss
            aux["dropped"] = aux["dropped"] + a.dropped_frac.detach()
    if blk.mlp is not None:
        m = blk.mlp(h)
        delta = m if delta is None else delta + m
    return x + delta


def _apply_cross(cfg: ModelConfig, cr: CrossAttention, x: torch.Tensor,
                 enc_k: torch.Tensor, enc_v: torch.Tensor,
                 lay: Optional[sh.DecodeLayout] = None) -> torch.Tensor:
    """Cross-attention against the cached encoder K/V: every slot of the
    cache, the zero tail past the encoder's length included (the
    reference attends there too, with ``kv_valid_len=None``); on a mesh
    (``lay``) every slot of one device's cache, not the padding past
    it."""
    h = L.rms_norm(x, cr.norm, cfg.norm_eps)
    q = cr.attn.q_proj(h)
    zeros = torch.zeros(x.shape[1], dtype=torch.long, device=x.device)
    if lay is None:
        ctx = L.attention(q, cr.attn.local_kv(enc_k),
                          cr.attn.local_kv(enc_v), zeros, None,
                          causal=False, q_chunk=1024)
    else:
        ctx = _attend_split(cr.attn, q, enc_k, enc_v, zeros, lay.cache_len,
                            False, lay)
    return x + cr.attn.out_proj(ctx)


def _attend_split(attn: L.Attention, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, q_positions: torch.Tensor, valid: int,
                  causal: bool, lay: sh.DecodeLayout) -> torch.Tensor:
    """Attention of this rank's query heads ``q`` against this rank's
    cache slots (``lay``): the queries of every head gathered over
    "model", the softmax combined over the sequence's ranks, and this
    rank's head block of the context kept."""
    par = attn.par
    heads = q.shape[2]
    if par.tp_size > 1:
        q = mesh_mod.all_gather_dim(q, par.mesh, par.tp, 2)
    ctx = L.attention(q, k, v, q_positions, valid, causal=causal,
                      q_chunk=1024, kv_positions=lay.kv_positions(q.device),
                      seq_group=lay.seq_group)
    if par.tp_size > 1:
        ctx = ctx.narrow(2, par.tp_rank * heads, heads)
    return ctx


def _cross_kv(cr: CrossAttention, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return L._proj_in(enc_out, cr.attn.wk), L._proj_in(enc_out, cr.attn.wv)


def _remat(fn, remat: bool, policy: str = "nothing"):
    """``fn`` checkpointed (its activations recomputed in the backward pass)
    when ``remat``: ``"nothing"`` saves nothing inside it, ``"dots"``
    saves the products with a weight (the reference's
    ``dots_with_no_batch_dims_saveable``: matmuls without batch
    dimensions, which torch runs as ``mm``; attention's and the MoE's
    batched products are recomputed)."""
    if not remat:
        return fn
    kwargs = {"use_reentrant": False}
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif policy != "nothing":
        raise ValueError(f"unknown remat policy {policy!r}")
    return functools.partial(ckpt.checkpoint, fn, **kwargs)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def encode(cfg: ModelConfig, model: LM, src_embeds: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """Encoder stack (bidirectional attention) over stub frame embeddings;
    ``remat`` checkpoints each layer (training)."""
    x = src_embeds.to(cfg.cdtype)
    positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def layer(i, x):
        blk = model.enc_layers[i]
        with _gathered(model, [f"enc_layers.{i}"]):
            h = L.rms_norm(x, blk.norm1, cfg.norm_eps)
            q, k, v = blk.attn.qkv_proj(h)
            k = blk.attn.local_kv(L.rotate(k, cos, sin))
            ctx = L.attention(L.rotate(q, cos, sin), k, blk.attn.local_kv(v),
                              positions, None, causal=False, q_chunk=4096)
            x = x + blk.attn.out_proj(ctx)
            return _apply_ff(cfg, blk, x)

    layer = _remat(layer, remat)
    for i in range(len(model.enc_layers)):
        x = layer(i, x)
    return L.rms_norm(x, model.enc_final_norm, cfg.norm_eps)


def _gathered(model: LM, prefixes: List[str]):
    """Context: the modules named ``prefixes`` of a sharded ``model`` with
    their FSDP blocks gathered over "data" (differentiably, so the
    backward pass reduce-scatters the gradients); nothing off a mesh."""
    par = model_par(model)
    if par.fs is None:
        return contextlib.nullcontext()
    tensors = {}
    for pre in prefixes:
        mod = model.get_submodule(pre)
        for n, t in sh.gather_layer(mod, par, model.specs, pre).items():
            tensors[f"{pre}.{n}"] = t
    return sh.swapped(model, tensors)


# ================================================================= training
def _apply_sub_train(cfg: ModelConfig, blk: Block, x: torch.Tensor,
                     rope, positions: torch.Tensor,
                     aux: Dict[str, torch.Tensor], q_chunk: int
                     ) -> torch.Tensor:
    h = L.rms_norm(x, blk.norm1, cfg.norm_eps)
    if blk.attn is not None:
        q, k, v = blk.attn.qkv_proj(h)
        k = blk.attn.local_kv(L.rotate(k, *rope))
        ctx = L.attention(L.rotate(q, *rope), k, blk.attn.local_kv(v),
                          positions, None, causal=True, q_chunk=q_chunk)
        x = x + blk.attn.out_proj(ctx)
    else:
        out, _ = ssm_mod.ssm_forward(blk.ssm, h,
                                     chunk=min(cfg.ssm_chunk, x.shape[1]))
        x = x + out
    return _apply_ff(cfg, blk, x, aux)


def _blocks_train(cfg: ModelConfig, model: LM, x: torch.Tensor,
                  q_chunk: int, enc_out: Optional[torch.Tensor],
                  remat: bool, remat_policy: str
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every layer, one superblock (``period`` layers) a checkpoint; the
    aux losses summed in a superblock, then over the superblocks (and the
    MoE layers' dropped shares, for the metrics).  On a mesh ``x`` comes
    and goes in the boundary layout (``sharding.shard_act_btd``), and a
    superblock gathers its layers' FSDP blocks inside its checkpoint."""
    period = cfg.superblock_period()
    par = model_par(model)
    seq = x.shape[1] * sh.act_seq_blocks(par)
    positions = torch.arange(seq, device=x.device)
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta) \
        if cfg.num_heads else None

    def superblock(s, x):
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"lb_loss": zero, "z_loss": zero, "dropped": zero}
        layers = range(s * period, (s + 1) * period)
        names = [f"layers.{i}" for i in layers] + (
            [f"cross.{i}" for i in layers] if enc_out is not None else [])
        x = sh.unshard_act_btd(x, par)
        with _gathered(model, names):
            for i in layers:
                x = _apply_sub_train(cfg, model.layers[i], x, rope,
                                     positions, aux, q_chunk)
                if enc_out is not None:
                    cr = model.cross[i]
                    x = _apply_cross(cfg, cr, x, *_cross_kv(cr, enc_out))
        x = sh.shard_act_btd(x, par)
        return x, aux["lb_loss"], aux["z_loss"], aux["dropped"]

    superblock = _remat(superblock, remat, remat_policy)
    lbs, zls, drops = [], [], []
    for s in range(cfg.num_layers // period):
        x, lb, zl, dr = superblock(s, x)
        lbs.append(lb)
        zls.append(zl)
        drops.append(dr)
    return x, {"lb_loss": torch.stack(lbs).sum(),
               "z_loss": torch.stack(zls).sum(),
               "dropped": torch.stack(drops).sum()}


def forward_train(cfg: ModelConfig, model: LM, batch: Dict[str, Any],
                  q_chunk: int = 1024, remat: bool = True,
                  remat_policy: str = "nothing"
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token (+ modality-stub) inputs -> (total loss, metrics): the masked
    mean cross-entropy over f32 logits (the vocabulary pad masked at
    -1e30, a vlm's patch prefix dropped before the head) plus
    ``aux_loss_weight``·lb + ``router_z_loss``·z of the MoE layers.
    ``batch``: ``tokens``, ``labels`` (B, S), ``loss_mask`` and, by
    family, ``patch_embeds`` or ``src_embeds``.  A sharded model takes
    this rank's rows of the batch (``sharding.batch_pspecs``) and returns
    the global batch's loss and metrics."""
    par = model_par(model)
    embed = sh.gather_weight(model.embed, par.mesh, par.fs, 1)  # (V_l, D)
    rows = embed.shape[0]
    v0 = par.tp_rank * rows            # this rank's first vocabulary row
    x = embed_rows(model, batch["tokens"], embed).to(cfg.cdtype)
    offset = 0
    if cfg.frontend == "vision":
        pe = par.to_tp(batch["patch_embeds"].to(cfg.cdtype)) @ \
            model.patch_proj                               # (B, P, D_l)
        pe = sh.gather_act(pe, par.mesh, par.tp, 2)
        x = torch.cat([pe, x], dim=1)
        offset = pe.shape[1]
    enc_out = encode(cfg, model, batch["src_embeds"], remat=remat) \
        if cfg.encoder_layers else None
    x, aux = _blocks_train(cfg, model, sh.shard_act_btd(x, par), q_chunk,
                           enc_out, remat, remat_policy)
    x = sh.shard_act_logits_input(x, par)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    if offset:
        x = x[:, offset:, :]
    head = embed if model.lm_head is None \
        else sh.gather_weight(model.lm_head, par.mesh, par.fs, 1)
    logits = (par.to_tp(x) @ head.T).float()    # bf16 product, (B, S, V_l)
    if par.tp_size * rows != cfg.vocab_size:               # mask vocab pad
        pad = v0 + torch.arange(rows, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, L.MASKED)
    # log-sum-exp over the vocabulary blocks: the max over "model", then
    # the blocks' sums of exp
    m = mesh_mod.all_reduce(logits.detach().amax(dim=-1), par.mesh, par.tp,
                            op="max") if par.tp_size > 1 else \
        logits.detach().amax(dim=-1)
    se = par.from_tp(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    logz = m + torch.log(se)
    lab = batch["labels"] - v0
    mine = (lab >= 0) & (lab < rows)
    gold = torch.gather(logits, -1,
                        lab.clamp(0, rows - 1).long()[..., None])[..., 0]
    gold = par.from_tp(torch.where(mine, gold, 0.0))
    mask = batch["loss_mask"].float()
    loss = par.dp_sum(torch.sum((logz - gold) * mask)) \
        / torch.clamp(par.dp_sum(torch.sum(mask)), min=1.0)
    return _total(cfg, loss, aux)


def _total(cfg: ModelConfig, loss: torch.Tensor,
           aux: Dict[str, torch.Tensor]
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    total = loss + cfg.aux_loss_weight * aux["lb_loss"] \
        + cfg.router_z_loss * aux["z_loss"]
    metrics = {"loss": loss, "lb_loss": aux["lb_loss"],
               "z_loss": aux["z_loss"]}
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    if n_moe:
        metrics["dropped_frac"] = aux["dropped"] / n_moe
    return total, metrics


# ================================================================= decoding
def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      tp: int = 1, dtype=None, device=None, mesh=None,
                      policy: Optional[sh.ShardingPolicy] = None) -> State:
    """Zeroed caches, one a layer, on ``device`` (the card unless the
    caller names another): ``{"pos": 0, "layers": [...], "cross": [...]
    (encoder-decoder only)}``.  With a ``mesh``: this rank's blocks of a
    decode state of ``batch`` rows (the global batch) under ``policy``,
    each allocated at its block's size, and the cut under ``"layout"``
    (``sharding.decode_layout``); heads are padded by the mesh's "model"
    size."""
    device = resolve_device(device)
    dt = dtype or cfg.pdtype
    lay = None
    if mesh is not None:
        from repro_torch.launch.mesh import tp_size
        tp = max(tp, tp_size(mesh))
        lay = sh.decode_layout(mesh, batch, cache_len, policy)

    def zeros(name, shape, dtype):
        if lay is not None:
            shape = lay.local_shape(name, shape)
        return torch.zeros(shape, dtype=dtype, device=device)
    kv_shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)

    def kv():
        return {"k": zeros("k", kv_shape, dt), "v": zeros("v", kv_shape, dt)}

    def ssm():
        h = cfg.padded_ssm_heads(tp)
        hd = cfg.d_inner // cfg.ssm_heads
        lb = cfg.ssm_conv_width - 1
        return {"ssm": zeros("ssm", (batch, h, hd, cfg.ssm_state),
                             torch.float32),
                "conv_x": zeros("conv_x", (batch, lb, h * hd), dt),
                "conv_bc": zeros("conv_bc", (batch, lb, 2 * cfg.ssm_state),
                                 dt)}

    state: State = {"pos": 0, "layers": [
        kv() if cfg.is_attn_layer(i) else ssm()
        for i in range(cfg.num_layers)]}
    if cfg.encoder_layers:
        state["cross"] = [kv() for _ in range(cfg.num_layers)]
    if lay is not None:
        state["layout"] = lay
    return state


def _apply_sub_step(cfg: ModelConfig, blk: Block, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor], pos: int,
                    rope: Tuple[torch.Tensor, torch.Tensor],
                    lay: Optional[sh.DecodeLayout] = None,
                    moe_par: Optional[sh.Par] = None,
                    aux: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """One layer on (B, S_new, D) with its cache read and written in place
    (S_new = 1 decode, or the whole prompt during prefill); on a mesh
    (``lay``) the cache holds this rank's slots."""
    h = L.rms_norm(x, blk.norm1, cfg.norm_eps)
    s_new = x.shape[1]
    if blk.attn is not None:
        q, k, v = blk.attn.qkv_proj(h)
        q, k = L.rotate(q, *rope), L.rotate(k, *rope)
        slot0, limit = (0, None) if lay is None else (lay.slot0,
                                                      lay.cache_len)
        k_cache = L.update_cache(cache["k"], k, pos, slot0, limit)
        v_cache = L.update_cache(cache["v"], v, pos, slot0, limit)
        positions = torch.arange(pos, pos + s_new, device=x.device)
        if lay is None:
            ctx = L.attention(q, k_cache, v_cache, positions, pos + s_new,
                              causal=True, q_chunk=1024)
        else:
            ctx = _attend_split(blk.attn, q, k_cache, v_cache, positions,
                                pos + s_new, True, lay)
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
    return _apply_ff(cfg, blk, x, aux, moe_par)


def _decode_moe_par(par: sh.Par, lay: Optional[sh.DecodeLayout]
                    ) -> Optional[sh.Par]:
    """The MoE's mesh context in a decode step: its batch is split over
    the layout's batch axes, which are the data axes only when the batch
    fills them."""
    if lay is None or tuple(lay.batch_axes) == tuple(par.dp):
        return None
    return dataclasses.replace(par, dp=tuple(lay.batch_axes))


def forward_step(cfg: ModelConfig, model: LM, tokens: torch.Tensor,
                 state: State, prefix_embeds: Optional[torch.Tensor] = None,
                 aux: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, State]:
    """Cache-carrying forward (prefill: tokens (B, S); decode: (B, 1)).
    Returns (f32 logits for the final position (B, V), the state), the
    state's caches and position updated in place.  On a mesh the model is
    a rank's blocks (``sharding.shard_model``), the state a rank's
    (``init_decode_state(mesh=)``), ``tokens`` and ``prefix_embeds`` the
    rank's rows of the batch, and the logits the rank's rows over the
    whole (padded) vocabulary.  With ``aux`` (``lb_loss``, ``z_loss``,
    ``dropped``) the MoE layers add their aux losses and dropped shares,
    of the global batch, into it."""
    par = model_par(model)
    lay = state.get("layout")
    pos = state["pos"]
    x = embed_rows(model, tokens).to(cfg.cdtype)
    if prefix_embeds is not None:
        pe = prefix_embeds.to(cfg.cdtype)
        if cfg.frontend == "vision":
            pe = sh.gather_act(par.to_tp(pe) @ model.patch_proj, par.mesh,
                               par.tp, 2)
        x = torch.cat([pe, x], dim=1)
    s_new = x.shape[1]
    rope = L.rope_tables(torch.arange(pos, pos + s_new, device=x.device),
                         cfg.head_dim, cfg.rope_theta) \
        if cfg.num_heads else None
    moe_par = _decode_moe_par(par, lay)
    for i, blk in enumerate(model.layers):
        names = [f"layers.{i}"] + ([f"cross.{i}"] if cfg.encoder_layers
                                   else [])
        with _gathered(model, names):
            x = _apply_sub_step(cfg, blk, x, state["layers"][i], pos, rope,
                                lay, moe_par, aux)
            if cfg.encoder_layers:    # cross K/V filled by fill_cross_caches
                ck = state["cross"][i]
                x = _apply_cross(cfg, model.cross[i], x, ck["k"], ck["v"],
                                 lay)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    head = sh.gather_weight(model.head, par.mesh, par.fs, 1)
    logits = (x[:, -1, :] @ head.T).float()        # (B, V_l)
    if par.tp_size > 1:
        logits = mesh_mod.all_gather_dim(logits, par.mesh, par.tp, 1)
    if logits.shape[1] != cfg.vocab_size:                   # mask vocab pad
        logits[:, cfg.vocab_size:] = L.MASKED
    state["pos"] = pos + s_new
    return logits, state


def fill_cross_caches(cfg: ModelConfig, model: LM, state: State,
                      enc_out: torch.Tensor) -> State:
    """Write every decoder layer's encoder K/V at slots [0, S_src) of its
    cross cache (in place; on a mesh the part that lands in the rank's
    slots)."""
    lay = state.get("layout")
    slot0, limit = (0, None) if lay is None else (lay.slot0, lay.cache_len)
    for i, (cr, ck) in enumerate(zip(model.cross, state["cross"])):
        with _gathered(model, [f"cross.{i}"]):
            k, v = _cross_kv(cr, enc_out)
        L.update_cache(ck["k"], k, 0, slot0, limit)
        L.update_cache(ck["v"], v, 0, slot0, limit)
    return state

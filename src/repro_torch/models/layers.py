"""Transformer building blocks: RMSNorm, RoPE, GQA attention (chunked,
cache-aware), SwiGLU MLP, and the KV cache write.

The port of ``repro.models.layers``.  bf16 compute with f32 norms and
softmax, as there: the attention logits and context are f32 products of
the (bf16) inputs, never rounded to bf16 (the reference's
``preferred_element_type=jnp.float32``), so q, k, the probabilities and v
are upcast for those two contractions on every device.

Attention is query-chunked: logits for one (B, H, q_chunk, T) tile at a
time, so the (S, S) score matrix is never materialized.  GQA keeps K/V at
``num_kv_heads`` and broadcasts inside the contraction.

On a mesh (``launch.sharding.shard_model`` sets each module's ``par``)
attention and the MLP are tensor-parallel over "model": ``wq``,
``w_gate`` and ``w_up`` column-parallel, ``wo`` and ``w_down``
row-parallel and summed over "model"; ``wk``/``wv`` replicated, each rank
taking the K/V heads its query heads read.  Off a mesh ``par`` is None.
A decode step on a mesh may split the cache's sequence over ranks:
:func:`attention` then combines the softmax over them and
:func:`update_cache` writes a rank's own slots.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

# masked logits: a large finite negative, as the reference (not -inf)
MASKED = -1e30


def _param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised serving weight (drawn by ``reset`` or copied in)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal_(w: torch.Tensor, gen: torch.Generator, scale: float
             ) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype) * scale``: a standard normal
    draw in the weight's dtype, scaled in that dtype."""
    return w.normal_(generator=gen).mul_(scale)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: x · 1/(1 + exp(−x)),
    each step rounded to x's dtype (``F.silu`` rounds once, an ulp away
    in bf16 at many entries, enough to move an MoE router)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (B|1, S, 1, hd/2) f32, of positions (B, S) or (S,):
    computed once a step and shared by q, k and every layer."""
    if positions.ndim == 1:
        positions = positions[None, :]
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * freqs               # (B, S, hd/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """Half-split (not interleaved) rotation of x (B, S, H, hd) in f32."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S) or (S,) -> rotated x."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def _scores_softmax_ctx(q5: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                        mask: torch.Tensor, v_dtype: torch.dtype,
                        seq_group=None) -> torch.Tensor:
    """q5 (B, Sq, KVH, G, hd); kf, vf (B, T, KVH, hd) f32; mask (1, Sq, T)
    -> f32 context like q5.  With ``seq_group`` = (mesh, axes) the T slots
    are this rank's share of the sequence: the row max, then the row sum
    of exp(s - max), then the context of the probabilities rounded to V's
    dtype are each summed (the max taken) over ``axes``, so the
    probabilities round as one device's softmax rounds them."""
    scale = float(1.0 / math.sqrt(q5.shape[-1]))
    logits = torch.einsum("bqkgd,btkd->bkgqt", q5.float(), kf) * scale
    logits = torch.where(mask[:, None, None, :, :], logits, MASKED)
    if seq_group is None:
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bkgqt,btkd->bqkgd", probs.to(v_dtype).float(),
                            vf)
    from repro_torch.core import mesh as mesh_mod
    mesh, axes = seq_group
    m = mesh_mod.all_reduce(logits.amax(dim=-1, keepdim=True), mesh, axes,
                            op="max")
    e = torch.exp(logits - m)
    denom = mesh_mod.all_reduce(e.sum(dim=-1, keepdim=True), mesh, axes)
    part = torch.einsum("bkgqt,btkd->bqkgd", (e / denom).to(v_dtype).float(),
                        vf)
    return mesh_mod.all_reduce(part, mesh, axes)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_positions: torch.Tensor, kv_valid_len: Optional[int], *,
              causal: bool, q_chunk: int = 1024,
              kv_positions: Optional[torch.Tensor] = None,
              seq_group=None) -> torch.Tensor:
    """Chunked GQA attention.

    q (B, Sq, H, hd); k, v (B, T, KVH, hd); q_positions (Sq,) absolute
    positions of the queries (for causal masking against cache slots);
    kv_valid_len: count of valid cache slots (None = all T).  Above
    ``q_chunk`` queries, Sq must be a multiple of it.  Returns
    (B, Sq, H, hd) in q's dtype.

    On a mesh whose ranks split the cache's sequence, ``kv_positions``
    (T,) holds the global slot index of each local slot and
    ``seq_group`` = (mesh, axes) the ranks the softmax is combined over
    (:func:`_scores_softmax_ctx`); every rank returns the whole context.
    """
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if sq > q_chunk and sq % q_chunk:
        raise ValueError(f"{sq} queries are not a multiple of q_chunk "
                         f"{q_chunk}")
    q5 = q.reshape(b, sq, kvh, h // kvh, hd)
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(t, device=q.device) if kv_positions is None \
        else kv_positions

    def mask_for(qpos):
        m = torch.ones((qpos.shape[0], t), dtype=torch.bool, device=q.device)
        if causal:
            m &= qpos[:, None] >= kv_pos[None, :]
        if kv_valid_len is not None:
            m &= kv_pos[None, :] < kv_valid_len
        return m[None]                                      # (1, Sq, T)

    step = min(sq, q_chunk)
    ctx = torch.cat([
        _scores_softmax_ctx(q5[:, i:i + step], kf, vf,
                            mask_for(q_positions[i:i + step]), v.dtype,
                            seq_group)
        for i in range(0, sq, step)], dim=1)
    return ctx.to(q.dtype).reshape(b, sq, h, hd)


class Attention(nn.Module):
    """Self- (or cross-) attention weights: wq (D, H, hd), wk/wv
    (D, KVH, hd), wo (H, hd, D), and qwen1.5's optional qkv biases.  H may
    exceed ``real_heads`` (TP padding): padded head slices are zero, so
    they contribute nothing through wo."""

    def __init__(self, d_model: int, heads: int, kv_heads: int,
                 head_dim: int, real_heads: int, *, bias: bool, dtype,
                 device=None):
        super().__init__()
        self.real_heads = real_heads
        self.par = None
        self.wq = _param((d_model, heads, head_dim), dtype, device)
        self.wk = _param((d_model, kv_heads, head_dim), dtype, device)
        self.wv = _param((d_model, kv_heads, head_dim), dtype, device)
        self.wo = _param((heads, head_dim, d_model), dtype, device)
        for name, hh in (("bq", heads), ("bk", kv_heads), ("bv", kv_heads)):
            self.register_parameter(
                name, _param((hh, head_dim), dtype, device) if bias else None)

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> None:
        d_model, heads, head_dim = self.wq.shape
        scale_in = float(1.0 / math.sqrt(d_model))
        _normal_(self.wq, gen, scale_in)
        _normal_(self.wk, gen, scale_in)
        _normal_(self.wv, gen, scale_in)
        _normal_(self.wo, gen, float(1.0 / math.sqrt(self.real_heads
                                                     * head_dim)))
        self.wq[:, self.real_heads:] = 0
        self.wo[self.real_heads:] = 0
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                b.zero_()

    def q_proj(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's query heads (all of them off a mesh)."""
        return _proj_in(x if self.par is None else self.par.to_tp(x),
                        self.wq)

    def qkv_proj(self, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q of this rank's heads; k and v of every KV head (see
        :meth:`local_kv`)."""
        q = self.q_proj(x)
        k, v = _proj_in(x, self.wk), _proj_in(x, self.wv)
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        return q, k, v

    def local_kv(self, k: torch.Tensor) -> torch.Tensor:
        """K (or V) (B, T, KVH, hd) narrowed to the KV heads this rank's
        query heads read, as many heads as make GQA's reshape in
        :func:`attention` pair them as the whole layer does: head h reads
        KV head h // G, G = H / KVH over the padded heads H.  The
        identity off a mesh."""
        par = self.par
        if par is None or par.tp is None:
            return k
        k = par.to_tp(k)
        hl, kvh = self.wq.shape[1], k.shape[2]
        heads = hl * par.tp_size
        if heads % kvh:
            raise ValueError(f"{heads} query heads do not group over {kvh} "
                             f"KV heads")
        g, start = heads // kvh, par.tp_rank * hl
        if hl % g == 0:
            return k[:, :, start // g:(start + hl) // g]
        if g % hl == 0:
            return k[:, :, start // g:start // g + 1]
        idx = torch.arange(start, start + hl, device=k.device) // g
        return k[:, :, idx]

    def out_proj(self, ctx: torch.Tensor) -> torch.Tensor:
        """"bshk,hkd->bsd"; on a mesh this rank's heads' share, summed
        over "model"."""
        b, s, h, hd = ctx.shape
        out = ctx.reshape(b, s, h * hd) @ self.wo.reshape(h * hd, -1)
        return out if self.par is None else self.par.from_tp(out)


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"bsd,dhk->bshk" as one matmul."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


class Mlp(nn.Module):
    """SwiGLU: w_gate, w_up (D, F), w_down (F, D)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.par = None
        self.w_gate = _param((d_model, d_ff), dtype, device)
        self.w_up = _param((d_model, d_ff), dtype, device)
        self.w_down = _param((d_ff, d_model), dtype, device)

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> None:
        d_model, d_ff = self.w_gate.shape
        si, so = float(1.0 / math.sqrt(d_model)), float(1.0 / math.sqrt(d_ff))
        _normal_(self.w_gate, gen, si)
        _normal_(self.w_up, gen, si)
        _normal_(self.w_down, gen, so)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.par is not None:
            x = self.par.to_tp(x)
        h = silu(x @ self.w_gate) * (x @ self.w_up)
        out = h @ self.w_down
        return out if self.par is None else self.par.from_tp(out)


def update_cache(cache: torch.Tensor, new: torch.Tensor, pos: int,
                 slot0: int = 0, limit: Optional[int] = None
                 ) -> torch.Tensor:
    """Write (B, Snew, KVH, hd) into cache (B, T, KVH, hd) at time ``pos``,
    in place.  Where the reference's ``dynamic_update_slice`` would clamp
    the start so the update fits (and overwrite earlier slots), this
    raises.  On a rank that holds slots [``slot0``, ``slot0 + T``) of a
    cache of ``limit`` slots (``launch.sharding.DecodeLayout``) only the
    part of the span that lands there is written."""
    s_new, t = new.shape[1], cache.shape[1]
    limit = t if limit is None else limit
    if pos < 0 or pos + s_new > limit:
        raise ValueError(f"cache of {limit} slots cannot take {s_new} at "
                         f"position {pos}")
    lo, hi = max(pos, slot0), min(pos + s_new, slot0 + t)
    if lo < hi:
        cache[:, lo - slot0:hi - slot0] = new[:, lo - pos:hi - pos].to(
            cache.dtype)
    return cache

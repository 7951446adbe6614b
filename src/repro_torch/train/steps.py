"""Serving step factories (the port of ``repro.train.steps``, serving half):

* ``make_prefill_step`` — prompt → filled caches + first-token logits;
* ``make_decode_step``  — one token against the cache (+ SSM states).

Plain callables, run without autograd on the model's device.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, cache_len: int, tp: int = 1
                      ) -> Callable:
    """``prefill(model, batch) -> (logits (B, V), decode_state)``; ``batch``
    holds ``tokens`` (B, S) and, by family, ``patch_embeds`` (vlm) or
    ``src_embeds`` (encoder-decoder)."""

    @torch.inference_mode()
    def prefill(model: model_mod.LM, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        state = model_mod.init_decode_state(cfg, tokens.shape[0], cache_len,
                                            tp=tp, device=tokens.device)
        prefix = batch.get("patch_embeds") if cfg.frontend == "vision" \
            else None
        if cfg.encoder_layers:
            enc_out = model_mod.encode(cfg, model, batch["src_embeds"])
            state = model_mod.fill_cross_caches(cfg, model, state, enc_out)
        return model_mod.forward_step(cfg, model, tokens, state,
                                      prefix_embeds=prefix)

    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``decode(model, token (B, 1), state) -> (logits, state)``: one new
    token against the existing KV/SSM caches, written in place."""

    @torch.inference_mode()
    def decode(model: model_mod.LM, token: torch.Tensor, state):
        return model_mod.forward_step(cfg, model, token, state)

    return decode

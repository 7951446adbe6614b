"""Serving launcher of the LM stack: batched prefill + decode loop with
KV/SSM caches.  The port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
        --smoke --batch 8 --prompt-len 64 --gen 32 [--device cpu]

Runs on the card unless ``--device`` names another device.  Weights are
drawn from a seed on the serving device, the prompt from a CPU generator
(the same prompt on every device), and temperature sampling from a
generator on the device.  Greedy decoding (temperature 0) takes the
argmax, first index among ties, as the reference.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig
from repro_torch.train.steps import make_decode_step, make_prefill_step


class ServeResult(NamedTuple):
    tokens: torch.Tensor        # (B, gen) generated tokens, int64
    logits: List[torch.Tensor]  # (B, V) f32: the prefill's, then each step's
    pos: int                    # the decode state's final position
    prefill_ms: float
    decode_ms: List[float]      # each decode step, sampling included


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int,
               generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Prompt tokens and, by family, stub patch or frame embeddings (drawn
    on ``generator``'s device, then moved to ``device``)."""
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=generator)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = 0.02 * torch.randn(
            (batch, cfg.num_prefix, cfg.d_model), generator=generator,
            dtype=cfg.pdtype)
    if cfg.encoder_layers:
        out["src_embeds"] = 0.02 * torch.randn(
            (batch, prompt_len, cfg.d_model), generator=generator,
            dtype=cfg.pdtype)
    return {k: v.to(device) for k, v in out.items()}


def serve(cfg: ModelConfig, batch: int = 8, prompt_len: int = 64,
          gen: int = 32, temperature: float = 0.0, seed: int = 0,
          device=None, model: Optional[model_mod.LM] = None) -> ServeResult:
    """Prefill a seeded prompt, then ``gen - 1`` decode steps: ``gen`` new
    tokens a sequence.  ``model`` defaults to weights drawn from ``seed``
    on ``device`` (the card unless the caller names another).  The cache
    holds the prompt, a vlm's patch prefix and the generated tokens."""
    dev = resolve_device(device)
    if model is None:
        model = model_mod.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    prompt = make_batch(cfg, batch, prompt_len,
                        torch.Generator().manual_seed(seed + 1), dev)
    sampler = torch.Generator(device=dev).manual_seed(seed + 2)
    prefix = cfg.num_prefix if cfg.frontend == "vision" else 0
    prefill = make_prefill_step(cfg, prefix + prompt_len + gen)
    decode = make_decode_step(cfg)

    def sample(logits):
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=sampler)[:, 0]

    if dev.type == "cuda":
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def span(a, b):
            return a.elapsed_time(b)
    else:
        mark = time.perf_counter

        def span(a, b):
            return (b - a) * 1e3

    t0 = mark()
    logits, state = prefill(model, prompt)
    t1 = mark()
    all_logits = [logits]
    toks = [sample(logits)]
    marks = [mark()]
    for _ in range(gen - 1):
        logits, state = decode(model, toks[-1][:, None], state)
        toks.append(sample(logits))
        all_logits.append(logits)
        marks.append(mark())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return ServeResult(
        tokens=torch.stack(toks, dim=1), logits=all_logits, pos=state["pos"],
        prefill_ms=span(t0, t1),
        decode_ms=[span(a, b) for a, b in zip(marks, marks[1:])])


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    res = serve(cfg, args.batch, args.prompt_len, args.gen,
                args.temperature, device=args.device)
    steps = len(res.decode_ms)
    dt = sum(res.decode_ms) / 1e3
    print(f"[prefill] {args.batch}x{args.prompt_len} {res.prefill_ms:.0f} ms")
    print(f"[decode] {steps} steps, {dt * 1e3 / max(steps, 1):.1f} ms/token, "
          f"{args.batch * steps / max(dt, 1e-9):.0f} tok/s aggregate")
    return res


if __name__ == "__main__":
    main()

"""Serving launcher of the LM stack: batched prefill + decode loop with
KV/SSM caches.  The port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
        --smoke --batch 8 --prompt-len 64 --gen 32 [--device cpu] \
        [--mesh 2,2 [--host-devices 4]]

Runs on the card unless ``--device`` names another device.  Weights are
drawn from a seed on the serving device, the prompt from a CPU generator
(the same prompt on every device), and temperature sampling from a
generator on the device.  Greedy decoding (temperature 0) takes the
argmax, first index among ties, as the reference.

``--mesh`` serves on a mesh of that comma shape, its dimensions named
``("pod", "data", "model")[-len:]``, one process a rank, under the rules
of ``launch/train.py --mesh`` (``launch.mesh.spawn_ranks``): with
``--host-devices N`` N CPU ranks on gloo (``--device cpu``), otherwise a
card a rank on nccl.  Each rank draws its blocks of the weights
(``init_params(mesh=)``), takes its rows of the prompt and holds its
blocks of the caches (``init_decode_state(mesh=)``); rank 0 prints.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core import mesh as mesh_mod
from repro_torch.core.device import resolve_device
from repro_torch.launch import sharding as sh
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
          device=None, model: Optional[model_mod.LM] = None, mesh=None,
          policy: Optional[sh.ShardingPolicy] = None) -> ServeResult:
    """Prefill a seeded prompt, then ``gen - 1`` decode steps: ``gen`` new
    tokens a sequence.  ``model`` defaults to weights drawn from ``seed``
    on ``device`` (the card unless the caller names another).  The cache
    holds the prompt, a vlm's patch prefix and the generated tokens.

    With a ``mesh`` every rank calls this: the weights are cut to the
    rank's blocks at the draw, the rank decodes its rows of the batch
    (``sharding.decode_layout``), and the tokens and logits it returns
    are the whole batch's, gathered over the batch's axes."""
    dev = resolve_device(device)
    if model is None:
        model = model_mod.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
            mesh=mesh, policy=policy)
    prompt = make_batch(cfg, batch, prompt_len,
                        torch.Generator().manual_seed(seed + 1), dev)
    sampler = torch.Generator(device=dev).manual_seed(seed + 2)
    prefix = cfg.num_prefix if cfg.frontend == "vision" else 0
    prefill = make_prefill_step(cfg, prefix + prompt_len + gen, mesh=mesh,
                                policy=policy)
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
    tokens = torch.stack(toks, dim=1)
    lay = state.get("layout")
    if lay is not None and lay.batch_axes:
        tokens = mesh_mod.all_gather_dim(tokens, mesh, lay.batch_axes, 0)
        all_logits = [mesh_mod.all_gather_dim(lg, mesh, lay.batch_axes, 0)
                      for lg in all_logits]
    return ServeResult(
        tokens=tokens, logits=all_logits, pos=state["pos"],
        prefill_ms=span(t0, t1),
        decode_ms=[span(a, b) for a, b in zip(marks, marks[1:])])


def _report(args, res: ServeResult) -> None:
    steps = len(res.decode_ms)
    dt = sum(res.decode_ms) / 1e3
    print(f"[prefill] {args.batch}x{args.prompt_len} {res.prefill_ms:.0f} ms")
    print(f"[decode] {steps} steps, {dt * 1e3 / max(steps, 1):.1f} ms/token, "
          f"{args.batch * steps / max(dt, 1e-9):.0f} tok/s aggregate",
          flush=True)


def _rank_main(rank: int, dev, mesh, args) -> None:
    """One rank of a ``--mesh`` run (``launch.mesh.spawn_ranks``)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if rank == 0:
        print(f"[mesh] {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
              f"{'gloo' if dev.type == 'cpu' else 'nccl'}")
    res = serve(cfg, args.batch, args.prompt_len, args.gen,
                args.temperature, device=dev, mesh=mesh)
    if rank == 0:
        _report(args, res)


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
    ap.add_argument("--mesh", default="",
                    help="comma shape, e.g. 2,2 -> (data,model); empty = "
                         "single device")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="CPU ranks on gloo for the mesh (with --device "
                         "cpu); default: one card a rank")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.mesh:
        from repro_torch.launch.mesh import spawn_ranks
        spawn_ranks(_rank_main, args.mesh, args.host_devices, dev, (args,))
        return None
    if args.host_devices:
        raise ValueError("--host-devices needs --mesh")
    cfg = get_config(args.arch, smoke=args.smoke)
    res = serve(cfg, args.batch, args.prompt_len, args.gen,
                args.temperature, device=dev)
    _report(args, res)
    return res

if __name__ == "__main__":
    main()

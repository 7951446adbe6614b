"""Shared helpers of the tests/test_torch_lm_*.py parity tests: one seeded
numpy prompt and the reference's ``init_params`` weights, run through the
JAX reference's serving steps and, carried by
``carry.lm_params_from_numpy``, through the port's."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as ref_model
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch.carry import lm_params_from_numpy
from repro_torch.carry import tensor_from_numpy as to_torch  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.train.steps import make_decode_step, make_prefill_step

BATCH, PROMPT, STEPS = 2, 32, 3
# f32: the port against the reference, each on the CPU (measured: ≤ 1.2e-6
# on logits of magnitude ~0.5); bf16: the reference's own bar
# (tests/test_models_smoke.py::test_decode_matches_prefill_logits)
F32_TOL = 1e-5
BF16_TOL = 2e-2


def configs(arch: str, dtype: str):
    """(reference, port) SMOKE configs of ``arch`` in ``dtype``."""
    def cast(c):
        return dataclasses.replace(c, param_dtype=dtype, compute_dtype=dtype)
    return cast(ref_config(arch, smoke=True)), cast(get_config(arch, smoke=True))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def lm_inputs(cfg, seed: int, batch: int = BATCH, prompt: int = PROMPT):
    """Seeded numpy prompt: int32 tokens and, by family, f32 stub patch or
    frame embeddings (scale 0.02, as ``launch/serve.py`` draws them)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt)
                                  ).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = (0.02 * rng.standard_normal(
            (batch, cfg.num_prefix, cfg.d_model))).astype(np.float32)
    if cfg.encoder_layers:
        out["src_embeds"] = (0.02 * rng.standard_normal(
            (batch, prompt, cfg.d_model))).astype(np.float32)
    return out


def ref_batch(rc, inputs):
    return {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, rc.pdtype)
            for k, v in inputs.items()}


def port_batch(pc, inputs, device="cpu"):
    return {k: (torch.from_numpy(v.astype(np.int64)) if k == "tokens"
                else torch.from_numpy(v).to(pc.pdtype)).to(device)
            for k, v in inputs.items()}


def cache_len(cfg, prompt: int = PROMPT, steps: int = STEPS) -> int:
    return prompt + steps + 1 + (cfg.num_prefix if cfg.frontend == "vision"
                                 else 0)


def ref_jit(fn, *args, excess_precision: bool = False):
    """``fn`` jitted for ``args``, by default with XLA's excess precision
    off: each bf16 op rounds to bf16, as the reference's code says and as
    its op-by-op run gives (bit for bit on the LM's serving steps).  With
    it on (``jax.jit``'s default, as ``repro.launch.serve`` runs), XLA
    keeps a bf16 result in f32 where an f32 cast reads it (the residual
    sum an rms_norm upcasts, a projection RoPE or the router upcasts)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": excess_precision})


def twin_run(arch: str, dtype: str, seed: int = 0, steps: int = STEPS,
             cache: int = 0, tp: int = 1, excess_precision: bool = False):
    """Prefill plus ``steps`` greedy decode steps through the reference
    (:func:`ref_jit`) and the port, both fed the reference's greedy tokens.
    Returns (reference logits, port logits, reference tokens, port
    tokens): lists of numpy arrays, one a step."""
    rc, pc = configs(arch, dtype)
    params = ref_model.init_params(jax.random.key(seed), rc, tp=tp)
    model = lm_params_from_numpy(pc, jax.tree.map(np.asarray, params), tp=tp)
    inputs = lm_inputs(rc, seed + 100)
    cache = cache or cache_len(rc, steps=steps)
    rb = ref_batch(rc, inputs)
    rl, rs = ref_jit(ref_prefill_step(rc, cache, tp=tp), params, rb,
                     excess_precision=excess_precision)(params, rb)
    pl, ps = make_prefill_step(pc, cache, tp=tp)(model, port_batch(pc, inputs))
    r_dec, p_dec = None, make_decode_step(pc)
    ref, port, rtok, ptok = [], [], [], []
    for i in range(steps + 1):
        ref.append(np.asarray(rl, np.float32))
        port.append(to_numpy(pl))
        rtok.append(np.argmax(ref[-1], -1))
        ptok.append(to_numpy(torch.argmax(pl, -1)).astype(np.int64))
        if i == steps:
            break
        tok = jnp.asarray(rtok[-1].astype(np.int32)[:, None])
        r_dec = r_dec or ref_jit(ref_decode_step(rc), params, tok, rs,
                                 excess_precision=excess_precision)
        rl, rs = r_dec(params, tok, rs)
        pl, ps = p_dec(model, torch.from_numpy(np.asarray(tok, np.int64)), ps)
    assert int(rs["pos"]) == ps["pos"]
    return ref, port, rtok, ptok


# ------------------------------------------------------------- training
def train_inputs(cfg, seed: int, batch: int = BATCH, seq: int = 16):
    """Seeded numpy training batch: tokens, labels, a loss mask with a few
    zeros, and by family the stub patch or frame embeddings."""
    rng = np.random.default_rng(seed)
    out = lm_inputs(cfg, seed, batch, seq)
    out["labels"] = rng.integers(0, cfg.vocab_size, (batch, seq)
                                 ).astype(np.int32)
    mask = np.ones((batch, seq), np.float32)
    mask[:, :2] = 0.0
    out["loss_mask"] = mask
    return out


def ref_train_batch(rc, inputs):
    return {k: jnp.asarray(v) if k in ("tokens", "labels", "loss_mask")
            else jnp.asarray(v, rc.pdtype) for k, v in inputs.items()}


def port_train_batch(pc, inputs, device="cpu"):
    return {k: (torch.from_numpy(v.astype(np.int64)) if k in ("tokens",
                                                              "labels")
                else torch.from_numpy(v) if k == "loss_mask"
                else torch.from_numpy(v).to(pc.pdtype)).to(device)
            for k, v in inputs.items()}


def ref_leaves(pc, tree, model) -> dict:
    """A params-shaped reference pytree (numpy leaves) as {port name: the
    leaf's slice for that weight}, f32."""
    from repro_torch.carry import ref_leaf
    return {n: np.asarray(ref_leaf(pc, tree, n, p.shape), np.float32)
            for n, p in model.named_parameters()}


def ref_params_from_port(rc, pc, model, tp: int = 1):
    """The reference's ``init_params`` pytree (its structure from
    ``jax.eval_shape``, heads and vocabulary padded for ``tp``) holding
    the port model's weights: drawing with torch and carrying them over
    costs a fraction of the reference's own eager draw."""
    from repro_torch.carry import ref_leaf
    shapes = jax.eval_shape(lambda: ref_model.init_params(jax.random.key(0),
                                                          rc, tp=tp))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    for name, p in model.named_parameters():
        view = ref_leaf(pc, tree, name, p.shape)
        src = p.detach()
        if src.dtype == torch.bfloat16:
            view.view(np.int16)[...] = src.view(torch.int16).numpy()
        else:
            view[...] = src.numpy()
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """SMOKE-sized torch steps are bound by their launches: one intra-op
    thread (restored after the test) keeps them from slowing down many
    times over when other processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""The LM model of the port (repro_torch.models.model, train.steps) against
the JAX reference: each architecture's SMOKE config in f32 through prefill
and greedy decode steps, TP padding, the cross-attention's zero tail and
the cache's bounds."""
import jax
import numpy as np
import pytest
import torch

from _torch_lm_parity import (F32_TOL, PROMPT, configs, lm_inputs,
                              port_batch, to_numpy, twin_run)
from repro.configs import ARCH_IDS
from repro.models import model as ref_model
from repro_torch.carry import lm_params_from_numpy
from repro_torch.models import model as model_mod
from repro_torch.train.steps import make_decode_step, make_prefill_step


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode_f32_matches_reference(arch):
    """Prefill and 3 greedy decode steps: logits within F32_TOL of the
    reference's and the same greedy tokens at every step."""
    ref, port, rtok, ptok = twin_run(arch, "float32")
    for r, p, rt, pt in zip(ref, port, rtok, ptok):
        np.testing.assert_allclose(p, r, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(pt, rt)


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "mamba2-130m"])
def test_tp_padding_matches_reference(arch):
    """tp = 3 pads query heads (7 → 9), SSD heads (8 → 9) and the vocab
    (256 → 258, masked to -1e30) as the reference does; the zeroed heads
    change nothing, and the padded logits stay masked."""
    ref, port, rtok, ptok = twin_run(arch, "float32", steps=1, tp=3)
    for r, p in zip(ref, port):
        assert p.shape == (2, 258)
        np.testing.assert_array_equal(p[:, 256:], np.float32(-1e30))
        np.testing.assert_allclose(p, r, rtol=F32_TOL, atol=F32_TOL)


def test_cross_attention_attends_the_zero_tail_as_the_reference():
    """The decoder's cross-attention reads every slot of its cache, the
    zeros past the encoder's length included (``kv_valid_len=None``): a
    longer cache changes the logits, in the reference and in the port
    alike."""
    arch = "seamless-m4t-large-v2"
    short = twin_run(arch, "float32", steps=1, cache=PROMPT + 2)
    long = twin_run(arch, "float32", steps=1, cache=4 * PROMPT)
    for ref, port, _, _ in (short, long):
        for r, p in zip(ref, port):
            np.testing.assert_allclose(p, r, rtol=F32_TOL, atol=F32_TOL)
    assert np.abs(short[0][0] - long[0][0]).max() > 1e-3
    assert np.abs(short[1][0] - long[1][0]).max() > 1e-3


def test_decode_past_the_cache_raises():
    """The reference's ``dynamic_update_slice`` clamps a write past the
    cache's end onto its last slots; the port refuses it."""
    _, pc = configs("tinyllama-1.1b", "float32")
    model = model_mod.init_params(pc, torch.Generator().manual_seed(0),
                                  device="cpu")
    batch = port_batch(pc, lm_inputs(pc, 1, prompt=8))
    logits, state = make_prefill_step(pc, 9)(model, batch)
    decode = make_decode_step(pc)
    tok = torch.argmax(logits, -1)[:, None]
    logits, state = decode(model, tok, state)
    assert state["pos"] == 9
    with pytest.raises(ValueError, match="cannot take 1 at position 9"):
        decode(model, tok, state)
    with pytest.raises(ValueError):
        make_prefill_step(pc, 7)(model, batch)


def test_teacher_forced_decode_matches_prefill():
    """Prefill over 7 tokens then one decode step equals prefill over 8
    (the reference's test_decode_matches_prefill_logits, in the port, at
    its bar)."""
    _, pc = configs("tinyllama-1.1b", "bfloat16")
    model = model_mod.init_params(pc, torch.Generator().manual_seed(0),
                                  device="cpu")
    tokens = torch.from_numpy(lm_inputs(pc, 1, batch=1, prompt=8)["tokens"]
                              ).long()
    prefill = make_prefill_step(pc, 16)
    full, _ = prefill(model, {"tokens": tokens})
    _, st = prefill(model, {"tokens": tokens[:, :7]})
    step, _ = make_decode_step(pc)(model, tokens[:, 7:8], st)
    np.testing.assert_allclose(to_numpy(step), to_numpy(full), rtol=2e-2,
                               atol=2e-2)


def test_lm_params_from_numpy_maps_every_leaf():
    """Every leaf of the reference's pytree lands in the port parameter of
    the same name and size (jamba: period 8, attention, Mamba2, MoE and
    MLP sub-layers), bf16 bits unchanged."""
    rc, pc = configs("jamba-v0.1-52b", "bfloat16")
    tree = jax.tree.map(np.asarray, ref_model.init_params(
        jax.random.key(0), rc))
    model = lm_params_from_numpy(pc, tree)
    leaves = jax.tree.leaves(tree)
    assert sum(a.size for a in leaves) == sum(
        p.numel() for p in model.parameters())
    assert sum(float(np.abs(a.astype(np.float64)).sum()) for a in leaves) \
        == pytest.approx(sum(float(p.double().abs().sum())
                             for p in model.parameters()), rel=1e-12)
    attn = model.layers[4].attn         # superblock 0, sub-layer 4
    np.testing.assert_array_equal(
        to_numpy(attn.wq), tree["blocks"]["sub4"]["attn"].wq[0].astype(
            np.float32))
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[1].moe.router.dtype == torch.float32


def test_model_and_state_go_to_the_card_unless_told_otherwise():
    """``LM``, ``init_params`` and ``init_decode_state`` ask for the card
    when no device is named, and without CUDA raise instead of building on
    the CPU; ``init_params`` refuses a generator on another device than
    the model's."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    _, pc = configs("tinyllama-1.1b", "float32")
    for build in (lambda: model_mod.LM(pc),
                  lambda: model_mod.init_params(
                      pc, torch.Generator().manual_seed(0)),
                  lambda: model_mod.init_decode_state(pc, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    with pytest.raises(ValueError, match="generator lies on cpu"):
        model_mod.init_params(pc, torch.Generator(), device="meta")
    assert model_mod.LM(pc, device="cpu").embed.device.type == "cpu"
    state = model_mod.init_decode_state(pc, 1, 8, device="cpu")
    assert state["layers"][0]["k"].device.type == "cpu"

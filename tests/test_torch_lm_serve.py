"""The LM stack's serving path in the port against the JAX reference: each
architecture's SMOKE config in bf16 through prefill and greedy decode
steps, and ``repro_torch.launch.serve`` end to end on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import BF16_TOL, configs, to_numpy, twin_run
from repro.configs import ARCH_IDS
from repro.models import model as ref_model
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch.carry import lm_params_from_numpy
from repro_torch.launch import serve as serve_mod


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode_bf16_matches_reference(arch):
    """Prefill and 3 decode steps in bf16 (both fed the reference's greedy
    tokens): logits within the reference's bar of 2e-2.  The reference
    rounds each bf16 op (``_torch_lm_parity.ref_jit``); jitted with XLA's
    excess precision on, its own logits differ from that by an ulp here
    and there, which the MoE router's top-k can turn into another
    expert."""
    ref, port, _, _ = twin_run(arch, "bfloat16")
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p, r, rtol=BF16_TOL, atol=BF16_TOL)


def test_dense_bf16_matches_the_default_jit_reference():
    """The port follows the reference's op-by-op bf16 rounding; jitted as
    ``repro.launch.serve`` jits it (XLA's excess precision on), a dense
    model without a router still agrees within the reference's bar of
    2e-2 over prefill and 3 decode steps."""
    ref, port, _, _ = twin_run("llama3.2-3b", "bfloat16",
                               excess_precision=True)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p, r, rtol=BF16_TOL, atol=BF16_TOL)


def test_serve_greedy_tokens_match_reference():
    """``serve`` on the reference's weights (f32): the same tokens as the
    reference's prefill and greedy decode loop over the same prompt."""
    rc, pc = configs("llama3.2-3b", "float32")
    params = ref_model.init_params(jax.random.key(0), rc)
    model = lm_params_from_numpy(pc, jax.tree.map(np.asarray, params))
    res = serve_mod.serve(pc, batch=2, prompt_len=12, gen=6, seed=3,
                          device="cpu", model=model)
    prompt = serve_mod.make_batch(pc, 2, 12, torch.Generator().manual_seed(4),
                                  "cpu")
    logits, state = jax.jit(ref_prefill_step(rc, 12 + 6))(
        params, {"tokens": jnp.asarray(prompt["tokens"].numpy(), jnp.int32)})
    decode = jax.jit(ref_decode_step(rc))
    toks = [jnp.argmax(logits, -1)]
    for _ in range(5):
        logits, state = decode(params, toks[-1][:, None].astype(jnp.int32),
                               state)
        toks.append(jnp.argmax(logits, -1))
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.stack([np.asarray(t) for t in toks], 1))
    assert res.pos == int(state["pos"]) == 12 + 5


def test_serve_main_smoke_on_cpu(capsys):
    """``main`` end to end: prefill, gen − 1 decode steps, finite logits,
    the timing lines."""
    res = serve_mod.main(["--arch", "tinyllama-1.1b", "--smoke", "--device",
                          "cpu", "--batch", "2", "--prompt-len", "16",
                          "--gen", "5"])
    assert res.tokens.shape == (2, 5) and res.pos == 16 + 4
    assert len(res.logits) == 5 and len(res.decode_ms) == 4
    for lg, tok in zip(res.logits, res.tokens.T):
        assert torch.isfinite(lg).all()
        assert torch.equal(torch.argmax(lg, -1), tok)
    out = capsys.readouterr().out
    assert "[prefill] 2x16" in out and "[decode] 4 steps" in out


@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-large-v2",
                                  "jamba-v0.1-52b"])
def test_serve_families_on_cpu(arch):
    """A vlm's cache holds its patch prefix too (the reference's serve sizes
    it prompt + gen, and its last decode steps clamp onto earlier slots);
    the encoder-decoder and the hybrid serve with temperature sampling,
    the same draw from the same seed."""
    cfg = configs(arch, "bfloat16")[1]
    runs = [serve_mod.serve(cfg, batch=2, prompt_len=16, gen=12,
                            temperature=1.0, seed=5, device="cpu")
            for _ in range(2)]
    prefix = cfg.num_prefix if cfg.frontend == "vision" else 0
    assert runs[0].pos == prefix + 16 + 11
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert all(torch.isfinite(lg).all() for lg in runs[0].logits)


def test_serve_runs_on_the_card_unless_told_otherwise():
    """Without ``--device`` the launcher asks for the card, and without CUDA
    it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    cfg = configs("tinyllama-1.1b", "float32")[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--arch", "tinyllama-1.1b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.serve(cfg, batch=1, prompt_len=4, gen=2)
    assert to_numpy(serve_mod.serve(cfg, batch=1, prompt_len=4, gen=2,
                                    device="cpu").tokens).shape == (1, 2)

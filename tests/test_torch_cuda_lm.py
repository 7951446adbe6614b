"""The LM stack's serving path on the card.  Every test needs an NVIDIA GPU
(marker ``cuda``) and skips without one; this file imports neither jax nor
the reference.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm.py
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve
from repro_torch.models import model as model_mod
from repro_torch.models import moe


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's own runs")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _chip_smoke():
    """chip_smoke.py, beside tests/, whose phase ``lm`` holds the twin
    check these tests run."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_config_on_the_card_matches_the_cpu(card, arch):
    """chip_smoke's twin check: f32, TF32 off, the same weights (drawn on
    the CPU) and prompt give logits within its LM_TWIN_TOL (1e-4) on the
    card and the CPU, and the same greedy tokens, over prefill and 4
    decode steps."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="float32", compute_dtype="float32")
    _chip_smoke().lm_twin(arch + " SMOKE", cfg, 2, 32, 4, card)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-v0.1-52b",
                                  "qwen3-moe-235b-a22b"])
def test_repeated_decode_gives_the_same_bits(card, arch):
    """bf16 ``serve`` twice on one model: equal greedy tokens and logits bit
    for bit."""
    cfg = get_config(arch, smoke=True)
    model = model_mod.init_params(
        cfg, torch.Generator(device=card).manual_seed(0), device=card)
    a, b = (serve.serve(cfg, batch=4, prompt_len=64, gen=16, device=card,
                        model=model) for _ in range(2))
    assert torch.equal(a.tokens, b.tokens)
    assert all(torch.equal(x, y) for x, y in zip(a.logits, b.logits))


@pytest.mark.cuda
def test_bf16_moe_combine_is_deterministic_at_top_k_8(card):
    """qwen3-moe's top-k of 8 on 128 experts, bf16: the ordered combine
    gives the same bits on every run (an ``index_add_`` of bf16 rows adds
    in whatever order its atomics land)."""
    g = torch.Generator(device=card).manual_seed(0)
    p = moe.Moe(512, 128, 256, torch.bfloat16, card)
    p.reset(g)
    x = torch.randn((4, 256, 512), generator=g, device=card,
                    dtype=torch.bfloat16)
    outs = [moe.moe_apply(p, x, top_k=8)[0] for _ in range(5)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.isfinite(outs[0].float()).all()

"""The LM stack's training path on the card.  Every test needs an NVIDIA
GPU (marker ``cuda``) and skips without one; this file imports neither
jax nor the reference.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm_train.py
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import prng, sketch
from repro_torch.data.synthetic import zipf_token_stream
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import sketch_update as su
from repro_torch.optim import sketch_compress as sc
from repro_torch.train.steps import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's own runs")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _chip_smoke():
    """chip_smoke.py, beside tests/, whose phase ``train`` holds the twin
    check these tests run."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_weighted_k7_matches_float64_across_a_chunk_boundary(card,
                                                             monkeypatch):
    """The dense-vector sketch on the card in chunks of 1 000 (K7, one
    launch a chunk, weighted f32 values): the table within
    1e-5·max|table| of the float64 plain version, and K8's estimate of
    every coordinate (one launch a chunk, each writing its slice) equal
    to the plain estimate of that table by int32 view."""
    monkeypatch.setattr(sketch, "TENSOR_CHUNK", 1000)
    g = torch.randn(4500, generator=torch.Generator().manual_seed(0))
    sk0 = sc.make_sketch(sc.SketchCompressConfig(rows=8, log2_cols=10),
                         card)
    LAUNCHES.clear()
    sk = sketch.tensor_sketch_update(sk0, g.to(card))
    est = sketch.tensor_sketch_estimate(sk, 4500)
    torch.cuda.synchronize()
    assert LAUNCHES["sketch_update_table"] == 5
    assert LAUNCHES["sketch_estimate_table"] == 5
    lo = torch.arange(4500, device=card)
    t64 = su.sketch_update_torch(
        torch.zeros(sk.table.shape, dtype=torch.float64, device=card),
        sk.params, torch.zeros_like(lo), lo, g.double().to(card))
    scale = float(t64.abs().max())
    assert float((sk.table.double() - t64).abs().max()) <= 1e-5 * scale
    plain = sketch.tensor_sketch_estimate(sk._replace(
        table=sk.table.cpu(), params=sk.params.to("cpu")), 4500)
    assert torch.equal(est.cpu().view(torch.int32), plain.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m",
                                  "qwen3-moe-235b-a22b"])
def test_smoke_train_step_on_the_card_matches_the_cpu(card, arch):
    """chip_smoke's twin check: f32, TF32 off, the same weights and batch:
    loss, gradients, and one step under AdamW and one under Adafactor on
    the card and the CPU within its stated bars."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="float32", compute_dtype="float32")
    _chip_smoke().train_twin(arch + " SMOKE", cfg, 2, 32, card,
                             with_step=True)


class _Boom(RuntimeError):
    pass


@pytest.mark.cuda
def test_trainer_resumes_bit_for_bit_on_the_card(card, tmp_path):
    """tinyllama SMOKE (bf16) on the card: die before step 10, restart
    from the step-8 checkpoint, and end with the uninterrupted run's
    step-12 loss and weights, bit for bit."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    tcfg = TrainStepConfig(q_chunk=16, peak_lr=1e-3, warmup_steps=2,
                           total_steps=50)

    def batch_fn(step):
        return zipf_token_stream(prng.key(1000 + step, card), 2, 32,
                                 cfg.vocab_size)

    def bomb(step):
        if step == 10:
            raise _Boom()

    rc = TrainerConfig(total_steps=12, ckpt_every=4,
                       ckpt_dir=str(tmp_path / "run"), log_every=4)
    with pytest.raises(_Boom):
        Trainer(cfg, tcfg, rc, batch_fn, bomb, device=card).run()
    tr = Trainer(cfg, tcfg, rc, batch_fn, device=card)
    assert tr.start_step == 8
    out = tr.run()
    oracle = Trainer(cfg, tcfg, TrainerConfig(
        total_steps=12, ckpt_every=12, ckpt_dir=str(tmp_path / "oracle"),
        log_every=4), batch_fn, device=card)
    out2 = oracle.run()
    assert out["metrics"][-1]["loss"] == out2["metrics"][-1]["loss"]
    for p, q in zip(tr.state["model"].parameters(),
                    oracle.state["model"].parameters()):
        assert torch.equal(p, q)

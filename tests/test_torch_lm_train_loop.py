"""The LM training loop in the port: checkpoints (the reference's
``tests/test_checkpoint.py`` cases on the port's trees, and a checkpoint
the reference wrote read back by the port), the ``Trainer``'s fault
injection and bit-exact resume (``tests/test_trainer.py``), the
activation monitor against the reference's ``ActivationSketcher``, and
the ``launch.train`` CLI on the CPU."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import one_torch_thread  # noqa: F401
from repro.checkpoint import save_checkpoint as ref_save
from repro.train.callbacks import ActivationSketcher as RefSketcher
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.data.synthetic import zipf_token_stream
from repro_torch.launch import train as train_cli
from repro_torch.train.callbacks import (ActivationSketcher,
                                         RouterCollapseMonitor)
from repro_torch.train.steps import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

CFG = get_config("tinyllama-1.1b", smoke=True)
TCFG = TrainStepConfig(q_chunk=16, peak_lr=1e-3, warmup_steps=2,
                       total_steps=50)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": torch.randn((3,), generator=g).bfloat16()},
            "step": 7}


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    assert latest_step(str(tmp_path)) == 5
    like = {"a": torch.zeros(4, 8), "nested": {
        "b": torch.zeros(6, dtype=torch.int32),
        "c": torch.zeros(3, dtype=torch.bfloat16)}, "step": 0}
    back = restore_checkpoint(str(tmp_path), 5, like)
    for k in ("a",):
        assert torch.equal(back[k], t[k])
    for k in ("b", "c"):
        assert back["nested"][k].dtype == t["nested"][k].dtype
        assert torch.equal(back["nested"][k], t["nested"][k])
    assert back["step"] == 7


def test_reads_a_checkpoint_the_reference_wrote(tmp_path):
    """The reference's on-disk layout: a bf16 and an int32 leaf written by
    ``repro.checkpoint`` come back bit for bit."""
    k = jax.random.key(0)
    t = {"w": jax.random.normal(k, (5, 3), jnp.bfloat16),
         "n": jnp.arange(4, dtype=jnp.int32)}
    ref_save(str(tmp_path), 3, t)
    back = restore_checkpoint(str(tmp_path), 3, {
        "w": torch.zeros((5, 3), dtype=torch.bfloat16),
        "n": torch.zeros(4, dtype=torch.int32)})
    np.testing.assert_array_equal(back["w"].view(torch.int16).numpy(),
                                  np.asarray(t["w"]).view(np.int16))
    np.testing.assert_array_equal(back["n"].numpy(), np.asarray(t["n"]))


def test_corrupt_checkpoint_skipped(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    save_checkpoint(str(tmp_path), 2, t)
    with open(tmp_path / "step_00000002" / "arrays.npz", "w") as f:
        f.write("garbage")
    assert latest_step(str(tmp_path)) == 1


def test_partial_write_invisible(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) == 1


def test_manager_async_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, _tree(s))
    mgr.wait()
    mgr.close()
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_00000030", "step_00000040"]
    assert latest_step(str(tmp_path)) == 40


def _batch_fn(step):
    return zipf_token_stream(prng.key(1000 + step), 2, 32, CFG.vocab_size)


class _Boom(RuntimeError):
    pass


def test_fault_injection_and_bitexact_resume(tmp_path):
    """Die before step 10 (after the step-8 checkpoint), restart from 8,
    and end where an uninterrupted run ends: the step-12 loss, every
    weight and the optimizer's moments bit for bit."""
    rc = TrainerConfig(total_steps=12, ckpt_every=4,
                       ckpt_dir=str(tmp_path / "ckpt"), log_every=4)

    def bomb(step):
        if step == 10:
            raise _Boom()

    with pytest.raises(_Boom):
        Trainer(CFG, TCFG, rc, _batch_fn, fault_hook=bomb,
                device="cpu").run()
    tr = Trainer(CFG, TCFG, rc, _batch_fn, device="cpu")
    assert tr.start_step == 8
    out = tr.run()
    assert out["final_step"] == 12
    rc2 = TrainerConfig(total_steps=12, ckpt_every=12,
                        ckpt_dir=str(tmp_path / "oracle"), log_every=4)
    oracle = Trainer(CFG, TCFG, rc2, _batch_fn, device="cpu")
    out2 = oracle.run()
    a = [m for m in out["metrics"] if m["step"] == 12][0]
    b = [m for m in out2["metrics"] if m["step"] == 12][0]
    assert a["loss"] == b["loss"], (a, b)
    for (n, p), q in zip(tr.state["model"].named_parameters(),
                         oracle.state["model"].parameters()):
        assert torch.equal(p, q), n
    for n, m in oracle.state["opt"].m.items():
        assert torch.equal(tr.state["opt"].m[n], m), n


def test_trainer_with_activation_monitor(tmp_path):
    rc = TrainerConfig(total_steps=6, ckpt_every=6,
                       ckpt_dir=str(tmp_path / "c"), log_every=2,
                       monitor_activations=True)
    rep = Trainer(CFG, TCFG, rc, _batch_fn, device="cpu"
                  ).run()["activation_report"]
    assert rep["hh_count"] > 0
    assert rep["tokens_seen"] > 0


def test_monitor_heavy_hitters_match_reference():
    """The same activations through the reference's ActivationSketcher and
    the port's (the projection is ``prng.normal``, the reference's draw
    bit for bit): the same heavy-hitter cells with the same counts."""
    rng = np.random.default_rng(0)
    centres = rng.standard_normal((6, 64)).astype(np.float32)
    ref, port = RefSketcher(), ActivationSketcher(device="cpu")
    for _ in range(3):
        acts = (centres[rng.integers(0, 6, (4, 300))]
                + 0.05 * rng.standard_normal((4, 300, 64))
                ).astype(np.float32)
        ref.observe(jnp.asarray(acts))
        port.observe(torch.from_numpy(acts))
    rr, pr = ref.report(), port.report()
    assert pr["hh_count"] == rr["hh_count"] > 0
    assert pr["tokens_seen"] == rr["tokens_seen"] == 3600

    def cells(hh):
        live = np.asarray(hh.mask)
        return dict(zip(zip(np.asarray(hh.key_hi, np.int64)[live].tolist(),
                            np.asarray(hh.key_lo, np.int64)[live].tolist()),
                        np.asarray(hh.count)[live].tolist()))
    assert cells(pr["hh"]) == cells(rr["hh"])


def test_router_collapse_alarm():
    """Router logits all in one cell raise the alarm; spread ones do not."""
    g = torch.Generator().manual_seed(0)
    collapsed = RouterCollapseMonitor(device="cpu")
    collapsed.observe(torch.ones((512, 16)) + 1e-3 * torch.randn(
        (512, 16), generator=g))
    assert collapsed.check()["collapsed"]
    spread = RouterCollapseMonitor(device="cpu")
    spread.observe(3 * torch.randn((512, 16), generator=g))
    assert not spread.check()["collapsed"]


def test_launch_train_cli_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train ... --device cpu``'s main: four
    steps, checkpoints at 2 and 4; run again, it resumes at 4 and stops."""
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "4",
            "--batch", "2", "--seq", "32", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "2"]
    train_cli.main(argv)
    assert "[done] 4 steps" in capsys.readouterr().out
    assert latest_step(str(tmp_path / "ck")) == 4
    train_cli.main(argv)
    assert "[resume] from step 4" in capsys.readouterr().out


def test_launch_train_cli_default_ckpt_dir_is_per_run(tmp_path, capsys,
                                                      monkeypatch):
    """Without ``--ckpt-dir`` each run writes to a fresh directory under
    the temp dir: a second run trains its own four steps and resumes
    nothing of the first."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "4",
            "--batch", "2", "--seq", "32", "--device", "cpu",
            "--ckpt-every", "4"]
    for _ in range(2):
        train_cli.main(argv)
        out = capsys.readouterr().out
        assert "[done] 4 steps" in out and "[resume]" not in out
    runs = sorted(tmp_path.iterdir())
    assert len(runs) == 2
    assert all(latest_step(str(r)) == 4 for r in runs)

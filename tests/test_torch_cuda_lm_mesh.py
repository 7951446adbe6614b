"""The LM stack's sharded train step on card ranks, held to the port's
single-device step on the CPU from the same weights and batch.  Every
test needs an NVIDIA GPU (marker ``cuda``) and skips without one; this
file imports neither jax nor the reference.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm_mesh.py

Layouts: four gloo ranks sharing cuda:0 as a (2, 2) ("data", "model")
mesh, and one nccl rank as (1, 1) (tests/_torch_lm_mesh_ranks.py).  Bars
as tests/test_torch_lm_mesh.py's, in f32 with TF32 off: the loss within
1e-5 relative, each gradient block within 1e-4·max|g_leaf|, the updated
weights within 1e-3·lr where |g| > 1e-2·max|g_leaf| and 2·lr (plus the
weights' f32 rounding) everywhere, an MoE model's dropped share exactly.
"""
import json

import numpy as np
import pytest
import torch

import _torch_lm_mesh_ranks as ranks_mod
from repro_torch.launch import sharding as sh
from repro_torch.models import model as model_mod
from repro_torch.train import steps

pytestmark = pytest.mark.cuda

LR = 1e-2
# a weight whose tiny gradient flips sign moves by 2·lr (a first step of
# either optimizer is about lr·sign(g)), plus the f32 rounding of the
# weights it is the difference of
FLIP = 2 * LR * (1 + 1e-5)
TCFG = dict(peak_lr=LR, warmup_steps=1, total_steps=4, q_chunk=8)
CASES = [("tl", "tinyllama-1.1b", "embed_tp", "adamw", {}),
         ("qm", "qwen3-moe-235b-a22b", "seq_tp", "adamw",
          {"capacity_factor": 0.5}),
         ("jb", "jamba-v0.1-52b", "dp_only", "adafactor",
          {"capacity_factor": 0.5})]
LAYOUTS = {"gloo4": (4, "gloo", [2, 2]), "nccl1": (1, "nccl", [1, 1])}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's own runs")
    return torch.device("cuda")


def _block(full, spec, shape, names, rank):
    coords = dict(zip(names, np.unravel_index(rank, shape)))
    sizes = dict(zip(names, shape))
    for d, a in enumerate(spec):
        if not a:
            continue
        idx, n = 0, 1
        for x in ((a,) if isinstance(a, str) else a):
            idx, n = idx * sizes[x] + coords[x], n * sizes[x]
        step = full.shape[d] // n
        full = np.take(full, range(idx * step, (idx + 1) * step), axis=d)
    return full


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def layout(card, request, tmp_path_factory):
    """(layout's mesh shape, the ranks' outputs, the CPU twins)."""
    world, backend, shape = LAYOUTS[request.param]
    names = ["data", "model"]
    tmp = tmp_path_factory.mktemp(request.param)
    inp, twins, cases = {}, {}, []
    for name, arch, act, opt, over in CASES:
        case = dict(name=name, kind="train", arch=arch, shape=shape,
                    names=names, act_mode=act, overrides=over,
                    tcfg=dict(TCFG, optimizer=opt))
        cfg = ranks_mod.case_config(case)
        model = model_mod.init_params(cfg, torch.Generator().manual_seed(3),
                                      tp=shape[1], device="cpu")
        for n, p in model.named_parameters():
            inp[f"{name}/w/{n}"] = p.detach().numpy().copy()
        rng = np.random.default_rng(7)
        b = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (4, 16)),
             "loss_mask": np.ones((4, 16), np.float32)}
        for k, v in b.items():
            inp[f"{name}/b/{k}"] = v
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tcfg = steps.TrainStepConfig(**case["tcfg"])
        model.requires_grad_(True)
        total, met = model_mod.forward_train(cfg, model, tb, q_chunk=8)
        total.backward()
        grads = {n: p.grad.numpy().copy() for n, p in
                 model.named_parameters()}
        model.zero_grad(set_to_none=True)
        st = {"model": model, "opt": steps.init_optimizer(cfg, tcfg, model),
              "step": 0}
        st, m = steps.make_train_step(cfg, tcfg)(st, tb)
        specs = {n: tuple(a if a in names else None for a in s)
                 for n, s in sh.param_pspecs(dict(model.named_parameters())
                                             ).items()}
        twins[name] = dict(
            loss=float(m["loss"]), dropped=float(met["dropped_frac"])
            if "dropped_frac" in met else None, grads=grads, specs=specs,
            params={n: p.detach().numpy().copy()
                    for n, p in model.named_parameters()})
        cases.append(case)
    inp.update(cases=np.array(json.dumps(cases)), device=np.array("cuda"),
               backend=np.array(backend))
    np.savez(tmp / "in.npz", **inp)
    outs = ranks_mod.spawn(world, tmp / "in.npz", tmp / "ranks")
    return shape, names, outs, twins


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_step_on_the_card_matches_the_cpu_twin(layout, case):
    shape, names, outs, twins = layout
    name = case[0]
    twin = twins[name]
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{name}/m/loss"], twin["loss"],
                                   rtol=1e-5)
        if twin["dropped"] is not None:
            assert float(out[f"{name}/m/dropped_frac"]) == twin["dropped"]
        for n, full in twin["grads"].items():
            scale = float(np.abs(full).max())
            want = _block(full, twin["specs"][n], shape, names, r)
            got = out[f"{name}/g/{n}"]
            assert float(np.abs(got - want).max()) <= 1e-4 * scale, n
            sure = np.abs(want) > 1e-2 * scale
            d = np.abs(out[f"{name}/p/{n}"] - _block(
                twin["params"][n], twin["specs"][n], shape, names, r))
            assert float(d.max()) <= FLIP, n
            assert not (d[sure] > 1e-3 * LR).any(), n

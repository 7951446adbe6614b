"""The LM stack's training path in the port (models.model.forward_train,
train.steps.make_train_step) against the JAX reference on the CPU: the
loss, the MoE aux losses and every gradient leaf of each family's SMOKE
config, remat's bits, and three train steps under AdamW and Adafactor
from the reference's own train state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import (configs, one_torch_thread,  # noqa: F401
                              port_train_batch, ref_jit,
                              ref_leaves, ref_params_from_port,
                              ref_train_batch, to_numpy, train_inputs)
from repro import optim as ropt
from repro.models import model as ref_model
from repro.train import steps as ref_steps
from repro_torch.carry import lm_params_from_numpy, train_state_from_numpy
from repro_torch.models import model as model_mod
from repro_torch.train import steps

# f32: the port against the reference, each on the CPU (measured: loss
# ≤ 1.8e-7 relative, gradients ≤ 9.3e-6·max|g_leaf|, the SSD's the most)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# bf16: the reference's bar on the loss; gradients by direction (measured:
# loss ≤ 1.8e-7 relative, cosine ≥ 0.99996)
BF16_LOSS_TOL = 2e-2
BF16_COSINE = 0.99


def _ref_value_and_grad(rc, params, rb, q_chunk):
    def loss(p):
        return ref_model.forward_train(rc, p, rb, q_chunk=q_chunk)
    fn = jax.value_and_grad(loss, has_aux=True)
    return ref_jit(fn, params)(params)


def _port_value_and_grad(pc, model, pb, q_chunk, **kw):
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    total, metrics = model_mod.forward_train(pc, model, pb, q_chunk=q_chunk,
                                             **kw)
    total.backward()
    return total, metrics, {n: p.grad.detach().clone()
                            for n, p in model.named_parameters()}


def _twin(arch, dtype, seq=16, q_chunk=1024):
    rc, pc = configs(arch, dtype)
    params = ref_params_from_port(rc, pc, model_mod.init_params(
        pc, torch.Generator().manual_seed(3), device="cpu"))
    model = lm_params_from_numpy(pc, jax.tree.map(np.asarray, params))
    inputs = train_inputs(rc, 7, seq=seq)
    (rtotal, rmet), rgrads = _ref_value_and_grad(
        rc, params, ref_train_batch(rc, inputs), q_chunk)
    ptotal, pmet, pgrads = _port_value_and_grad(
        pc, model, port_train_batch(pc, inputs), q_chunk)
    return (rtotal, rmet, ref_leaves(pc, jax.tree.map(np.asarray, rgrads),
                                     model)), (ptotal, pmet, pgrads)


@pytest.mark.parametrize("arch,q_chunk", [
    ("tinyllama-1.1b", 8), ("qwen3-moe-235b-a22b", 1024),
    ("mamba2-130m", 1024), ("jamba-v0.1-52b", 1024),
    ("seamless-m4t-large-v2", 1024), ("internvl2-26b", 1024)])
def test_forward_train_f32_matches_reference(arch, q_chunk):
    """Loss, lb_loss, z_loss and every gradient leaf of the SMOKE config in
    f32: the loss within LOSS_TOL relative, each gradient within
    GRAD_TOL·max|g_leaf| of the reference's ``value_and_grad``."""
    (rtotal, rmet, rg), (ptotal, pmet, pg) = _twin(arch, "float32",
                                                   q_chunk=q_chunk)
    np.testing.assert_allclose(float(ptotal.detach()), float(rtotal),
                               rtol=LOSS_TOL)
    for k in ("loss", "lb_loss", "z_loss"):
        np.testing.assert_allclose(float(pmet[k]), float(rmet[k]),
                                   rtol=LOSS_TOL, atol=1e-7)
    if "moe" in arch or "jamba" in arch:
        assert float(rmet["lb_loss"]) > 0 and float(rmet["z_loss"]) > 0
    assert set(pg) == set(rg)
    for n, g in pg.items():
        want = rg[n]
        scale = float(np.abs(want).max())
        assert float(np.abs(to_numpy(g) - want).max()) <= GRAD_TOL * scale, n


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_forward_train_bf16_matches_reference(arch):
    """bf16 weights and compute: the loss within BF16_LOSS_TOL relative and
    every gradient leaf at cosine ≥ BF16_COSINE to the reference's."""
    (rtotal, _, rg), (ptotal, _, pg) = _twin(arch, "bfloat16")
    np.testing.assert_allclose(float(ptotal.detach()), float(rtotal),
                               rtol=BF16_LOSS_TOL)
    for n, g in pg.items():
        a, b = to_numpy(g).ravel(), rg[n].ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if nb == 0:
            assert na == 0, n
            continue
        assert float(a @ b / (na * nb)) >= BF16_COSINE, n


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m",
                                  "qwen3-moe-235b-a22b"])
def test_remat_gives_the_same_gradient_bits(arch):
    """Checkpointing each superblock (policies "nothing" and "dots")
    recomputes the same activations: loss and gradients equal bit for
    bit to the run that keeps every activation."""
    _, pc = configs(arch, "float32")
    model = model_mod.init_params(pc, torch.Generator().manual_seed(0),
                                  device="cpu")
    pb = port_train_batch(pc, train_inputs(pc, 1))
    runs = [_port_value_and_grad(pc, model, pb, 1024, remat=remat,
                                 remat_policy=policy)
            for remat, policy in ((False, "nothing"), (True, "nothing"),
                                  (True, "dots"))]
    for total, _, grads in runs[1:]:
        assert torch.equal(total, runs[0][0])
        for n, g in grads.items():
            assert torch.equal(g, runs[0][2][n]), n


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "seamless-m4t-large-v2",
                                  "tinyllama-1.1b"])
def test_param_stacks_are_the_reference_leaves(arch):
    """``param_stacks`` groups each reference leaf's weights in its stacking
    order: one stack a leaf of ``blocks`` and ``enc_blocks``, its length
    the leaf's leading (superblock or encoder-layer) axis, and every
    layer's weight in exactly one stack."""
    rc, pc = configs(arch, "float32")
    model = model_mod.init_params(pc, torch.Generator().manual_seed(0),
                                  device="cpu")
    shapes = jax.eval_shape(lambda: ref_model.init_params(
        jax.random.key(0), rc))
    stacked = [leaf.shape[0] for k in ("blocks", "enc_blocks")
               if k in shapes for leaf in jax.tree.leaves(shapes[k])]
    stacks = model_mod.param_stacks(pc, model)
    assert sorted(len(st) for st in stacks) == sorted(stacked)
    names = [n for st in stacks for n in st]
    assert len(names) == len(set(names)) == sum(
        1 for n, _ in model.named_parameters()
        if n.split(".")[0] in ("layers", "cross", "enc_layers"))
    for st in stacks:                  # one leaf: one suffix, same shape
        assert len({n.split(".", 2)[2] for n in st}) == 1
        assert len({model.get_parameter(n).shape for n in st}) == 1


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_three_train_steps_match_reference(optimizer):
    """Three ``make_train_step`` steps from the reference's train state
    (``init_train_state``'s, with weights drawn by the port; carried over
    by ``train_state_from_numpy``):
    loss, grad_norm and lr at each step, then every weight and optimizer
    statistic, against the reference's jitted steps."""
    rc, pc = configs("tinyllama-1.1b", "float32")
    tc = ref_steps.TrainStepConfig(optimizer=optimizer, peak_lr=1e-2,
                                   warmup_steps=1, total_steps=4, q_chunk=8)
    ptc = steps.TrainStepConfig(**dataclasses.asdict(tc))
    rparams = ref_params_from_port(rc, pc, model_mod.init_params(
        pc, torch.Generator().manual_seed(5), device="cpu"))
    rstate = {"params": rparams,
              "opt": ropt.adamw_init(rparams) if optimizer == "adamw"
              else ropt.adafactor_init(rparams),
              "step": jnp.zeros((), jnp.int32)}
    pstate = train_state_from_numpy(pc, jax.tree.map(np.asarray, rstate))
    batches = [train_inputs(rc, 20 + i) for i in range(3)]
    rstep = _ref_train_step(rc, tc, rstate, ref_train_batch(rc, batches[0]))
    pstep = steps.make_train_step(pc, ptc)
    for inputs in batches:
        rstate, rm = rstep(rstate, ref_train_batch(rc, inputs))
        pstate, pm = pstep(pstate, port_train_batch(pc, inputs))
        for k in ("loss", "total_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert pstate["step"] == int(rstate["step"]) == 3
    model = pstate["model"]
    want = ref_leaves(pc, jax.tree.map(np.asarray, rstate["params"]), model)
    # An optimizer's normalised step (Adam's first is lr·sign(g)) turns a
    # last-bit difference of a near-zero gradient into up to 2·lr: all
    # but 1e-3 of each leaf's weights within 1e-3 of one step at the peak
    # rate, and every weight within 2·lr a step (measured: 1 weight of
    # 16 384 at 1.07e-3·lr)
    for n, p in model.named_parameters():
        d = np.abs(to_numpy(p) - want[n])
        assert float(np.mean(d > 1e-3 * tc.peak_lr)) <= 1e-3, n
        assert float(d.max()) <= 2 * tc.peak_lr * 3, n
    r_opt, popt = rstate["opt"], pstate["opt"]
    assert popt.step == int(r_opt.step) == 3
    fields = ("m", "v") if optimizer == "adamw" else ("vr", "vc")
    for f in fields:
        want = {n: np.asarray(ref_leaf_of(pc, getattr(r_opt, f), n, t))
                for n, t in getattr(popt, f).items()}
        for n, t in getattr(popt, f).items():
            scale = float(np.abs(want[n]).max())
            np.testing.assert_allclose(to_numpy(t), want[n], rtol=1e-4,
                                       atol=GRAD_TOL * scale, err_msg=f + n)


def _ref_train_step(rc, tc, state, batch):
    """The reference's train step, jitted with Adafactor's ``factored``
    flags held static: passed in the state, jit makes them tracers, and
    the update's ``if factored`` cannot branch on one."""
    step = ref_steps.make_train_step(rc, tc)
    factored = getattr(state["opt"], "factored", None)

    def split(st):
        if factored is None:
            return st
        return dict(st, opt=st["opt"]._replace(factored=None))

    def join(st):
        if factored is None:
            return st
        return dict(st, opt=st["opt"]._replace(factored=factored))

    fn = ref_jit(lambda st, b: (lambda out: (split(out[0]), out[1]))(
        step(join(st), b)), split(state), batch)
    return lambda st, b: (lambda out: (join(out[0]), out[1]))(
        fn(split(st), b))


def ref_leaf_of(pc, tree, name, like):
    from repro_torch.carry import ref_leaf
    return ref_leaf(pc, jax.tree.map(np.asarray, tree), name, like.shape)

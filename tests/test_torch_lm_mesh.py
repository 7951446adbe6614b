"""The LM stack's training on a mesh (launch/sharding.py, the sharded
models/ and their draw, train.steps.make_train_step on a sharded model,
the optimizers on sharded leaves, compress_and_reduce(axis_names=),
ActivationSketcher.merged, checkpoints and the Trainer on a mesh)
against the JAX reference's single-device step on the CPU.

Four gloo CPU ranks (tests/_torch_lm_mesh_ranks.py, one process a rank,
``OMP_NUM_THREADS=1``) run every case in one spawn, on (2, 2)
("data", "model") and (2, 1, 2) ("pod", "data", "model") meshes, while
this process computes the reference's results.  Each rank's block of a
gradient, weight or statistic is held to the same block of the
reference's.

Bars (tests/test_torch_lm_train.py's, f32): the loss within 1e-5
relative; each gradient within 1e-4·max|g_leaf|; the updated weights
within 1e-3·lr where |g| exceeds 1e-2·max|g_leaf| and within 2·lr
(plus the weights' f32 rounding) everywhere (a first step of either
optimizer is about lr·sign(g)); the
optimizer's statistics within 1e-4·max|leaf|; the MoE layer's dropped
share exactly; merged sketch tables on integer-valued gradients, the
checkpoint restored onto one device and the resumed run bit for bit;
merged tables of float gradients the same bits on every rank and within
(W - 1)·2⁻²⁴·Σ_w |table_w| of the exact sum.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_mesh_ranks as ranks_mod
from _torch_lm_parity import (one_torch_thread,  # noqa: F401
                              ref_jit, ref_leaves, ref_params_from_port,
                              ref_train_batch, train_inputs)
from repro import optim as ropt
from repro.configs import get_config as ref_config
from repro.core import sketch as ref_sketch
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.optim import sketch_compress as ref_sc
from repro.train import steps as ref_steps
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.launch import sharding as sh
from repro_torch.models import model as model_mod
from repro_torch.optim import sketch_compress as sc
from repro_torch.train import steps
from repro_torch.train.trainer import state_tree

LOSS_TOL, GRAD_TOL, SURE = 1e-5, 1e-4, 1e-2
LR = 1e-2
# a weight whose tiny gradient flips sign moves by 2·lr, plus the f32
# rounding of the weights it is the difference of
FLIP = 2 * LR * (1 + 1e-5)
BATCH, SEQ = 4, 16
D22 = ([2, 2], ["data", "model"])
P212 = ([2, 1, 2], ["pod", "data", "model"])
TCFG = dict(peak_lr=LR, warmup_steps=1, total_steps=4, q_chunk=8)
# dense, MoE and hybrid on both meshes, both optimizers, every act_mode;
# MoE capacity cut so that assignments are dropped; mamba2 at d_model
# 128 so that Adafactor factors its projections; on (2, 1, 2) jamba's
# pattern cut to a period of 2 (a Mamba2 + MLP layer, then an attention
# + MoE layer), since its 8-layer superblock takes the reference ~20 s
# to compile
TRAIN = [
    ("tl22", "tinyllama-1.1b", D22, "embed_tp", "adafactor", {}),
    ("qm22", "qwen3-moe-235b-a22b", D22, "seq_tp", "adamw",
     {"capacity_factor": 0.5}),
    ("jb22", "jamba-v0.1-52b", D22, "dp_only", "adafactor",
     {"capacity_factor": 0.5}),
    ("mb22", "mamba2-130m", D22, "embed_tp", "adafactor", {"d_model": 128}),
    ("tl212", "tinyllama-1.1b", P212, "seq_tp", "adamw", {}),
    ("qm212", "qwen3-moe-235b-a22b", P212, "dp_only", "adafactor",
     {"capacity_factor": 0.5}),
    ("jb212", "jamba-v0.1-52b", P212, "embed_tp", "adamw",
     {"num_layers": 2, "attn_every": 2, "attn_offset": 1}),
]
SKETCH = dict(rows=4, log2_cols=10, top_k=50, momentum=0.9, seed=3)
# init_params(mesh=) on every part kind: attention, MLP, MoE, Mamba2
# (jamba), the encoder, cross-attention and the audio stub
# (seamless-m4t), the patch projection (internvl2)
DRAW = [("dr_jb", "jamba-v0.1-52b", D22),
        ("dr_sm", "seamless-m4t-large-v2", P212),
        ("dr_iv", "internvl2-26b", D22)]


def _configs(arch, overrides):
    def cast(c):
        return dataclasses.replace(c, param_dtype="float32",
                                   compute_dtype="float32", **overrides)
    return cast(ref_config(arch, smoke=True)), cast(ranks_mod.case_config(
        {"arch": arch, "overrides": overrides}))


def _specs(pc, tp, names, fsdp=True):
    model = model_mod.LM(pc, tp, device="meta")
    specs = sh.param_pspecs(dict(model.named_parameters()),
                            sh.ShardingPolicy(fsdp=fsdp))
    return {n: tuple(a if a in names else None for a in s)
            for n, s in specs.items()}


def _block(full, spec, shape, names, rank):
    """Rank ``rank``'s block of ``full`` under ``spec`` (row-major over a
    dimension's axes, as ``sharding.local_shard`` cuts it)."""
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


def _ref_step(rc, tc, state, batch):
    """The reference's single-device train step (``repro.train.steps``'
    body: ``forward_train``'s value and gradient, the cosine rate, then
    ``adamw_update`` or ``adafactor_update``), jitted once, returning its
    gradients too; Adafactor's ``factored`` flags held static (jit would
    make them tracers)."""
    factored = getattr(state["opt"], "factored", None)
    ocfg = ropt.AdamWConfig(lr=tc.peak_lr) if tc.optimizer == "adamw" \
        else ropt.AdafactorConfig(lr=tc.peak_lr)

    def step(params, opt, b):
        def loss(p):
            return ref_model.forward_train(rc, p, b, q_chunk=tc.q_chunk)
        (total, met), grads = jax.value_and_grad(loss, has_aux=True)(params)
        lr = ropt.cosine_schedule(jnp.zeros((), jnp.int32), tc.warmup_steps,
                                  tc.total_steps, tc.peak_lr)
        if tc.optimizer == "adamw":
            new_p, new_opt, gnorm = ropt.adamw_update(grads, opt, params,
                                                      ocfg, lr=lr)
        else:
            new_p, new_opt = ropt.adafactor_update(
                grads, opt._replace(factored=factored), params, ocfg, lr=lr)
            new_opt, gnorm = new_opt._replace(factored=None), jnp.zeros(())
        return total, met, grads, new_p, new_opt, gnorm

    opt = state["opt"] if factored is None \
        else state["opt"]._replace(factored=None)
    return ref_jit(step, state["params"], opt, batch)(state["params"], opt,
                                                       batch)


def _inputs(tmp):
    inp, cases, models = {}, [], {}
    for name, arch, (shape, names), act, opt, over in TRAIN:
        rc, pc = _configs(arch, over)
        tp = dict(zip(names, shape))["model"]
        model = model_mod.init_params(pc, torch.Generator().manual_seed(3),
                                      tp=tp, device="cpu")
        for n, p in model.named_parameters():
            inp[f"{name}/w/{n}"] = p.detach().numpy().copy()
        batch = train_inputs(rc, 7, batch=BATCH, seq=SEQ)
        for k, v in batch.items():
            inp[f"{name}/b/{k}"] = v.astype(np.int64) if k in (
                "tokens", "labels") else v
        models[name] = (rc, pc, tp, model, batch)
        cases.append(dict(name=name, kind="train", arch=arch, shape=shape,
                          names=names, act_mode=act, overrides=over,
                          tcfg=dict(TCFG, optimizer=opt)))
    # one MoE layer, its batch over the data ranks, capacity cut
    rc, pc = _configs("qwen3-moe-235b-a22b", {"capacity_factor": 0.5})
    layer = model_mod.init_params(pc, torch.Generator().manual_seed(4),
                                  tp=2, device="cpu").layers[0].moe
    for n, p in layer.named_parameters():
        inp[f"moe/w/{n}"] = p.detach().numpy().copy()
    rng = np.random.default_rng(11)
    inp["moe/x"] = rng.standard_normal((BATCH, SEQ, pc.d_model)
                                       ).astype(np.float32)
    cases.append(dict(name="moe", kind="moe", arch="qwen3-moe-235b-a22b",
                      shape=D22[0], names=D22[1],
                      overrides={"capacity_factor": 0.5}))
    for name, arch, (shape, names) in DRAW:
        inp[f"{name}/tokens"] = rng.integers(0, 256, (BATCH, SEQ))
        cases.append(dict(name=name, kind="draw", arch=arch, shape=shape,
                          names=names))
    # integer- and float-valued gradients of two data ranks, activations
    # to monitor
    shapes = {"a": (40, 33), "b": (517,), "c": (3, 5, 7)}
    for d in range(2):
        for k, s in shapes.items():
            inp[f"sk/g{d}/{k}"] = rng.integers(-20, 21, s).astype(np.float32)
            inp[f"sk/f{d}/{k}"] = rng.standard_normal(s).astype(np.float32)
        inp[f"sk/acts{d}"] = rng.standard_normal((64, 32)).astype(np.float32)
    cases.append(dict(name="sk", kind="sketch", shape=D22[0], names=D22[1],
                      ccfg=SKETCH))
    # a Trainer with checkpoints on (2, 2), resumed there
    rc, pc = _configs("tinyllama-1.1b", {})
    for s in range(2):
        for k, v in train_inputs(rc, 30 + s, batch=BATCH, seq=SEQ).items():
            inp[f"ck/b{s}/{k}"] = v.astype(np.int64) if k in (
                "tokens", "labels") else v
    cases.append(dict(name="ck", kind="ckpt", arch="tinyllama-1.1b",
                      shape=D22[0], names=D22[1], act_mode="seq_tp",
                      dir=str(tmp / "ckpt"),
                      tcfg=dict(TCFG, optimizer="adamw")))
    inp["cases"] = np.array(json.dumps(cases))
    return inp, models


def _reference(name, models):
    rc, pc, tp, model, batch = models[name]
    opt = [c for c in TRAIN if c[0] == name][0][4]
    params = ref_params_from_port(rc, pc, model)
    rb = ref_train_batch(rc, batch)
    tc = ref_steps.TrainStepConfig(optimizer=opt, **TCFG)
    state = {"params": params,
             "opt": ropt.adamw_init(params) if opt == "adamw"
             else ropt.adafactor_init(params)}
    total, met, grads, new_p, new_opt, gnorm = _ref_step(rc, tc, state, rb)
    fields = ("m", "v") if opt == "adamw" else ("vr", "vc")
    return dict(total=float(total), met={k: float(v) for k, v in met.items()},
                grad_norm=float(gnorm),
                grads=ref_leaves(pc, jax.tree.map(np.asarray, grads), model),
                params=ref_leaves(pc, jax.tree.map(np.asarray, new_p), model),
                opt={f: {n: np.asarray(_leaf(pc, jax.tree.map(
                    np.asarray, getattr(new_opt, f)), n, t), np.float32)
                    for n, t in _opt_like(pc, model, opt, f).items()}
                    for f in fields})


def _leaf(pc, tree, name, like):
    from repro_torch.carry import ref_leaf
    return ref_leaf(pc, tree, name, like.shape)


def _opt_like(pc, model, opt, field):
    tcfg = steps.TrainStepConfig(optimizer=opt)
    return getattr(steps.init_optimizer(pc, tcfg, model), field)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' outputs, the reference's results by case): the ranks
    start first and run while this process computes the references."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    inp, models = _inputs(tmp)
    np.savez(tmp / "in.npz", **inp)
    procs = ranks_mod.start(4, tmp / "in.npz", tmp / "ranks")
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            refs = {name: _reference(name, models) for name, *_ in TRAIN}
        finally:
            torch.set_num_threads(n)
        outs = ranks_mod.collect(procs, tmp / "ranks", timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs, refs, models, inp, tmp


@pytest.mark.parametrize("case", TRAIN, ids=[c[0] for c in TRAIN])
def test_sharded_train_step_matches_reference(run, case):
    """Loss and metrics, every rank's gradient blocks, weight blocks and
    optimizer statistics after one step, against the reference's
    single-device value_and_grad and train step."""
    outs, refs, models, _, _ = run
    name, arch, (shape, names), act, opt, over = case
    ref = refs[name]
    rc, pc, tp, model, _ = models[name]
    specs = _specs(pc, tp, names)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{name}/m/total_loss"], ref["total"],
                                   rtol=LOSS_TOL)
        for k in ("loss", "lb_loss", "z_loss"):
            np.testing.assert_allclose(out[f"{name}/m/{k}"], ref["met"][k],
                                       rtol=LOSS_TOL, atol=1e-7, err_msg=k)
        if opt == "adamw":
            np.testing.assert_allclose(out[f"{name}/m/grad_norm"],
                                       ref["grad_norm"],
                                       rtol=LOSS_TOL)
        for n, full in ref["grads"].items():
            scale = float(np.abs(full).max())
            want = _block(full, specs[n], shape, names, r)
            got = out[f"{name}/g/{n}"]
            assert got.shape == want.shape, n
            assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, n
            g = np.abs(want)
            sure = g > SURE * scale
            d = np.abs(out[f"{name}/p/{n}"]
                       - _block(ref["params"][n], specs[n], shape, names, r))
            assert float(d.max()) <= FLIP, n
            assert not (d[sure] > 1e-3 * LR).any(), n
        for f, leaves in ref["opt"].items():
            for n, full in leaves.items():
                spec = specs[n] if f in ("m", "v") else (None,) * full.ndim
                want = _block(full, spec, shape, names, r)
                scale = float(np.abs(full).max())
                np.testing.assert_allclose(out[f"{name}/o/{f}/{n}"], want,
                                           rtol=1e-4, atol=GRAD_TOL * scale,
                                           err_msg=f + n)


@pytest.mark.parametrize("case", [c for c in TRAIN if "moe" in c[1]
                                  or "jamba" in c[1]],
                         ids=[c[0] for c in TRAIN if "moe" in c[1]
                              or "jamba" in c[1]])
def test_sharded_dropped_share_is_the_single_device_one(run, case):
    """The global capacity drops the same assignments on the mesh as on one
    device: the step's ``dropped_frac`` equals the port's single-device
    forward's, bit for bit, and some are dropped where capacity is cut."""
    outs, _, models, _, _ = run
    name = case[0]
    _, pc, _, model, batch = models[name]
    pb = {k: torch.from_numpy(v.astype(np.int64) if k in ("tokens", "labels")
                              else v) for k, v in batch.items()}
    with torch.no_grad():
        _, met = model_mod.forward_train(pc, model, pb, q_chunk=8)
    want = float(met["dropped_frac"])
    for out in outs:
        assert float(out[f"{name}/m/dropped_frac"]) == want
    if case[5].get("capacity_factor", 1.25) < 1:
        assert want > 0


def test_moe_layer_on_the_mesh_matches_reference(run):
    """One MoE layer with the batch over "data" and the experts over
    "model": each rank's output rows within 1e-5 of the reference's
    ``moe_apply`` on the whole batch, and the dropped share, the load
    balance and z losses of the global batch (the dropped share
    exactly)."""
    outs, _, _, inp, _ = run
    rc, pc = _configs("qwen3-moe-235b-a22b", {"capacity_factor": 0.5})
    rp = ref_moe.MoeParams(**{k: jnp.asarray(inp[f"moe/w/{k}"])
                              for k in ("router", "w_gate", "w_up",
                                        "w_down")})
    y, aux = ref_moe.moe_apply(rp, jnp.asarray(inp["moe/x"]),
                               top_k=rc.moe_top_k,
                               capacity_factor=rc.capacity_factor)
    y = np.asarray(y)
    assert float(aux.dropped_frac) > 0
    for r, out in enumerate(outs):
        rows = _block(y, (("data",), None, None), *D22, r)
        np.testing.assert_allclose(out["moe/y"], rows, rtol=1e-5, atol=1e-6)
        assert float(out["moe/dropped"]) == float(aux.dropped_frac)
        np.testing.assert_allclose(out["moe/lb"], float(aux.load_balance_loss),
                                   rtol=1e-6)
        np.testing.assert_allclose(out["moe/z"], float(aux.z_loss),
                                   rtol=1e-6)


def test_compress_and_reduce_merges_over_data(run):
    """``compress_and_reduce(axis_names=("data",))`` on integer-valued
    gradients: every rank's merged table equals one device's sketch of
    the summed gradient bit for bit (the reference's ``local_sketch``
    too), each data rank's own table is its own gradient's sketch, and
    every rank sends the same update, that of one device's round on the
    summed gradient."""
    outs, _, _, inp, _ = run
    keys = ("a", "b", "c")
    total = {k: torch.from_numpy(inp[f"sk/g0/{k}"] + inp[f"sk/g1/{k}"])
             for k in keys}
    ccfg = sc.SketchCompressConfig(**SKETCH)
    state = sc.sketch_compress_init(total, ccfg)
    want = sc.local_sketch(total, state, ccfg).table.numpy()
    rcfg = ref_sc.SketchCompressConfig(**SKETCH)
    rtotal = {k: jnp.asarray(v.numpy()) for k, v in total.items()}
    rstate = ref_sc.sketch_compress_init(rtotal, rcfg)
    np.testing.assert_array_equal(
        np.asarray(ref_sc.local_sketch(rtotal, rstate, rcfg).table), want)
    upd, _, density = sc.compress_and_reduce(total, state, ccfg)
    for r, out in enumerate(outs):
        d = r // 2                       # (2, 2): rank = data·2 + model
        np.testing.assert_array_equal(out["sk/merged"], want)
        own = {k: torch.from_numpy(inp[f"sk/g{d}/{k}"]) for k in keys}
        np.testing.assert_array_equal(out["sk/own"], sc.local_sketch(
            own, sc.sketch_compress_init(own, ccfg), ccfg).table.numpy())
        assert float(out["sk/density"]) == float(density)
        for k in keys:
            np.testing.assert_array_equal(out[f"sk/u/{k}"], upd[k].numpy())


def test_float_sketch_merge_is_one_sum_on_every_rank(run):
    """On float gradients the all-reduced table holds the same bits on
    every rank (so every rank decompresses the same table) and lies
    within (W - 1)·2⁻²⁴·Σ_w |table_w| of the exact sum of the data ranks'
    own tables (W = 2)."""
    outs, _, _, _, _ = run
    own = [outs[0]["sk/f_own"].astype(np.float64),
           outs[2]["sk/f_own"].astype(np.float64)]
    exact = own[0] + own[1]
    bound = (len(own) - 1) * 2.0 ** -24 * (np.abs(own[0]) + np.abs(own[1]))
    assert not np.array_equal(own[0], own[1])
    for out in outs:
        np.testing.assert_array_equal(out["sk/f_merged"],
                                      outs[0]["sk/f_merged"])
        assert (np.abs(out["sk/f_merged"] - exact) <= bound).all()


@pytest.mark.parametrize("case", DRAW, ids=[c[0] for c in DRAW])
def test_init_params_on_the_mesh_is_one_devices_draw_cut(run, case):
    """``init_params(mesh=)`` cuts each part as soon as it is drawn: every
    rank's blocks equal the same blocks of one device's draw from the same
    seed bit for bit, and ``embed_rows`` through the vocab-parallel lookup
    equals one device's rows."""
    outs, _, _, inp, _ = run
    name, arch, (shape, names) = case
    pc = ranks_mod.case_config({"arch": arch})
    tp = dict(zip(names, shape))["model"]
    model = model_mod.init_params(pc, torch.Generator().manual_seed(3),
                                  tp=tp, device="cpu")
    specs = _specs(pc, tp, names)
    tokens = torch.from_numpy(inp[f"{name}/tokens"])
    rows = model_mod.embed_rows(model, tokens).detach().numpy()
    for r, out in enumerate(outs):
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(
                out[f"{name}/w/{n}"],
                _block(p.detach().numpy(), specs[n], shape, names, r),
                err_msg=n)
        np.testing.assert_array_equal(out[f"{name}/rows"], rows)


def test_activation_sketcher_merged_across_ranks(run):
    """``ActivationSketcher.merged(mesh=, axes=("data",))`` is the sum of
    the data ranks' tables (the reference's ``merge``, by linearity)."""
    outs, _, _, _, _ = run
    tables = [outs[0]["sk/act_own"], outs[2]["sk/act_own"]]
    want = np.asarray(ref_sketch.merge(
        ref_sketch.CountSketch(table=jnp.asarray(tables[0]), params=None),
        ref_sketch.CountSketch(table=jnp.asarray(tables[1]),
                               params=None)).table)
    assert not np.array_equal(tables[0], tables[1])
    for out in outs:
        np.testing.assert_array_equal(out["sk/act_merged"], want)


def test_checkpoint_on_the_mesh_restores_onto_one_device(run):
    """A Trainer's checkpoints on (2, 2) hold the full leaves: the newest
    restores onto one device equal to the ranks' gathered weights bit for
    bit, and a run resumed from step 1 on the same mesh ends with the
    same bits as the run that was not stopped."""
    outs, _, _, _, tmp = run
    _, pc = _configs("tinyllama-1.1b", {})
    tcfg = steps.TrainStepConfig(optimizer="adamw", **TCFG)
    like = steps.init_train_state(pc, tcfg, torch.Generator().manual_seed(0),
                                  device="cpu", tp=2)
    d = str(tmp / "ckpt" / "a")
    assert latest_step(d) == 2
    tree = restore_checkpoint(d, 2, state_tree(like))
    for out in outs:
        assert int(out["ck/start"]) == 1
        for n, t in tree["params"].items():
            np.testing.assert_array_equal(out[f"ck/a/{n}"], t.numpy())
            np.testing.assert_array_equal(out[f"ck/b/{n}"], t.numpy())
    assert tree["step"] == 2 and tree["opt"].step == 2

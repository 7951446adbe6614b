"""The LM stack's serving on a mesh (``init_decode_state(mesh=)``, the
split-sequence attention, ``forward_step`` on a sharded model,
``make_prefill_step(mesh=)``, ``launch/serve.py --mesh``) against the
port's single-device run and the JAX reference's serving steps on the
CPU.

Four gloo CPU ranks (tests/_torch_lm_mesh_ranks.py, job ``cases``, kind
``serve``) run every case in one spawn on a (2, 2) ("data", "model")
mesh: at B 4 the batch is split over "data" and the caches' sequence over
"model"; at B 1 the sequence is split over all four ranks.  Each case is
a prefill and 6 decode steps, teacher-forced with one device's greedy
tokens, from the weights one device holds (``init_params`` with tp 2,
carried into the reference's pytree).  While the ranks run, this process
computes the one-device port run and the reference's.

Bars (f32): every step's logits within 1e-5·max|logits| of one device's
and of the reference's; the caches put back together from the ranks'
blocks within the same bar of one device's; an MoE model's dropped share
of every decode step equal to one device's.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_mesh_ranks as ranks_mod
from _torch_lm_parity import (configs, lm_inputs, ref_batch, ref_jit,
                              ref_params_from_port)
from repro.configs import ARCH_IDS
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch.launch import sharding as sh
from repro_torch.models import model as model_mod
from repro_torch.train import steps

TOL = 1e-5
D22 = ([2, 2], ["data", "model"])
TP = 2
PROMPT, STEPS = 9, 6
BATCHES = (4, 1)
MOE = ("qwen3-moe-235b-a22b", "arctic-480b", "jamba-v0.1-52b")
# (name, batch, cache_len, prompt, decode steps): the prompt's span crosses
# rank boundaries of the sequence; cache 10 is no multiple of the 4 (B 1)
# or 2 (B 4) sequence ranks, so the last rank holds padded slots; at B 1
# the second step writes slot 8, the last slot of rank 2 (slots 6-8), and
# a fourth step (position 10) is past the cache's end
EDGES = [("edge1", 1, 10, 7, 3), ("edge4", 4, 10, 7, 3)]
# B 1 with a cache of 4096 slots and a short prompt: the rank's caches
# are the largest tensors it allocates
LONG = ("long", 1, 4096, 8, 2)


def _cache_len(cfg, prompt=PROMPT):
    prefix = cfg.num_prefix if cfg.frontend == "vision" else 0
    return prefix + prompt + STEPS + 1


def _one_device(pc, model, inputs, cache_len, teacher=None, steps_=STEPS):
    """The port on one device: prefill and ``steps_`` decode steps, fed
    ``teacher`` (B, steps_) or its own greedy tokens.  Returns (logits a
    step, the tokens fed, the dropped share a decode step, the state)."""
    batch = {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
             for k, v in inputs.items()}
    logits, state = steps.make_prefill_step(pc, cache_len, tp=TP)(model,
                                                                  batch)
    out, fed, drops = [logits.numpy()], [], []
    for i in range(steps_):
        tok = torch.argmax(logits, -1) if teacher is None \
            else torch.from_numpy(teacher[:, i])
        fed.append(tok.numpy())
        aux = {k: torch.zeros(()) for k in ("lb_loss", "z_loss", "dropped")}
        with torch.inference_mode():
            logits, state = model_mod.forward_step(pc, model, tok[:, None],
                                                   state, aux=aux)
        out.append(logits.numpy())
        drops.append(float(aux["dropped"]))
    return out, np.stack(fed, 1), drops, state


def _reference(rc, pc, model, inputs, cache_len, teacher):
    params = ref_params_from_port(rc, pc, model, tp=TP)
    rb = ref_batch(rc, inputs)
    rl, rs = ref_jit(ref_prefill_step(rc, cache_len, tp=TP), params,
                     rb)(params, rb)
    out, dec = [np.asarray(rl)], None
    for i in range(teacher.shape[1]):
        tok = jnp.asarray(teacher[:, i:i + 1].astype(np.int32))
        dec = dec or ref_jit(ref_decode_step(rc), params, tok, rs)
        rl, rs = dec(params, tok, rs)
        out.append(np.asarray(rl))
    return out


def _draw(pc, seed=3):
    return model_mod.init_params(pc, torch.Generator().manual_seed(seed),
                                 tp=TP, device="cpu")


def _inputs():
    inp, cases, ones = {}, [], {}
    for arch in ARCH_IDS:
        rc, pc = configs(arch, "float32")
        model = _draw(pc)
        for n, p in model.named_parameters():
            inp[f"{arch}/w/{n}"] = p.detach().numpy().copy()
        for b in BATCHES:
            name = f"{arch}/B{b}"
            inputs = lm_inputs(rc, 40 + b, batch=b, prompt=PROMPT)
            cl = _cache_len(pc)
            logits, fed, drops, state = _one_device(pc, model, inputs, cl)
            ones[name] = dict(rc=rc, pc=pc, model=model, inputs=inputs,
                              cache_len=cl, logits=logits, fed=fed,
                              drops=drops, state=state)
            for k, v in inputs.items():
                inp[f"{name}/b/{k}"] = v.astype(np.int64) if k == "tokens" \
                    else v
            inp[f"{name}/teacher"] = fed.astype(np.int64)
            cases.append(dict(name=name, kind="serve", arch=arch,
                              shape=D22[0], names=D22[1], cache_len=cl,
                              weights=arch))
    rc, pc = configs("tinyllama-1.1b", "float32")
    model = _draw(pc)
    for name, b, cl, prompt, n in EDGES + [LONG]:
        inputs = lm_inputs(rc, 60 + b, batch=b, prompt=prompt)
        logits, fed, _, state = _one_device(pc, model, inputs, cl, steps_=n)
        ones[name] = dict(logits=logits, state=state, cache_len=cl, pc=pc)
        inp[f"{name}/b/tokens"] = inputs["tokens"].astype(np.int64)
        inp[f"{name}/teacher"] = fed.astype(np.int64)
        cases.append(dict(name=name, kind="serve", arch="tinyllama-1.1b",
                          shape=D22[0], names=D22[1], cache_len=cl,
                          weights="tinyllama-1.1b", overflow=name != "long"))
    inp["cases"] = np.array(json.dumps(cases))
    return inp, ones


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' outputs, the one-device runs, the reference's logits by
    case): the ranks start first and run while this process compiles and
    runs the reference."""
    tmp = tmp_path_factory.mktemp("lm_serve_mesh")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inp, ones = _inputs()
        np.savez(tmp / "in.npz", **inp)
        procs = ranks_mod.start(4, tmp / "in.npz", tmp / "ranks")
        try:
            refs = {name: _reference(o["rc"], o["pc"], o["model"],
                                     o["inputs"], o["cache_len"], o["fed"])
                    for name, o in ones.items() if "rc" in o}
            outs = ranks_mod.collect(procs, tmp / "ranks", timeout=300)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    finally:
        torch.set_num_threads(n)
    return outs, ones, refs


def _rows(full, rank, batch):
    """Rank ``rank``'s rows of a (B, ...) array on the (2, 2) mesh: the
    data rank's block when the batch is split, all of it otherwise."""
    if batch < 2:
        return full
    d = rank // 2
    step = full.shape[0] // 2
    return full[d * step:(d + 1) * step]


def _gathered_cache(outs, key, batch, leaf):
    """One device's layout of a cache leaf from the four ranks' blocks:
    k/v split over the sequence ("model" at B 4, all ranks at B 1), SSM
    leaves split over "model" by head (conv_bc whole)."""
    blocks = [o[key] for o in outs]
    if leaf in ("k", "v"):
        if batch < 2:
            return np.concatenate(blocks, axis=1)
        return np.concatenate([np.concatenate(blocks[d * 2:d * 2 + 2],
                                              axis=1) for d in range(2)], 0)
    axis = {"ssm": 1, "conv_x": 2}.get(leaf)
    rows = [blocks[d * 2] if axis is None else
            np.concatenate(blocks[d * 2:d * 2 + 2], axis=axis)
            for d in range(2 if batch >= 2 else 1)]
    return np.concatenate(rows, 0)


CASES = [(a, b) for a in ARCH_IDS for b in BATCHES]


@pytest.mark.parametrize("arch,batch", CASES,
                         ids=[f"{a}-B{b}" for a, b in CASES])
def test_sharded_serving_matches_one_device_and_reference(run, arch, batch):
    """Prefill and 6 teacher-forced decode steps on (2, 2): every rank's
    logits (its rows, the whole vocabulary) within 1e-5·max|logits| of
    the port's one-device run and of the reference's steps."""
    outs, ones, refs = run
    name = f"{arch}/B{batch}"
    one, ref = ones[name], refs[name]
    for i, (lo, lr) in enumerate(zip(one["logits"], ref)):
        scale = float(np.abs(lo).max())
        assert float(np.abs(lo - lr).max()) <= TOL * scale, (name, i)
        for r, out in enumerate(outs):
            got = out[f"{name}/l{i}"]
            want = _rows(lo, r, batch)
            assert got.shape == want.shape, (name, i)
            assert float(np.abs(got - want).max()) <= TOL * scale, \
                (name, i, r)
            assert float(np.abs(got - _rows(lr, r, batch)).max()) <= \
                TOL * scale, (name, i, r)


@pytest.mark.parametrize("arch,batch", CASES,
                         ids=[f"{a}-B{b}" for a, b in CASES])
def test_sharded_caches_are_one_devices_cut(run, arch, batch):
    """After the last step the ranks' cache blocks, put back together,
    equal one device's caches within the logits' bar (relative to each
    leaf's largest entry), and each block's shape is
    ``sharding.local_shape`` of the layout ``decode_state_pspecs`` gives
    (the reference's table)."""
    outs, ones, _ = run
    name = f"{arch}/B{batch}"
    one = ones[name]
    state, pc = one["state"], one["pc"]
    specs = sh.decode_state_pspecs(state, _Mesh(D22), batch)
    for group in ("layers", "cross"):
        for i, c in enumerate(state.get(group, ())):
            for leaf, t in c.items():
                key = f"{name}/c/{group}/{i}/{leaf}"
                full = t.numpy()
                for r, out in enumerate(outs):
                    assert out[key].shape == sh.local_shape(
                        full.shape, specs[group][i][leaf],
                        _Mesh(D22, r)), key
                got = _gathered_cache(outs, key, batch, leaf)
                scale = max(float(np.abs(full).max()), 1e-30)
                assert got.shape == full.shape, key
                assert float(np.abs(got - full).max()) <= TOL * scale, key
    assert all(int(o[f"{name}/pos"]) == _cache_len(pc) - 1 for o in outs)


@pytest.mark.parametrize("arch,batch", [(a, b) for a in MOE
                                        for b in BATCHES],
                         ids=[f"{a}-B{b}" for a in MOE for b in BATCHES])
def test_sharded_decode_drops_what_one_device_drops(run, arch, batch):
    """The MoE layers' capacity counts the global batch's tokens once (at
    B 1 the data ranks hold the same row): every decode step's dropped
    share equals one device's on every rank."""
    outs, ones, _ = run
    name = f"{arch}/B{batch}"
    for i, want in enumerate(ones[name]["drops"]):
        for out in outs:
            assert float(out[f"{name}/drop{i + 1}"]) == want, (name, i)


@pytest.mark.parametrize("case", EDGES, ids=[e[0] for e in EDGES])
def test_sequence_cut_at_its_edges(run, case):
    """A prompt that crosses ranks of the sequence, a cache of 10 slots
    over 4 (or 2) sequence ranks (padded to 12 or 10 slots), a decode
    token on the last slot of a rank: the logits within the bar of one
    device's, the padding never written; a decode past the cache's end
    raises on every rank, as on one device."""
    outs, ones, _ = run
    name, batch, cl, prompt, n = case
    one = ones[name]
    for i, lo in enumerate(one["logits"]):
        scale = float(np.abs(lo).max())
        for r, out in enumerate(outs):
            got = out[f"{name}/l{i}"]
            assert float(np.abs(got - _rows(lo, r, batch)).max()) <= \
                TOL * scale, (name, i, r)
    for i, c in enumerate(one["state"]["layers"]):
        got = _gathered_cache(outs, f"{name}/c/layers/{i}/k", batch, "k")
        full = c["k"].numpy()
        assert float(np.abs(got[:, :cl] - full).max()) <= \
            TOL * float(np.abs(full).max())
        assert not got[:, cl:].any()            # the padding
    assert all(int(o[f"{name}/raised"]) == 1 for o in outs)
    with pytest.raises(ValueError, match="cannot take"):
        model_mod.forward_step(one["pc"], _draw(one["pc"]),
                               torch.zeros((batch, 1), dtype=torch.long),
                               one["state"])


def test_no_rank_allocates_a_whole_cache(run):
    """B 1, 4096 slots over four ranks: each rank's caches hold 1024
    slots, and no tensor the rank allocates in its prefill and decode
    steps is as large as one layer's whole cache."""
    outs, ones, _ = run
    name, _, cl, _, _ = LONG
    pc = ones[name]["pc"]
    whole = cl * pc.num_kv_heads * pc.head_dim * 4
    for out in outs:
        assert out[f"{name}/c/layers/0/k"].shape == (1, cl // 4,
                                                     pc.num_kv_heads,
                                                     pc.head_dim)
        assert whole // 4 <= int(out[f"{name}/largest"]) < whole


def test_serve_launcher_on_a_cpu_mesh():
    """``python -m repro_torch.launch.serve --mesh 2,2 --host-devices 4
    --device cpu`` exits 0 and prints its prefill and decode lines."""
    root = Path(__file__).resolve().parent.parent
    env = {"PYTHONPATH": str(root / "src"), "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo", "PATH": "/usr/bin:/bin"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "tinyllama-1.1b", "--smoke", "--mesh", "2,2", "--host-devices", "4",
         "--device", "cpu", "--gen", "4"], capture_output=True, text=True,
        timeout=240, env=env, cwd=str(root))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[prefill] 8x64" in res.stdout and "[decode] 3 steps" in \
        res.stdout, res.stdout


class _Mesh:
    """A stand-in for a DeviceMesh: dimension names and sizes, and rank
    ``rank``'s coordinates, for the layout tables."""

    def __init__(self, shape_names, rank=0):
        shape, names = shape_names
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self._coords = dict(zip(names, np.unravel_index(rank, shape)))

    def get_local_rank(self, axis):
        return int(self._coords[axis])

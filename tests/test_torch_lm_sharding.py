"""The port's sharding tables (launch/sharding.py) against the reference's
(repro.launch.sharding), leaf by leaf, for every SMOKE config: the
parameter, optimizer, batch and decode-state layouts.  The reference's
functions read only ``mesh.axis_names`` and ``mesh.shape``, so a
stand-in object lets them run without devices; no ranks start here.
The reference stacks a layer kind's leaves over superblocks with a
leading replicated dimension, which the port (one module a layer)
drops."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_lm_parity import configs
from repro import optim as ropt
from repro.launch import sharding as rsh
from repro.models import model as ref_model
from repro_torch.carry import ref_leaf
from repro_torch.configs import ARCH_IDS
from repro_torch.core import mesh as mesh_mod
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import sharding as sh
from repro_torch.models import model as model_mod
from repro_torch.optim import adafactor_init, adamw_init

STACKED = ("layers", "cross", "enc_layers")


def _is_p(x):
    return isinstance(x, P)


def _objects(tree):
    """A PartitionSpec tree with each spec as a 0-d object array holding its
    tuple, so ``carry.ref_leaf`` can walk it."""
    def one(spec):
        a = np.empty((), object)
        a[()] = tuple(spec)
        return a
    return jax.tree.map(one, tree, is_leaf=_is_p)


def _ref_spec(pc, tree, name):
    """The reference's layout of the port's leaf ``name``, its stacked
    dimension dropped."""
    spec = ref_leaf(pc, tree, name, ())[()]
    return spec[1:] if name.split(".")[0] in STACKED else spec


def _port_model(pc):
    return model_mod.LM(pc, 1, device="meta")


def _ref_params(rc):
    return jax.eval_shape(lambda: ref_model.init_params(jax.random.key(0),
                                                        rc))


class _RefMesh:
    """What the reference's tables read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


class _PortMesh:
    """What the port's tables and ``local_shard`` read of a DeviceMesh:
    dimension names and sizes, and this rank's coordinate on each."""

    def __init__(self, shape, names, rank=0):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self._coords = dict(zip(names, np.unravel_index(rank, shape)))

    def get_local_rank(self, axis):
        return int(self._coords[axis])


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_are_the_reference_leaves(arch, fsdp):
    rc, pc = configs(arch, "float32")
    rpol, ppol = rsh.ShardingPolicy(fsdp=fsdp), sh.ShardingPolicy(fsdp=fsdp)
    ref = _objects(rsh.param_pspecs(_ref_params(rc), rpol))
    model = _port_model(pc)
    got = sh.param_pspecs(dict(model.named_parameters()), ppol)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, spec in got.items():
        assert spec == _ref_spec(pc, ref, name), name
        assert len(spec) == model.get_parameter(name).ndim, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_pspecs_are_the_reference_leaves(arch):
    """AdamW's moments mirror the parameters and its step is a scalar;
    Adafactor's statistics (and its flags and step) are replicated."""
    rc, pc = configs(arch, "float32")
    rparams = _ref_params(rc)
    model = _port_model(pc)
    params = dict(model.named_parameters())
    r_adam = rsh.opt_pspecs(jax.eval_shape(lambda: ropt.adamw_init(
        ref_model.init_params(jax.random.key(0), rc))), rparams)
    p_adam = sh.opt_pspecs(adamw_init(params), params)
    assert tuple(r_adam.step) == p_adam.step == ()
    for field in ("m", "v"):
        ref = _objects(getattr(r_adam, field))
        for name, spec in getattr(p_adam, field).items():
            assert spec == _ref_spec(pc, ref, name), (field, name)
    r_ada = rsh.opt_pspecs(jax.eval_shape(lambda: ropt.adafactor_init(
        ref_model.init_params(jax.random.key(0), rc))), rparams)
    zero = adafactor_init(params, stacks=model_mod.param_stacks(pc, model))
    p_ada = sh.opt_pspecs(zero, params)
    assert tuple(r_ada.step) == p_ada.step == ()
    for field in ("vr", "vc"):
        ref = _objects(getattr(r_ada, field))
        for name, spec in getattr(p_ada, field).items():
            want = ref_leaf(pc, ref, name, ())[()]
            assert set(want) <= {None} and set(spec) <= {None}, name
            assert len(spec) == getattr(zero, field)[name].ndim
    for name, spec in p_ada.factored.items():
        assert spec == tuple(ref_leaf(pc, _objects(r_ada.factored), name,
                                      ())[()]) == (), name


@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data",
                                                      "model"))])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-26b",
                                  "seamless-m4t-large-v2"])
def test_batch_pspecs_are_the_reference_leaves(arch, shape, names):
    rc, pc = configs(arch, "float32")
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "labels": np.zeros((8, 16), np.int32),
             "loss_mask": np.zeros((8, 16), np.float32),
             "patch_embeds": np.zeros((8, 4, 64), np.float32)}
    ref = rsh.batch_pspecs(batch, _RefMesh(shape, names))
    got = sh.batch_pspecs({k: torch.from_numpy(v) for k, v in batch.items()},
                          _PortMesh(shape, names))
    assert {k: tuple(v) for k, v in ref.items()} == got
    dp = names[:-1]
    assert got["tokens"] == (dp[0] if len(dp) == 1 else dp, None)


@pytest.mark.parametrize("global_batch", [1, 8])
@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data",
                                                      "model"))])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_pspecs_are_the_reference_leaves(arch, shape, names,
                                                      global_batch):
    """Layer i's caches against the reference's ``sub{i % period}`` (and
    ``cross{i % period}``) leaves, the stacked dimension dropped."""
    rc, pc = configs(arch, "float32")
    rstate = jax.eval_shape(lambda: ref_model.init_decode_state(
        rc, global_batch, 8))
    ref = rsh.decode_state_pspecs(rstate, _RefMesh(shape, names),
                                  global_batch)
    pstate = model_mod.init_decode_state(pc, global_batch, 8, device="meta")
    got = sh.decode_state_pspecs(pstate, _PortMesh(shape, names),
                                 global_batch)
    assert tuple(ref["pos"]) == got["pos"] == ()
    period = pc.superblock_period()
    for group, sub in (("layers", "sub"), ("cross", "cross")):
        for i, caches in enumerate(got.get(group, ())):
            want = ref[f"{sub}{i % period}"]
            assert set(caches) == set(want)
            for k, spec in caches.items():
                assert spec == tuple(want[k])[1:], (group, i, k)


@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "model")),
                                         ((2, 1, 2), ("pod", "data",
                                                      "model"))])
def test_local_blocks_tile_every_leaf(shape, names):
    """``local_shard`` over every rank of the mesh covers each full leaf
    exactly once: the blocks put back in rank order (row-major over a
    dimension's axes) are the leaf."""
    _, pc = configs("jamba-v0.1-52b", "float32")
    tp = dict(zip(names, shape))["model"]
    model = model_mod.init_params(pc, torch.Generator().manual_seed(0),
                                  tp=tp, device="cpu")
    pol = sh.ShardingPolicy()
    world = int(np.prod(shape))
    meshes = [_PortMesh(shape, names, r) for r in range(world)]
    for name, p in model.named_parameters():
        spec = sh._leaf_spec(name, p.ndim, pol)
        spec = tuple(a if a in names else None for a in spec)
        full = p.detach()
        blocks = [sh.local_shard(full, spec, m) for m in meshes]
        assert all(b.shape == sh.local_shape(full.shape, spec, meshes[0])
                   for b in blocks), name
        rebuilt = torch.full_like(full, float("nan"))
        for m, b in zip(meshes, blocks):
            idx = []
            for d, a in enumerate(spec):
                n = b.shape[d]
                start = mesh_mod.linear_index(m, a) * n if a else 0
                idx.append(slice(start, start + n))
            rebuilt[tuple(idx)] = b
        assert torch.equal(rebuilt, full), name
        assert sh.full_shape(blocks[0].shape, spec, meshes[0]) == full.shape


def test_launch_mesh_helpers_and_production_layout():
    m = _PortMesh((2, 2, 4), ("pod", "data", "model"))
    assert port_mesh.dp_axes(m) == ("pod", "data")
    assert port_mesh.dp_size(m) == 4 and port_mesh.tp_size(m) == 8 // 2
    assert port_mesh.tp_size(_PortMesh((4,), ("data",))) == 1
    assert port_mesh.PRODUCTION_SHAPES[False] == ((16, 16),
                                                  ("data", "model"))
    with pytest.raises(ValueError):     # 256 ranks, never fewer
        port_mesh.make_production_mesh()


@pytest.mark.parametrize("argv,why", [
    (["--mesh", "2,2", "--device", "cpu"], "needs --host-devices"),
    (["--mesh", "2,2", "--host-devices", "2", "--device", "cpu"],
     "has 4 ranks"),
    (["--host-devices", "4", "--device", "cpu"], "needs --mesh"),
    (["--mesh", "2,2,2,2", "--host-devices", "16", "--device", "cpu"],
     "dimensions")])
def test_train_launcher_refuses_a_mesh_it_cannot_run(argv, why, tmp_path):
    """``launch/train.py`` never falls back: a mesh without ranks to hold
    it, a rank count that is not the mesh's, or host ranks without a
    mesh raise before any rank starts."""
    from repro_torch.launch import train as launch_train
    with pytest.raises(ValueError, match=why):
        launch_train.main(["--arch", "tinyllama-1.1b", "--smoke",
                           "--ckpt-dir", str(tmp_path)] + argv)

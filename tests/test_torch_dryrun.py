"""P15d, the dry-run tooling on the meta device (``train.steps``' spec
helpers, ``core.mesh.count_collectives``, ``launch/dryrun.py``,
``launch/roofline.py``, ``launch/sns_dryrun.py``), against the JAX
reference's on the CPU.

* The spec helpers: every leaf's shape and dtype is the reference's
  ``jax.eval_shape`` result, name for name (the reference stacks a layer
  kind's weights and caches over superblocks; the port's leaf is one
  superblock's slice), for the ten FULL configs and the four shapes.
* Dot FLOPs: the dense SMOKE configs' train, prefill and decode cells
  within 1 % of ``analyze_hlo`` on the reference's program lowered for
  one CPU device; every other config's count covers the matmuls its step
  must do (``tests/witness_dryrun_flops.py`` prints the ratio for all
  ten).
* The split: on fake groups of 4 as (2, 2) and of 256 as (16, 16), a
  dense config whose dimensions divide gives rank FLOPs × ranks = one
  device's + (tp − 1) × the K/V projections' (``wk``/``wv`` are
  replicated over "model" by the layout table, so every model rank
  projects every KV head).
* The counter: one decode step's collectives on a fake (2, 2) group are
  those four gloo ranks count in a real step of the same cell, call for
  call.
* The roofline: given the reference's TPU v5e constants, the reference's
  numbers on the same records.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import _torch_lm_mesh_ranks as ranks_mod
from witness_dryrun_flops import model_flops, reference_flops, smoke_pair
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.launch import roofline as ref_roofline
from repro.models import config as ref_mcfg
from repro.train import steps as ref_steps
from repro_torch.carry import _child
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline, sns_dryrun
from repro_torch.models import config as mcfg
from repro_torch.train import steps

DENSE = ("tinyllama-1.1b", "llama3.2-3b")
KINDS = ("train", "prefill", "decode")
B, S = 2, 32
V5E = dict(peak_flops=ref_roofline.PEAK_FLOPS, hbm_bw=ref_roofline.HBM_BW,
           ici_bw=ref_roofline.ICI_BW, dcn_bw=ref_roofline.DCN_BW)


def _same(ref_struct, t, what, stacked):
    shape = tuple(ref_struct.shape)[1:] if stacked else \
        tuple(ref_struct.shape)
    assert tuple(t.shape) == shape, what
    assert str(ref_struct.dtype) == str(t.dtype).replace("torch.", ""), what


def _ref_param(pc, tree, name):
    """The reference's leaf of the port's parameter ``name`` (the mapping
    of ``carry.ref_leaf``) and whether it is stacked over superblocks."""
    parts = name.split(".")
    if parts[0] in ("layers", "cross", "enc_layers"):
        i = int(parts[1])
        if parts[0] == "enc_layers":
            node = tree["enc_blocks"]["sub0"]
        else:
            sub = "sub" if parts[0] == "layers" else "cross"
            node = tree["blocks"][f"{sub}{i % pc.superblock_period()}"]
        parts, stacked = parts[2:], True
    else:
        node, stacked = tree, False
    for key in parts:
        node = _child(node, key)
    return node, stacked


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_helpers_are_the_reference_specs(arch):
    """``param_specs``, ``train_state_specs`` (AdamW), ``make_batch_specs``
    and ``make_decode_specs`` at FULL size with tp 16, for every shape of
    ``SHAPES``: meta tensors of the reference's shapes and dtypes."""
    rc, pc = ref_config(arch), get_config(arch)
    tp = 16
    rparams = ref_steps.param_specs(rc, tp=tp)
    model = steps.param_specs(pc, tp=tp)
    for n, p in model.named_parameters():
        assert p.device.type == "meta"
        _same(*_ref_param(pc, rparams, n)[:1], p, n,
              _ref_param(pc, rparams, n)[1])
    rstate = ref_steps.train_state_specs(rc, ref_steps.TrainStepConfig(),
                                         tp=tp)
    state = steps.train_state_specs(pc, steps.TrainStepConfig(), tp=tp)
    assert state["step"] == 0 and tuple(rstate["step"].shape) == ()
    for f in ("m", "v"):
        for n, t in getattr(state["opt"], f).items():
            node, stacked = _ref_param(pc, getattr(rstate["opt"], f), n)
            _same(node, t, f"{f}/{n}", stacked)
    assert set(mcfg.SHAPES) == set(ref_mcfg.SHAPES)
    period = pc.superblock_period()
    for name, shp in mcfg.SHAPES.items():
        if shp.kind in ("train", "prefill"):
            rb = ref_steps.make_batch_specs(rc, shp.global_batch, shp.seq_len)
            pb = steps.make_batch_specs(pc, shp.global_batch, shp.seq_len)
            assert set(rb) == set(pb), name
            for k, t in pb.items():
                _same(rb[k], t, f"{name}/{k}", False)
            continue
        rtok, rst = ref_steps.make_decode_specs(rc, shp.global_batch,
                                                shp.seq_len, tp=tp)
        ptok, pst = steps.make_decode_specs(pc, shp.global_batch,
                                            shp.seq_len, tp=tp)
        _same(rtok, ptok, f"{name}/token", False)
        for group, sub in (("layers", "sub"), ("cross", "cross")):
            for i, caches in enumerate(pst.get(group, ())):
                for k, t in caches.items():
                    _same(rst[f"{sub}{i % period}"][k], t,
                          f"{name}/{group}{i}/{k}", True)


def _port_flops(pc, kind, shape=(1, 1), batch=B, seq=S):
    return dryrun.cost_step(pc, kind, batch, seq, shape,
                            ("data", "model"))["flops"]


@pytest.mark.parametrize("arch,kind", [(a, k) for a in DENSE for k in KINDS])
def test_dense_dot_flops_match_the_references_hlo(arch, kind):
    rc, pc = smoke_pair(arch)
    port = _port_flops(pc, kind)
    ref = reference_flops(rc, kind, B, S)
    assert abs(port - ref) <= 0.01 * ref, (port, ref)


def _lookup_only(cfg) -> int:
    """Parameters a serving step reads without a matmul: the embedding
    table when the head is its own weight."""
    return 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model


def _encoder_side(cfg) -> int:
    """An encoder-decoder's parameters a decode step does not multiply
    by: the encoder and each cross-attention's K/V projections (their
    products were cached by the prefill)."""
    if not cfg.encoder_layers:
        return 0
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * cfg.num_heads * hd * 2 + 2 * d * cfg.num_kv_heads * hd
    enc = cfg.encoder_layers * (2 * d + attn + 3 * d * cfg.d_ff) + d
    return enc + cfg.num_layers * 2 * d * cfg.num_kv_heads * hd


OTHERS = [a for a in ARCH_IDS if a not in DENSE]


@pytest.mark.parametrize("arch,kind", [(a, k) for a in OTHERS
                                       for k in KINDS])
def test_dot_flops_cover_the_models_matmuls(arch, kind):
    """A train step's count is at least 6·N_active a token.  A serving
    step multiplies by every active weight once a token but the
    embedding table's lookup, the head at the last position only, and
    (decode) neither the encoder nor the cross K/V projections: at least
    2·(N_active − those) a token plus the head's rows."""
    _, pc = smoke_pair(arch)
    got = _port_flops(pc, kind)
    if kind == "train":
        assert got >= model_flops(pc, kind, B, S)
        return
    head = pc.vocab_size * pc.d_model
    body = pc.active_param_count() - _lookup_only(pc) - head
    if kind == "prefill":
        want = 2 * body * B * S + 2 * head * B
    else:
        want = 2 * (body - _encoder_side(pc) + head) * B
    assert got >= want, (got, want)


def _split_config():
    """A dense config whose heads, KV heads, d_ff, vocabulary and d_model
    divide by 16."""
    _, pc = smoke_pair("tinyllama-1.1b")
    return dataclasses.replace(pc, num_heads=16, num_kv_heads=16,
                               head_dim=8, d_model=64, d_ff=256,
                               vocab_size=512)


def _kv_flops(cfg, kind, batch, seq):
    """One device's FLOPs of the K and V projections in a step (training:
    the forward, remat's recompute and the two backward products)."""
    tokens = batch * (1 if kind == "decode" else seq)
    fwd = cfg.num_layers * 2 * tokens * cfg.d_model * 2 * \
        cfg.num_kv_heads * cfg.head_dim
    return 4 * fwd if kind == "train" else fwd


@pytest.mark.parametrize("shape", [(2, 2), (16, 16)],
                         ids=["2x2", "16x16"])
@pytest.mark.parametrize("kind", KINDS)
def test_rank_flops_times_ranks_are_one_devices(shape, kind):
    cfg = _split_config()
    batch, seq = 2 * shape[0], 64
    one = _port_flops(cfg, kind, (1, 1), batch, seq)
    rank = _port_flops(cfg, kind, shape, batch, seq)
    tp = shape[1]
    assert rank * math.prod(shape) == one + (tp - 1) * _kv_flops(
        cfg, kind, batch, seq)


def test_counter_counts_what_a_gloo_step_moves(tmp_path):
    """One decode step of tinyllama SMOKE (B 4, a cache of 16 slots) on
    a (2, 2) mesh: the collectives ``count_collectives`` records on each
    of four gloo ranks, call for call (kind, axis, bytes, within one
    host), are those the dry run records on a fake (2, 2) group."""
    case = dict(name="cnt", kind="count", arch="tinyllama-1.1b",
                shape=[2, 2], names=["data", "model"], batch=4, prompt=9,
                cache_len=16)
    np.savez(tmp_path / "in.npz", cases=np.array(json.dumps([case])))
    procs = ranks_mod.start(4, tmp_path / "in.npz", tmp_path / "ranks")
    try:
        pc = ranks_mod.case_config(case)
        world = []
        for r in range(4):
            with dryrun.fake_group(4, r):
                from torch.distributed.device_mesh import DeviceMesh
                from repro_torch.core import mesh as mesh_mod
                mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                  mesh_dim_names=("data", "model"))
                model = steps.param_specs(pc, mesh=mesh)
                token, state = steps.make_decode_specs(pc, 4, 16, mesh=mesh)
                state["pos"] = 9
                with mesh_mod.count_collectives() as c:
                    steps.make_decode_step(pc)(model, token, state)
                world.append(c.calls)
        outs = ranks_mod.collect(procs, tmp_path / "ranks", timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, out in enumerate(outs):
        calls = json.loads(str(out["cnt/calls"]))
        assert calls == world[r] and len(calls) > 0
        assert not any(c[3] for c in calls)         # 4 ranks: one host
    rec = dryrun.cost_step(pc, "decode", 4, 16, (2, 2), ("data", "model"))
    assert rec["collectives"]["num_ops"] == len(world[0])
    assert rec["collectives"]["total"] == sum(c[2] for c in world[0])


def _records():
    """Records in the reference's form (``hlo_tripaware`` counts) for a
    dense, an MoE, a hybrid and an encoder-decoder cell of every kind,
    and a skipped one."""
    out = []
    rng = np.random.default_rng(0)
    for arch, shape in (("llama3.2-3b", "train_4k"),
                        ("qwen3-moe-235b-a22b", "decode_32k"),
                        ("jamba-v0.1-52b", "long_500k"),
                        ("seamless-m4t-large-v2", "prefill_32k"),
                        ("mamba2-130m", "decode_32k")):
        rc = ref_config(arch)
        shp = ref_mcfg.SHAPES[shape]
        flops, coll = float(rng.uniform(1e12, 1e15)), float(
            rng.uniform(1e8, 1e11))
        out.append({
            "arch": arch, "shape": shape, "mesh": "(16,16)", "status": "ok",
            "devices": 256, "kind": shp.kind,
            "global_batch": shp.global_batch, "seq_len": shp.seq_len,
            "active_param_count": rc.active_param_count(),
            "memory": {"argument_bytes": 3e9, "output_bytes": 2e9,
                       "temp_bytes": 1e9, "alias_bytes": 2e9},
            "hlo_tripaware": {"flops": flops, "bytes": 5e12,
                              "collective_bytes": coll,
                              "collective_dcn_bytes": coll / 3}})
    out.append({"arch": "llama3.2-3b", "shape": "long_500k",
                "mesh": "(16,16)", "status": "skipped",
                "reason": "full-attention arch"})
    return out


def test_roofline_with_v5e_constants_is_the_references():
    for rec in _records():
        assert roofline.roofline_terms(rec, **V5E) == \
            ref_roofline.roofline_terms(rec), rec["arch"]
        if rec["status"] == "ok":
            assert roofline.analytic_hbm_bytes(rec) == \
                ref_roofline.analytic_hbm_bytes(rec)


def test_run_cell_skips_what_the_reference_skips():
    """Every (arch × shape) the reference's ``shape_applicable`` refuses
    is recorded as skipped with the port's reason (the reference's words
    without its design-doc pointer), and no other; a cell that runs
    records the reference's fields."""
    for arch in ARCH_IDS:
        for shape in mcfg.SHAPES:
            ok = ref_mcfg.shape_applicable(ref_config(arch), shape)[0]
            mine, why = mcfg.shape_applicable(get_config(arch), shape)
            assert mine == ok, (arch, shape)
            if not ok:
                rec = dryrun.run_cell(arch, shape, False)
                assert rec["status"] == "skipped" and rec["reason"] == why
                assert why.startswith("full-attention arch")
    rec = dryrun.run_cell("mamba2-130m", "long_500k", False)
    assert rec["status"] == "ok", rec.get("traceback")
    for key in ("memory", "collectives", "counts", "param_count",
                "active_param_count", "global_batch", "seq_len", "kind",
                "devices"):
        assert key in rec, key
    assert rec["devices"] == 256 and rec["memory"]["temp_bytes"] is None
    assert roofline.roofline_terms(rec)["status"] == "ok"


def test_dryrun_and_roofline_clis(tmp_path, capsys):
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "llama3.2-3b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    roofline.main(["--results", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[ok] tinyllama-1.1b__decode_32k__1pod" in out
    assert "[skipped] llama3.2-3b__long_500k__1pod" in out
    rows = [ln for ln in out.splitlines() if ln.startswith("| ")]
    assert len(rows) == 3 and "skipped" in rows[1]


def test_sns_dryrun_counts_the_merge_and_the_gather():
    """``geo_extract``'s program on rank 0 of (16, 16): the sketch merge
    is one (R, C) f32 all-reduce an axis, the candidates' gather moves the
    pool of 16 ranks, then of all 256 (keys, counts and masks)."""
    rec = sns_dryrun.cost(per_device=4096, rows=4, log2_cols=10, top_k=64)
    kinds = rec["counts"]["per_kind"]
    assert kinds["all-reduce"] == 2 * 4 * 1024 * 4
    per_cand = 8 + 8 + 4 + 1
    assert kinds["all-gather"] == 128 * per_cand * (16 + 256)
    assert rec["counts"]["flops"] == 0.0
    assert rec["roofline"]["bottleneck"] in ("memory", "collective")
    assert rec["points_per_step"] == 256 * 4096

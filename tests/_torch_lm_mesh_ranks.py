"""One rank of the LM stack's mesh tier, for tests/test_torch_lm_mesh.py,
tests/test_torch_lm_serve_mesh.py, tests/test_torch_dryrun.py (CPU
ranks, gloo) and tests/test_torch_cuda_lm_mesh.py (card ranks).
Imports no jax: the card machine has none.

    python tests/_torch_lm_mesh_ranks.py JOB RANK WORLD INIT_METHOD IN OUT

Every rank runs every case the ``IN`` .npz names (``cases``: a JSON list;
each case's arrays under ``<case>/...``) and writes what it computed to
``OUT/rank<R>.npz``, each array under ``<case>/...``; on an error the
traceback goes to ``OUT/rank<R>.err`` (exit code 1).  ``start`` and
``collect`` are ``_torch_mesh_ranks``'s.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from _torch_mesh_ranks import collect  # noqa: E402


def start(world: int, inputs: Path, out: Path, job: str = "cases") -> list:
    """Start ``world`` rank processes of this script (rendezvous through a
    file in ``out``); ``collect`` waits for them."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src")] + ([env["PYTHONPATH"]]
                                      if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init = f"file://{out / 'rendezvous'}"
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__)), job, str(r), str(world), init,
         str(inputs), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def spawn(world: int, inputs: Path, out: Path, timeout: float = 300.0,
          job: str = "cases") -> list:
    return collect(start(world, inputs, out, job), out, timeout)


def case_config(case: dict):
    from repro_torch.configs import get_config
    cfg = get_config(case["arch"], smoke=True)
    return dataclasses.replace(cfg, param_dtype=case.get("dtype", "float32"),
                               compute_dtype=case.get("dtype", "float32"),
                               **case.get("overrides", {}))


def _np(t):
    import torch
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


class Ranks:
    """This rank's meshes, built once over the default group."""

    def __init__(self, rank: int, world: int, init: str, device: str,
                 backend: str):
        self.rank, self.world, self.init = rank, world, init
        self.device, self.backend = device, backend
        self.meshes = {}

    def mesh(self, shape, names):
        from repro_torch.launch.mesh import make_host_mesh
        key = (tuple(shape), tuple(names))
        if key not in self.meshes:
            self.meshes[key] = make_host_mesh(
                key[0], key[1], rank=self.rank, init_method=self.init,
                backend=self.backend)
        return self.meshes[key]


def train_case(rk: Ranks, case: dict, inp: dict, pre: str) -> dict:
    """One sharded train step of ``case``: the global batch's loss and
    metrics, this rank's blocks of every gradient (before the update),
    of every weight and optimizer statistic after it."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import tp_size
    from repro_torch.models import model as model_mod
    from repro_torch.train import steps

    cfg = case_config(case)
    mesh = rk.mesh(case["shape"], case["names"])
    pol = sh.ShardingPolicy(act_mode=case["act_mode"],
                            fsdp=case.get("fsdp", True))
    tp = tp_size(mesh)
    dev = torch.device(rk.device)
    model = model_mod.LM(cfg, tp, device=dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(inp[f"{pre}/w/{n}"]))
    sh.shard_model(model, mesh, pol)
    model.requires_grad_(True)
    keys = [k.split("/", 2)[2] for k in inp if k.startswith(f"{pre}/b/")]
    full = {k: torch.from_numpy(inp[f"{pre}/b/{k}"]).to(dev) for k in keys}
    specs = sh.batch_pspecs(full, mesh)
    batch = {k: sh.local_shard(v, specs[k], mesh).to(dev)
             for k, v in full.items()}
    tcfg = steps.TrainStepConfig(**case["tcfg"])
    out = {}
    # the gradients alone, as the step syncs them
    model.zero_grad(set_to_none=True)
    total, _ = model_mod.forward_train(cfg, model, batch,
                                       q_chunk=tcfg.q_chunk, remat=tcfg.remat)
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    steps.sync_grads(grads, model.specs, mesh)
    for n, g in grads.items():
        out[f"g/{n}"] = _np(g)
    model.zero_grad(set_to_none=True)
    state = {"model": model,
             "opt": steps.init_optimizer(cfg, tcfg, model), "step": 0}
    state, metrics = steps.make_train_step(cfg, tcfg)(state, batch)
    for k, v in metrics.items():
        out[f"m/{k}"] = np.float64(float(v))
    for n, p in model.named_parameters():
        out[f"p/{n}"] = _np(p)
    opt = state["opt"]
    for f in ("m", "v") if hasattr(opt, "m") else ("vr", "vc"):
        for n, t in getattr(opt, f).items():
            out[f"o/{f}/{n}"] = _np(t)
    return out


def draw_case(rk: Ranks, case: dict, inp: dict, pre: str) -> dict:
    """``init_params(mesh=)``: this rank's blocks of the weights drawn from
    seed 3, each part cut as it is drawn; and ``embed_rows`` of the
    tokens through the vocab-parallel lookup."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as model_mod

    cfg = case_config(case)
    mesh = rk.mesh(case["shape"], case["names"])
    model = model_mod.init_params(cfg, torch.Generator().manual_seed(3),
                                  device="cpu", mesh=mesh,
                                  policy=sh.ShardingPolicy())
    out = {f"w/{n}": _np(p) for n, p in model.named_parameters()}
    out["rows"] = _np(model_mod.embed_rows(
        model, torch.from_numpy(inp[f"{pre}/tokens"])))
    return out


def moe_case(rk: Ranks, case: dict, inp: dict, pre: str) -> dict:
    """One MoE layer on the mesh: this rank's rows of x through the sharded
    layer; its output rows and the global dropped share."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.models import moe as moe_mod

    cfg = case_config(case)
    mesh = rk.mesh(case["shape"], case["names"])
    layer = moe_mod.Moe(cfg.d_model, cfg.num_experts, cfg.expert_ff,
                        cfg.pdtype, device="cpu")
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(torch.from_numpy(inp[f"{pre}/w/{n}"]))
    sh.shard_model(layer, mesh, sh.ShardingPolicy())
    with torch.no_grad():        # the FSDP blocks, gathered as a layer runs
        for n, t in sh.gather_layer(layer, layer.par, layer.specs,
                                    "").items():
            layer._parameters[n] = torch.nn.Parameter(t)
    x = torch.from_numpy(inp[f"{pre}/x"])
    xl = sh.local_shard(x, (dp_axes(mesh), None, None), mesh)
    with torch.no_grad():
        y, routing = moe_mod.moe_apply(layer, xl, top_k=cfg.moe_top_k,
                                       capacity_factor=cfg.capacity_factor)
        aux = moe_mod.moe_aux(routing, layer.par)
    return {"y": _np(y), "dropped": np.float64(float(aux.dropped_frac)),
            "lb": np.float64(float(aux.load_balance_loss)),
            "z": np.float64(float(aux.z_loss))}


def sketch_case(rk: Ranks, case: dict, inp: dict, pre: str) -> dict:
    """``compress_and_reduce(axis_names=("data",))`` on this data rank's
    integer-valued gradient: the merged table, the rank's own table, and
    what decompress sent; then ``ActivationSketcher.merged`` over the
    same axis on this rank's activations."""
    import torch
    from repro_torch.optim import sketch_compress as sc
    from repro_torch.train.callbacks import ActivationSketcher

    mesh = rk.mesh(case["shape"], case["names"])
    d = mesh.get_local_rank("data")
    keys = sorted(k.split("/", 2)[2] for k in inp
                  if k.startswith(f"{pre}/g{d}/"))
    grads = {k: torch.from_numpy(inp[f"{pre}/g{d}/{k}"]) for k in keys}
    ccfg = sc.SketchCompressConfig(**case["ccfg"])
    state = sc.sketch_compress_init(grads, ccfg)
    own = sc.local_sketch(grads, state, ccfg).table.clone()
    merged = sc.merged_sketch(grads, state, ccfg, ("data",), mesh).table
    fgrads = {k: torch.from_numpy(inp[f"{pre}/f{d}/{k}"]) for k in keys}
    f_own = sc.local_sketch(fgrads, state, ccfg).table.clone()
    f_merged = sc.merged_sketch(fgrads, state, ccfg, ("data",), mesh).table
    upd, state, density = sc.compress_and_reduce(
        grads, state, ccfg, axis_names=("data",), mesh=mesh)
    mon = ActivationSketcher(device="cpu", log2_cols=10)
    mon.observe(torch.from_numpy(inp[f"{pre}/acts{d}"]))
    mine = mon._sk.table.clone()
    act = mon.merged(mesh=mesh, axes=("data",))
    return {"own": own.numpy(), "merged": merged.numpy(),
            "f_own": f_own.numpy(), "f_merged": f_merged.numpy(),
            "density": np.float64(float(density)),
            "error": state.error.numpy(),
            "act_own": mine.numpy(), "act_merged": act.table.numpy(),
            **{f"u/{k}": v.numpy() for k, v in upd.items()}}


def ckpt_case(rk: Ranks, case: dict, inp: dict, pre: str) -> dict:
    """Two steps of a ``Trainer`` on the mesh with a checkpoint after each;
    then a Trainer resumed from step 1 on the same mesh, run to step 2.
    Returns the gathered weights after step 2 (both runs) and the
    checkpoint directory."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.train.steps import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig, state_tree

    cfg = case_config(case)
    mesh = rk.mesh(case["shape"], case["names"])
    pol = sh.ShardingPolicy(act_mode=case["act_mode"])
    tcfg = TrainStepConfig(**case["tcfg"])
    batches = {}
    for k in inp:
        if k.startswith(f"{pre}/b"):
            step, name = k[len(pre) + 2:].split("/")
            batches.setdefault(int(step), {})[name] = torch.from_numpy(inp[k])

    def run(ckpt_dir, total, every):
        rc = TrainerConfig(ckpt_dir=ckpt_dir, total_steps=total,
                           ckpt_every=every, log_every=1)
        tr = Trainer(cfg, tcfg, rc, lambda s: batches[s], device="cpu",
                     mesh=mesh, policy=pol)
        start = tr.start_step
        tr.run()
        return start, state_tree(tr.state, full=True)

    root = Path(case["dir"])
    _, a = run(str(root / "a"), 2, 1)
    if rk.rank == 0:                # the resume starts from step 1
        import shutil
        shutil.copytree(root / "a", root / "b")
        shutil.rmtree(root / "b" / "step_00000002")
    torch.distributed.barrier()
    start, b = run(str(root / "b"), 2, 1)
    out = {"start": np.int64(start)}
    for n, t in a["params"].items():
        out[f"a/{n}"] = _np(t)
        out[f"b/{n}"] = _np(b["params"][n])
    return out


class Largest:
    """Context: the bytes of the largest tensor any op returns while it is
    open (a dispatch mode; views count as their own size)."""

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        outer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        outer.most = max(outer.most,
                                         t.numel() * t.element_size())
                return out
        self.most = 0
        self.mode = _Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def serve_case(rk: Ranks, case: dict, inp: dict, pre: str) -> dict:
    """Sharded prefill of the whole batch (``make_prefill_step(mesh=)``)
    and one decode step a column of ``teacher`` (B, steps): each step's
    logits (the rank's rows), the MoE layers' dropped share of each
    decode step, the rank's cache blocks after the last step, the largest
    tensor the rank allocated, and whether a decode past the cache's end
    raised (``case["overflow"]``)."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import tp_size
    from repro_torch.models import model as model_mod
    from repro_torch.train import steps

    cfg = case_config(case)
    mesh = rk.mesh(case["shape"], case["names"])
    dev = torch.device(rk.device)
    w = case.get("weights", pre)
    model = model_mod.LM(cfg, tp_size(mesh), device=dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(inp[f"{w}/w/{n}"]))
    sh.shard_model(model, mesh, sh.ShardingPolicy())
    keys = [k[len(pre) + 3:] for k in inp if k.startswith(f"{pre}/b/")]
    batch = {k: torch.from_numpy(inp[f"{pre}/b/{k}"]).to(dev) for k in keys}
    teacher = torch.from_numpy(inp[f"{pre}/teacher"]).to(dev)
    prefill = steps.make_prefill_step(cfg, case["cache_len"], mesh=mesh)
    out = {}
    with Largest() as big:
        logits, state = prefill(model, batch)
        out["l0"] = _np(logits)
        lay = state["layout"]
        for i in range(teacher.shape[1]):
            aux = {k: torch.zeros((), device=dev)
                   for k in ("lb_loss", "z_loss", "dropped")}
            with torch.inference_mode():
                logits, state = model_mod.forward_step(
                    cfg, model, lay.rows(teacher[:, i])[:, None], state,
                    aux=aux)
            out[f"l{i + 1}"] = _np(logits)
            out[f"drop{i + 1}"] = np.float64(float(aux["dropped"]))
    out["largest"] = np.int64(big.most)
    out["pos"] = np.int64(state["pos"])
    for group in ("layers", "cross"):
        for i, c in enumerate(state.get(group, ())):
            for k, t in c.items():
                out[f"c/{group}/{i}/{k}"] = _np(t)
    if case.get("overflow"):
        try:
            model_mod.forward_step(cfg, model,
                                   lay.rows(teacher[:, -1])[:, None], state)
            out["raised"] = np.int64(0)
        except ValueError:
            out["raised"] = np.int64(1)
    return out


def count_case(rk: Ranks, case: dict, inp: dict, pre: str) -> dict:
    """One decode step of ``case`` after its prefill, under
    ``core.mesh.count_collectives``: each call's kind, axes, bytes and
    whether it crosses a host, in order."""
    import torch
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import tp_size
    from repro_torch.models import model as model_mod
    from repro_torch.train import steps

    cfg = case_config(case)
    mesh = rk.mesh(case["shape"], case["names"])
    model = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu", mesh=mesh)
    b, s = case["batch"], case["prompt"]
    tokens = torch.arange(b * s).reshape(b, s) % cfg.vocab_size
    prefill = steps.make_prefill_step(cfg, case["cache_len"], mesh=mesh)
    logits, state = prefill(model, {"tokens": tokens})
    token = torch.argmax(logits, -1)[:, None]
    with mesh_mod.count_collectives() as counter:
        steps.make_decode_step(cfg)(model, token, state)
    return {"calls": np.array(json.dumps(counter.calls)),
            "tp": np.int64(tp_size(mesh))}


KINDS = {"train": train_case, "draw": draw_case, "moe": moe_case,
         "sketch": sketch_case, "ckpt": ckpt_case, "serve": serve_case,
         "count": count_case}


def cases(rank: int, world: int, init: str, inp: dict) -> dict:
    import torch
    torch.set_num_threads(1)
    device = str(inp.get("device", np.array("cpu")))
    backend = str(inp.get("backend", np.array("gloo")))
    if device.startswith("cuda"):
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        device = f"cuda:{rank if backend == 'nccl' else 0}"
        torch.backends.cuda.matmul.allow_tf32 = False    # f32 twins
        torch.backends.cudnn.allow_tf32 = False
    rk = Ranks(rank, world, init, device, backend)
    out = {}
    for case in json.loads(str(inp["cases"])):
        pre = case["name"]
        res = KINDS[case["kind"]](rk, case, inp, pre)
        out.update({f"{pre}/{k}": v for k, v in res.items()})
    return out


def main(argv) -> int:
    job, rank, world, init, inputs, out = argv
    rank, world, out = int(rank), int(world), Path(out)
    try:
        with np.load(inputs) as z:
            inp = {k: z[k] for k in z.files}
        res = {"cases": cases}[job](rank, world, init, inp)
        np.savez(out / f"rank{rank}.npz", **res)
    except Exception:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        return 1
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

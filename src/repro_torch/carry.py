"""Carry the reference's random draws, and its streaming states, across.

This system has no weights: its "parameters" are the random draws the
reference makes with JAX's threefry — hash parameters, cell-keyed replica
jitter, the tSNE and UMAP inits, UMAP's per-epoch negative samples and the
approximate kNN's rotations, window offsets and descent slots.  The port
reproduces threefry for the hash parameters and the replica jitter
(``core.prng``); the others it draws from ``torch.Generator``s (and, for
the descent slots, a counter hash).  Where a test holds the port to the
reference bit for bit, it makes the reference's draws with JAX, hands
them over as numpy, and these functions turn them into the port's
types.
:func:`ingest_state_from_numpy` does the same for a streaming fold's
state, so the port can finish a stream the reference began,
:func:`lm_params_from_numpy` for the LM stack's weights and
:func:`train_state_from_numpy` for its train state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import u64
from repro_torch.core.ann import AnnDraws
from repro_torch.core.candidates import Candidates
from repro_torch.core.hashing import MulShiftParams
from repro_torch.core.pipeline import Draws
from repro_torch.core.sketch import CountSketch
from repro_torch.core.stream import IngestState
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdafactorState, AdamWState
from repro_torch.train.steps import TrainStepConfig, init_optimizer


def hash_params_from_numpy(a1_hi, a1_lo, a2_hi, a2_lo, b_hi, b_lo,
                           device="cpu") -> MulShiftParams:
    """Six (R,) uint32 arrays (the reference's ``MulShiftParams`` fields,
    in order) -> the port's int64-limb params on ``device``."""
    return MulShiftParams(*[u64.from_numpy(p).to(device) for p in
                            (a1_hi, a1_lo, a2_hi, a2_lo, b_hi, b_lo)])


def draws_from_numpy(hash_params=None, jitter: Optional[np.ndarray] = None,
                     umap_init: Optional[np.ndarray] = None,
                     negatives: Optional[np.ndarray] = None,
                     tsne_init: Optional[np.ndarray] = None,
                     ann_rotations: Optional[np.ndarray] = None,
                     ann_offsets: Optional[np.ndarray] = None,
                     ann_row_draws: Optional[np.ndarray] = None,
                     device="cpu") -> Draws:
    """Build :class:`pipeline.Draws` from numpy: ``hash_params`` as six
    uint32 arrays, ``jitter`` (K, max_replicas, D), ``umap_init`` and
    ``tsne_init`` (N_reps, dims), ``negatives`` (n_epochs, E, neg_rate),
    and the approximate kNN's draws (see :func:`ann_draws_from_numpy`)."""
    def f32(x):
        return None if x is None else torch.as_tensor(
            np.array(x, np.float32), device=device)
    ann = None if (ann_rotations is None and ann_offsets is None
                   and ann_row_draws is None) else ann_draws_from_numpy(
        ann_rotations, ann_offsets, ann_row_draws, device=device)
    return Draws(
        hash_params=None if hash_params is None
        else hash_params_from_numpy(*hash_params, device=device),
        jitter=f32(jitter), umap_init=f32(umap_init),
        negatives=_i64(negatives, device), tsne_init=f32(tsne_init), ann=ann)


def _i64(x, device="cpu") -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(np.array(x, np.int64),
                                                  device=device)


def ann_draws_from_numpy(rotations: Optional[np.ndarray] = None,
                         offsets: Optional[np.ndarray] = None,
                         row_draws: Optional[np.ndarray] = None,
                         device="cpu") -> AnnDraws:
    """:class:`ann.AnnDraws` from numpy: the rotations after QR (probes,
    D, D) (``jnp.linalg.qr`` and ``torch.linalg.qr`` may pick other
    signs), the reverse-window offsets (iters, N) and the descent slots
    (iters, N, m + 2m²)."""
    return AnnDraws(
        rotations=None if rotations is None else torch.as_tensor(
            np.array(rotations, np.float32), device=device),
        offsets=_i64(offsets, device), row_draws=_i64(row_draws, device))


def ingest_state_from_numpy(state, device="cpu") -> IngestState:
    """The reference's ``stream.IngestState`` (its arrays as numpy, or
    anything ``np.asarray`` takes) -> the port's, on ``device``: the
    sketch table and hash params, the key-sorted reservoir, the count and
    the eviction watermark.  ``stream.load_state`` carries states across
    through the shared checkpoint format as well."""
    def t(x, dtype):
        return torch.from_numpy(np.array(x).astype(dtype)).to(device)
    sk, c = state.sketch, state.cands
    return IngestState(
        sketch=CountSketch(table=t(sk.table, np.float32),
                           params=hash_params_from_numpy(*sk.params,
                                                         device=device)),
        cands=Candidates(key_hi=t(c.key_hi, np.int64),
                         key_lo=t(c.key_lo, np.int64),
                         count=t(c.count, np.float32), mask=t(c.mask, bool)),
        count=t(state.count, np.float32),
        evict_max=t(state.evict_max, np.float32))


def tensor_from_numpy(a) -> torch.Tensor:
    """A numpy (or JAX) array -> a CPU tensor of a copy; bf16
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) through
    its 16 bits, losslessly."""
    a = np.array(a)                     # a writable, contiguous copy
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
        if a.dtype.name == "bfloat16" else torch.from_numpy(a)


def _weight(leaf, like: torch.Tensor) -> torch.Tensor:
    """One numpy leaf -> a tensor of ``like``'s shape and dtype."""
    t = tensor_from_numpy(leaf)
    if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
        raise ValueError(f"weight {tuple(t.shape)} {t.dtype} does not fit "
                         f"{tuple(like.shape)} {like.dtype}")
    return t


def _child(node, key: str):
    return node[key] if isinstance(node, dict) else getattr(node, key)


@torch.no_grad()
def _load(module: torch.nn.Module, fields, s: Optional[int] = None) -> None:
    """Copy each of ``module``'s own parameters from the field (or dict key)
    of the same name in ``fields``, taking superblock ``s`` of a stacked
    leaf (the layer tests load one module this way)."""
    for name, param in module.named_parameters(recurse=False):
        leaf = _child(fields, name)
        param.copy_(_weight(leaf if s is None else leaf[s], param))


def ref_leaf(cfg: ModelConfig, tree, name: str, like_shape) -> np.ndarray:
    """The reference leaf of the port's parameter ``name`` in ``tree`` (a
    params-shaped pytree of numpy leaves): ``layers.{i}.<path>`` is
    superblock s's slice of ``blocks/sub{j}/<path>`` (i = s·period + j),
    ``cross.{i}`` of ``blocks/cross{j}``, ``enc_layers.{i}`` of
    ``enc_blocks/sub0``.  A leaf of ``like_shape``'s rank is not stacked
    (Adafactor's (1,) column stats of an unfactored leaf) and is taken
    whole."""
    parts = name.split(".")
    s = None
    if parts[0] in ("layers", "cross", "enc_layers"):
        i = int(parts[1])
        if parts[0] == "enc_layers":
            node, s = tree["enc_blocks"]["sub0"], i
        else:
            s, j = divmod(i, cfg.superblock_period())
            sub = "sub" if parts[0] == "layers" else "cross"
            node = tree["blocks"][f"{sub}{j}"]
        parts = parts[2:]
    else:
        node = tree
    for key in parts:
        node = _child(node, key)
    leaf = np.asarray(node)
    return leaf if s is None or leaf.ndim == len(like_shape) else leaf[s]


def lm_params_from_numpy(cfg: ModelConfig, tree, device="cpu", tp: int = 1,
                         mesh=None, policy=None) -> model_mod.LM:
    """The reference's ``init_params(key, cfg, tp)`` pytree, its leaves as
    numpy (``jax.tree.map(np.asarray, params)``) -> the port's model on
    ``device``.  ``blocks/sub{j}`` (and ``cross{j}``) are stacked over
    superblocks: superblock s's sub-layer j is layer ``s·period + j``.  The
    ``AttnParams``, ``MlpParams``, ``MoeParams`` and ``SsmParams`` fields
    map one to one onto the modules' parameters of the same names.  With
    a ``mesh`` the model is this rank's blocks of it under ``policy``
    (``launch.sharding.shard_model``; ``tp`` is the mesh's "model" size,
    which the tree must be padded for)."""
    from repro_torch.launch import sharding as sh
    if mesh is not None:
        from repro_torch.launch.mesh import tp_size
        tp = tp_size(mesh)
    model = model_mod.LM(cfg, tp, "meta" if mesh is not None else device)
    if mesh is not None:
        model.to_empty(device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(_weight(ref_leaf(cfg, tree, name, p.shape), p))
    if mesh is not None:
        sh.shard_model(model, mesh, policy or sh.ShardingPolicy())
        model.to(device)
    return model


def train_state_from_numpy(cfg: ModelConfig, ref_state, device="cpu",
                           mesh=None, policy=None):
    """The reference's ``init_train_state`` (or a later train state), its
    leaves as numpy, -> the port's train state on ``device``: the model
    (as :func:`lm_params_from_numpy`), the optimizer's state (AdamW's
    ``m``/``v``, or Adafactor's ``vr``/``vc``/``factored``, per layer
    from the reference's stacked leaves) and the step.  With a ``mesh``:
    this rank's blocks of the weights and of AdamW's moments, and
    Adafactor's statistics whole."""
    model = lm_params_from_numpy(cfg, ref_state["params"], device,
                                 mesh=mesh, policy=policy)
    model.requires_grad_(True)
    opt = ref_state["opt"]
    specs = getattr(model, "specs", None)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    if specs is not None:
        from repro_torch.launch.sharding import full_shape
        shapes = {n: full_shape(s, specs[n], mesh) for n, s in shapes.items()}

    def stats(tree, like_shapes, blocks=False):
        out = {}
        for n, shape in like_shapes.items():
            t = torch.from_numpy(np.array(ref_leaf(cfg, tree, n, shape),
                                          np.float32))
            if blocks and specs is not None:
                from repro_torch.launch.sharding import local_shard
                t = local_shard(t, specs[n], mesh)
            out[n] = t.to(device)
        return out

    if hasattr(opt, "m"):
        state = AdamWState(step=int(opt.step), m=stats(opt.m, shapes, True),
                           v=stats(opt.v, shapes, True))
    else:
        zero = init_optimizer(cfg, TrainStepConfig(optimizer="adafactor"),
                              model)
        factored = {n: bool(ref_leaf(cfg, opt.factored, n, ()))
                    for n in shapes}
        if factored != zero.factored:
            raise ValueError("the reference factors other leaves than the "
                             "port")
        state = AdafactorState(
            step=int(opt.step),
            vr=stats(opt.vr, {n: t.shape for n, t in zero.vr.items()}),
            vc=stats(opt.vc, {n: t.shape for n, t in zero.vc.items()}),
            factored=factored)
    return {"model": model, "opt": state, "step": int(ref_state["step"])}

"""Sharding rules of the LM stack on a mesh (the port of
``repro.launch.sharding``): the parameter, optimizer, batch and
decode-state layouts, the cut of a tensor into a rank's block and back,
and the activation layout at a superblock boundary.

A layout ("spec") is a tuple with one entry a tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the dimension split
over them, row-major).  The table is the reference's ``_leaf_spec``,
keyed by the last component of the port's parameter name (the
reference's field name).  The reference stacks a layer kind's weights
over superblocks and prepends a replicated stacked dimension; the port
keeps one module a layer and drops it.

Baseline policy, as in the reference: weights TP over "model" on heads /
d_ff / experts / d_inner / vocab, FSDP (ZeRO-3) over "data" on the other
large dimension; ``wk``/``wv`` replicated over "model".

How a sharded step computes (``models/``): every rank holds its block of
each weight (:func:`shard_model`).  A layer gathers its FSDP blocks over
"data" when it runs (inside the remat'd superblock, so the backward pass
gathers again and the full layer is never kept); the backward of that
gather is the reduce-scatter of the gradient.  Inside a layer the
activations are replicated over "model": a column-parallel product
enters through ``Par.to_tp`` (the identity; its backward sums the
activation's gradient over "model") and a row-parallel one leaves
through ``Par.from_tp`` (a sum over "model"; its backward is the
identity).  So a weight replicated over "model" gets its whole gradient
on every rank, and a weight replicated over a data axis a share of it,
which the train step sums.  Between superblocks the residual stream is
kept in the layout the policy's ``act_mode`` names (:func:`shard_act_btd`,
read from the model's own ``par``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import mesh as mesh_mod

Axis = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Axis, ...]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True              # shard weights over "data" (ZeRO-3)
    fsdp_axis: str = "data"
    tp_axis: str = "model"
    seq_shard_decode: bool = True  # KV-cache seq over "model"
    # activation layout at superblock boundaries:
    #   "embed_tp": (dp, None, "model")  Megatron-SP style   [baseline]
    #   "seq_tp":   (dp, "model", None)  sequence-parallel blocks
    #   "dp_only":  (dp, None, None)     replicated over model
    act_mode: str = "embed_tp"


ACT_MODES = ("embed_tp", "seq_tp", "dp_only")


def _leaf_spec(name: str, ndim: int, pol: ShardingPolicy) -> Spec:
    """The layout of one parameter; ``name`` is the port's dotted name
    (or the reference's '/'-joined path), its last component the
    reference's field name."""
    fs = pol.fsdp_axis if pol.fsdp else None
    tp = pol.tp_axis
    leaf = name.replace("/", ".").split(".")[-1]
    if leaf in ("embed", "lm_head"):
        return (tp, fs)
    if leaf == "patch_proj":
        return (None, tp)
    if leaf in ("final_norm", "enc_final_norm"):
        return (None,)
    # ---- attention ----
    if leaf == "wq":
        return (fs, tp, None)
    if leaf in ("wk", "wv"):
        return (fs, None, None)           # KV heads may be < TP; replicate
    if leaf == "wo":
        return (tp, None, fs)
    if leaf == "bq":
        return (tp, None)
    if leaf in ("bk", "bv"):
        return (None, None)
    # ---- mlp ----
    if leaf in ("w_gate", "w_up") and ndim == 2:
        return (fs, tp)
    if leaf == "w_down" and ndim == 2:
        return (tp, fs)
    # ---- moe (expert-stacked 3D) ----
    if leaf == "router":
        return (fs, None)
    if leaf in ("w_gate", "w_up"):        # (E, D, F)
        return (tp, fs, None)
    if leaf == "w_down":                  # (E, F, D)
        return (tp, None, fs)
    # ---- ssm ----
    if leaf in ("w_z", "w_x"):
        return (fs, tp)
    if leaf in ("w_b", "w_c", "w_dt"):
        return (fs, None)
    if leaf == "conv_x":
        return (None, tp)
    if leaf in ("conv_b", "conv_c"):
        return (None, None)
    if leaf == "conv_bias_x":
        return (tp,)
    if leaf in ("conv_bias_b", "conv_bias_c"):
        return (None,)
    if leaf in ("a_log", "d_skip", "dt_bias"):
        return (tp,)
    if leaf == "w_out":
        return (tp, fs)
    if leaf == "norm_scale":
        return (tp,)
    if leaf.startswith("norm"):
        return (None,)
    return (None,) * ndim                 # fallback: replicate


# ------------------------------------------------------------ the tables
def param_pspecs(params: Mapping[str, torch.Tensor],
                 pol: ShardingPolicy = ShardingPolicy()) -> Dict[str, Spec]:
    """{name: layout} of a model's parameters (``dict(named_parameters())``
    or any mapping of name to something with a ``.shape``)."""
    return {n: _leaf_spec(n, len(p.shape), pol) for n, p in params.items()}


def opt_pspecs(opt, params: Mapping[str, torch.Tensor],
               pol: ShardingPolicy = ShardingPolicy()):
    """AdamW's ``m``/``v`` mirror the parameters; the step is a scalar;
    Adafactor's row/column statistics (O(sqrt(param)) each) are
    replicated."""
    from repro_torch.optim import AdamWState
    if isinstance(opt, AdamWState):
        specs = param_pspecs(params, pol)
        return AdamWState(step=(), m=dict(specs), v=dict(specs))
    return type(opt)(step=(),
                     vr={n: (None,) * t.ndim for n, t in opt.vr.items()},
                     vc={n: (None,) * t.ndim for n, t in opt.vc.items()},
                     factored={n: () for n in opt.factored})


def train_state_pspecs(state: Mapping[str, Any],
                       pol: ShardingPolicy = ShardingPolicy()
                       ) -> Dict[str, Any]:
    """Layouts of a train state's checkpoint tree (``trainer.state_tree``):
    ``params``, ``opt`` and ``step``.  A sharded model's own ``specs``
    (its mesh's axes only) stand for the parameters and AdamW's
    moments."""
    from repro_torch.optim import AdamWState
    model = state.get("model")
    params = dict(model.named_parameters()) if model is not None \
        else state["params"]
    specs = dict(getattr(model, "specs", None) or param_pspecs(params, pol))
    opt = opt_pspecs(state["opt"], params, pol)
    if isinstance(opt, AdamWState):
        opt = opt._replace(m=dict(specs), v=dict(specs))
    return {"params": specs, "opt": opt, "step": ()}


def _axis(axes: Sequence[str]) -> Axis:
    """A dimension's entry: None for no axis, the name for one (as a
    PartitionSpec normalises it), the tuple for several."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def batch_pspecs(batch: Mapping[str, torch.Tensor], mesh) -> Dict[str, Spec]:
    """Batch dimension over every non-model axis; the rest replicated."""
    from repro_torch.launch.mesh import dp_axes
    dp = _axis(dp_axes(mesh))
    return {k: (dp,) + (None,) * (v.ndim - 1) for k, v in batch.items()}


def _decode_axes(mesh, global_batch: int, pol: ShardingPolicy
                 ) -> Tuple[Axis, Axis]:
    """(the batch's entry, the cache sequence's entry) of a decode state:
    the batch over the data axes when it fills them, the sequence over
    "model" then, and over every axis for a batch that does not (one
    sequence, the only way a 512k-slot cache fits)."""
    from repro_torch.launch.mesh import dp_axes, dp_size
    dp = dp_axes(mesh)
    shardable = global_batch >= dp_size(mesh) and global_batch > 1
    bdim = _axis(dp) if shardable else None
    seq = pol.tp_axis if shardable else _axis(tuple(dp) + (pol.tp_axis,))
    return bdim, seq if pol.seq_shard_decode else None


def _decode_leaf_spec(name: str, ndim: int, bdim: Axis, seq: Axis,
                      pol: ShardingPolicy) -> Spec:
    if name == "k" or name == "v":
        return (bdim, seq, None, None)
    if name == "ssm":
        return (bdim, pol.tp_axis, None, None)
    if name == "conv_x":
        return (bdim, None, pol.tp_axis)
    if name == "conv_bc":
        return (bdim, None, None)
    return (None,) * ndim


def decode_state_pspecs(state: Mapping[str, Any], mesh, global_batch: int,
                        pol: ShardingPolicy = ShardingPolicy()):
    """Layouts of a decode state (``models.model.init_decode_state``): KV
    caches (B, T, KVH, hd), SSM states (B, H, P, N), conv lookbacks
    (B, W-1, Ch); ``pos`` a scalar.  The batch goes over the data axes
    when it fills them; the cache's sequence over "model" then, and over
    every axis for a batch of one."""
    bdim, seq = _decode_axes(mesh, global_batch, pol)
    out = {"pos": ()}
    for group in ("layers", "cross"):
        if group in state:
            out[group] = [{k: _decode_leaf_spec(k, t.ndim, bdim, seq, pol)
                           for k, t in c.items()} for c in state[group]]
    return out


@dataclasses.dataclass(frozen=True)
class DecodeLayout:
    """A decode state's cut on a mesh (:func:`decode_layout`): the batch
    split over ``batch_axes`` (none: every rank holds every row), the
    caches' sequence over ``seq_axes`` (the axes of more than one rank;
    none: whole on every rank).  One device's cache of ``cache_len``
    slots is rounded up to ``slots · k`` (k ranks on ``seq_axes``); this
    rank owns slots [``slot0``, ``slot0 + slots``).  Padded slots lie past
    every position and are masked as every unwritten slot is."""
    mesh: Any
    batch_axes: Tuple[str, ...]
    seq_axes: Tuple[str, ...]
    specs: Dict[str, Spec]          # each cache leaf's layout by its name
    cache_len: int
    slots: int
    slot0: int

    def local_shape(self, name: str, shape: Sequence[int]
                    ) -> Tuple[int, ...]:
        """This rank's block of one device's leaf ``name`` of ``shape``."""
        shape = list(shape)
        if name in ("k", "v"):
            shape[1] = self.slots * _size(self.mesh, self.seq_axes)
        return local_shape(shape, self.specs[name], self.mesh)

    def kv_positions(self, device) -> torch.Tensor:
        """The global slot index of each of this rank's cache slots."""
        return torch.arange(self.slot0, self.slot0 + self.slots,
                            device=device)

    @property
    def seq_group(self):
        """(mesh, axes) the attention's softmax is combined over, or None
        when the sequence is not split."""
        return (self.mesh, self.seq_axes) if self.seq_axes else None

    def rows(self, batch: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (B, ...) tensor every rank holds whole."""
        if not self.batch_axes:
            return batch
        return mesh_mod.block(batch, self.mesh, self.batch_axes, 0)


def decode_layout(mesh, global_batch: int, cache_len: int,
                  pol: Optional[ShardingPolicy] = None) -> DecodeLayout:
    """How a decode state of ``global_batch`` rows and ``cache_len`` slots
    is cut on ``mesh`` under ``pol`` (the layouts of
    :func:`decode_state_pspecs`, with the axes the mesh lacks or holds
    once dropped)."""
    pol = pol or ShardingPolicy()
    names = set(mesh.mesh_dim_names or ())

    def keep(a: Axis) -> Tuple[str, ...]:
        return tuple(x for x in mesh_mod.as_axes(a) if x in names
                     and mesh_mod.axis_size(mesh, x) > 1) if a else ()
    bdim, seq = _decode_axes(mesh, global_batch, pol)
    baxes, saxes = keep(bdim), keep(seq)
    specs = {n: tuple(_axis(keep(a)) for a in
                      _decode_leaf_spec(n, nd, bdim, seq, pol))
             for n, nd in (("k", 4), ("v", 4), ("ssm", 4), ("conv_x", 3),
                           ("conv_bc", 3))}
    k = _size(mesh, saxes)
    slots = -(-cache_len // k)
    slot0 = mesh_mod.linear_index(mesh, saxes) * slots if saxes else 0
    if global_batch % _size(mesh, baxes):
        raise ValueError(f"a batch of {global_batch} does not split over "
                         f"{baxes}")
    return DecodeLayout(mesh=mesh, batch_axes=baxes, seq_axes=saxes,
                        specs=specs, cache_len=cache_len, slots=slots,
                        slot0=slot0)


# ------------------------------------------------ blocks of a full tensor
def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a layout splits over."""
    out = []
    for a in spec:
        out += list(mesh_mod.as_axes(a)) if a else []
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    out = []
    for n, a in zip(shape, spec):
        k = mesh_mod.axis_size(mesh, a) if a else 1
        if n % k:
            raise ValueError(f"dimension of {n} in {tuple(shape)} does not "
                             f"split over {a} ({k} ranks)")
        out.append(n // k)
    return tuple(out)


def full_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The full tensor's shape of a block of ``shape`` under ``spec``."""
    return tuple(n * (mesh_mod.axis_size(mesh, a) if a else 1)
                 for n, a in zip(shape, spec))


def local_shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec``: a
    contiguous copy."""
    if len(spec) != t.ndim:
        raise ValueError(f"layout {spec} does not fit a tensor of "
                         f"{tuple(t.shape)}")
    out = t
    for d, a in enumerate(spec):
        if a:
            out = mesh_mod.block(out, mesh, a, d)
    return out.contiguous() if out is not t else t.clone()


def gather_full(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's block (:func:`local_shard`'s
    inverse), on ``t``'s device."""
    out = t
    for d, a in enumerate(spec):
        if a:
            out = mesh_mod.all_gather_dim(out, mesh, a, d)
    return out if out is not t else t.clone()


# -------------------------------------- differentiable collectives (autograd)
def _size(mesh, axes) -> int:
    return mesh_mod.axis_size(mesh, axes) if mesh is not None and axes \
        else 1


class _SumIdentity(torch.autograd.Function):
    """Forward: the sum over ``axes``; backward: the identity (the result
    feeds a computation every rank of ``axes`` repeats)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh_mod.all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _IdentitySum(torch.autograd.Function):
    """Forward: the identity; backward: the sum over ``axes`` (the input
    feeds rank-local work whose gradients are shares)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh_mod.all_reduce(g, ctx.mesh, ctx.axes), None, None


class _GatherScatter(torch.autograd.Function):
    """Forward: the blocks along ``dim`` gathered over ``axes``; backward:
    the gradient summed over ``axes`` and scattered back (FSDP's
    weight gather, whose gradient comes as a share a data rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh_mod.all_gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return mesh_mod.reduce_scatter_dim(g.contiguous(), ctx.mesh,
                                           ctx.axes, ctx.dim), None, None, \
            None


class _GatherSlice(torch.autograd.Function):
    """Forward: the blocks along ``dim`` gathered over ``axes``; backward:
    this rank's block of the (whole, repeated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh_mod.all_gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return mesh_mod.block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), \
            None, None, None


class _SliceGather(torch.autograd.Function):
    """Forward: this rank's block along ``dim``; backward: the blocks'
    gradients gathered over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh_mod.block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return mesh_mod.all_gather_dim(g.contiguous(), ctx.mesh, ctx.axes,
                                       ctx.dim), None, None, None


def sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Differentiable sum over ``axes`` whose result every rank of them
    goes on with (backward: the identity).  The identity off a mesh."""
    if _size(mesh, axes) == 1:
        return x
    return _SumIdentity.apply(x, mesh, tuple(mesh_mod.as_axes(axes)))


def enter(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Differentiable identity whose backward sums the gradient over
    ``axes``.  The identity off a mesh."""
    if _size(mesh, axes) == 1:
        return x
    return _IdentitySum.apply(x, mesh, tuple(mesh_mod.as_axes(axes)))


def gather_weight(w: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """FSDP: a weight's blocks along ``dim`` gathered over ``axes``; the
    backward reduce-scatters its gradient."""
    if _size(mesh, axes) == 1:
        return w
    return _GatherScatter.apply(w, mesh, tuple(mesh_mod.as_axes(axes)), dim)


def gather_act(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """An activation's blocks along ``dim`` gathered over ``axes`` into
    the replicated layout (backward: this rank's block)."""
    if _size(mesh, axes) == 1:
        return x
    return _GatherSlice.apply(x, mesh, tuple(mesh_mod.as_axes(axes)), dim)


def slice_act(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """A replicated activation cut to this rank's block along ``dim``
    (backward: the blocks' gradients gathered)."""
    if _size(mesh, axes) == 1:
        return x
    return _SliceGather.apply(x, mesh, tuple(mesh_mod.as_axes(axes)), dim)


# ------------------------------------------------ a sharded model's context
@dataclasses.dataclass(frozen=True)
class Par:
    """What a sharded layer needs of its mesh: the mesh, the data axes,
    the tensor-parallel axis (None without one), the FSDP axis (None
    when weights are not sharded over data) and the residual stream's
    layout at a superblock boundary (``ShardingPolicy.act_mode``).
    :data:`LOCAL` is one device's: every collective is skipped."""
    mesh: Any
    dp: Tuple[str, ...]
    tp: Optional[str]
    fs: Optional[str]
    act_mode: str = "embed_tp"

    @property
    def tp_size(self) -> int:
        return _size(self.mesh, self.tp)

    @property
    def tp_rank(self) -> int:
        return mesh_mod.linear_index(self.mesh, self.tp) if self.tp else 0

    def to_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Enter a tensor-parallel region (column-parallel input)."""
        return enter(x, self.mesh, self.tp)

    def from_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Leave it: the row-parallel partial sums added over "model"."""
        return sum_over(x, self.mesh, self.tp)

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A loss term's partial sums added over the data axes."""
        return sum_over(x, self.mesh, self.dp)

    def tp_block(self, n: int) -> Tuple[int, int]:
        """(start, size) of this rank's block of ``n`` over "model"."""
        k = self.tp_size
        if n % k:
            raise ValueError(f"{n} does not split over {k} model ranks")
        return self.tp_rank * (n // k), n // k


LOCAL = Par(mesh=None, dp=(), tp=None, fs=None)


def par_of(mesh, pol: ShardingPolicy) -> Par:
    from repro_torch.launch.mesh import axis_names, dp_axes
    if pol.act_mode not in ACT_MODES:
        raise ValueError(f"unknown act_mode {pol.act_mode!r}; known: "
                         f"{ACT_MODES}")
    names = axis_names(mesh)
    return Par(mesh=mesh, dp=dp_axes(mesh),
               tp=pol.tp_axis if pol.tp_axis in names else None,
               fs=pol.fsdp_axis if pol.fsdp and pol.fsdp_axis in names
               else None, act_mode=pol.act_mode)


def _active_spec(spec: Spec, par: Par) -> Spec:
    """``spec`` with the axes this mesh lacks replicated."""
    names = set(par.dp) | ({par.tp} if par.tp else set())

    def keep(a):
        if not a:
            return None
        kept = tuple(x for x in mesh_mod.as_axes(a) if x in names)
        return None if not kept else kept[0] if len(kept) == 1 else kept
    return tuple(keep(a) for a in spec)


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh,
                pol: ShardingPolicy = ShardingPolicy(),
                names: Optional[Sequence[str]] = None) -> torch.nn.Module:
    """Cut the parameters ``names`` of ``model`` (full, on this rank's
    device; default every one not cut yet) to this rank's blocks, in
    place, and mark every module with the mesh (``module.par``).
    ``model.specs`` keeps each cut parameter's layout (axes the mesh
    lacks replicated); ``model.pol`` the policy.  A model drawn a part at
    a time (``models.model.init_params(mesh=)``) is cut a part at a
    time."""
    par = par_of(mesh, pol)
    if pol.fsdp and par.fs is None and "data" in (mesh.mesh_dim_names or ()):
        raise ValueError(f"FSDP axis {pol.fsdp_axis!r} is not a mesh axis")
    specs = dict(getattr(model, "specs", None) or {})
    if names is None:
        names = [n for n, _ in model.named_parameters() if n not in specs]
    for name in names:
        *path, pname = name.split(".")
        mod = model.get_submodule(".".join(path))
        p = mod._parameters[pname]
        spec = _active_spec(_leaf_spec(name, p.ndim, pol), par)
        specs[name] = spec
        mod._parameters[pname] = torch.nn.Parameter(
            local_shard(p.data, spec, mesh), requires_grad=p.requires_grad)
    for mod in model.modules():
        mod.par = par
    model.specs = specs
    model.pol = pol
    return model


def gather_layer(module: torch.nn.Module, par: Par, specs: Mapping[str, Spec],
                 prefix: str) -> Dict[str, torch.Tensor]:
    """{parameter name within ``module``: the weight with its FSDP blocks
    gathered over the data axis} for every parameter of ``module`` (its
    name ``prefix``.<name> in ``specs``)."""
    out = {}
    for name, p in module.named_parameters():
        spec = specs[f"{prefix}.{name}" if prefix else name]
        dims = [d for d, a in enumerate(spec) if a == par.fs]
        out[name] = gather_weight(p, par.mesh, par.fs, dims[0]) \
            if par.fs and dims else p
    return out


class swapped:
    """Context manager: ``module``'s parameters replaced by the tensors of
    ``tensors`` (named as ``named_parameters`` names them) while it is
    open, put back when it closes."""

    def __init__(self, module: torch.nn.Module,
                 tensors: Mapping[str, torch.Tensor]):
        self.slots = []
        for name, t in tensors.items():
            *path, leaf = name.split(".")
            mod = module.get_submodule(".".join(path)) if path else module
            self.slots.append((mod, leaf, t))

    def __enter__(self):
        self.saved = [(mod, leaf, mod._parameters[leaf])
                      for mod, leaf, _ in self.slots]
        for mod, leaf, t in self.slots:
            mod._parameters[leaf] = t
        return self

    def __exit__(self, *exc):
        for mod, leaf, p in self.saved:
            mod._parameters[leaf] = p
        return False


# ------------------------------------------------ activation layout hooks
def _act_dim(par: Par) -> Optional[int]:
    """The (B, S, D) dimension split over "model" at a superblock
    boundary, or None when the residual stream stays replicated."""
    if par.tp is None:
        return None
    return {"seq_tp": 1, "embed_tp": 2}.get(par.act_mode)


def act_seq_blocks(par: Par) -> int:
    """How many blocks of the sequence the boundary layout holds (the
    model-axis size under ``seq_tp``, else 1)."""
    if _act_dim(par) != 1:
        return 1
    return mesh_mod.axis_size(par.mesh, par.tp)


def shard_act_btd(x: torch.Tensor, par: Par) -> torch.Tensor:
    """A replicated (B, S, D) residual stream into the boundary layout
    ``par.act_mode`` names: (dp, None, "model") for ``embed_tp``, (dp,
    "model", None) for ``seq_tp``, unchanged for ``dp_only``.  What remat
    keeps at a superblock boundary is this block.  The identity off a
    mesh (:data:`LOCAL`)."""
    dim = _act_dim(par)
    if dim is None:
        return x
    return slice_act(x, par.mesh, par.tp, dim)


def unshard_act_btd(x: torch.Tensor, par: Par) -> torch.Tensor:
    """:func:`shard_act_btd`'s inverse: the boundary layout back to the
    replicated (dp, None, None) a layer computes on."""
    dim = _act_dim(par)
    if dim is None:
        return x
    return gather_act(x, par.mesh, par.tp, dim)


def shard_act_logits_input(x: torch.Tensor, par: Par) -> torch.Tensor:
    """Before the final norm and the vocab-parallel head: the residual
    stream in the replicated layout (dp, None, None), from whatever
    boundary layout it is in (the reference pins this layout only under
    ``seq_tp``; the port's head needs it under every mode)."""
    return unshard_act_btd(x, par)


def shard_moe_dispatch(xe: torch.Tensor, par: Optional[Par] = None
                       ) -> torch.Tensor:
    """The (E, C, D) expert dispatch buffer cut to this rank's experts
    over "model" (expert parallelism; ``par``: the sharded MoE layer's
    mesh).  The capacity dimension is already this data rank's own.  The
    identity off a mesh."""
    if par is None or par.tp is None:
        return xe
    return mesh_mod.block(xe, par.mesh, par.tp, 0)

"""Count-Sketch gradient compression with error feedback (SketchSGD /
FetchSGD, built on the paper's own data structure).  The port of
``repro.optim.sketch_compress``.

Each data shard sketches its local gradient into an (R, C) Count Sketch
and the sketches are all-reduced instead of the gradient: the sketch is
linear, so Σ_w sketch(g_w) = sketch(Σ_w g_w).  The merged sketch recovers
the top-k heaviest coordinates (momentum-accumulated, error-feedback
corrected), which are the only ones applied.  Error feedback keeps the
mass not transmitted: e ← (e + g) − transmitted.

On the card the sketch of the flattened gradient is K7 and its estimate
K8, one launch each a chunk of ``sketch.TENSOR_CHUNK`` coordinates
(``sketch.tensor_sketch_update`` / ``tensor_sketch_estimate``).  The
error and momentum are flat float32 buffers, one copy each, updated in
place; at 1.1·10⁹ coordinates each is 4.4 GB.

On a mesh (``compress_and_reduce(axis_names=, mesh=)``, the reference's
data-parallel algorithm) each data rank sketches its own gradient (its
share of the global batch's), the (R, C) tables are all-reduced over
``axis_names`` (``core.sketch.psum_merge``), and every rank runs the
same ``decompress`` on it.  The all-reduce hands every rank the same
bits, so error feedback and momentum stay the same on every rank.  On
integer-valued gradients the merged table is one device's sketch of the
summed gradient bit for bit; on float gradients the order of the adds
rounds it within (W - 1)·2⁻²⁴·Σ_w |table_w| of the exact sum (W ranks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.core import hashing, prng
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.sketch import CountSketch

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SketchCompressConfig:
    rows: int = 8
    log2_cols: int = 18
    top_k: int = 10_000          # coordinates applied per step
    momentum: float = 0.9
    seed: int = 0


class SketchCompressState(NamedTuple):
    error: torch.Tensor          # (N,) f32 error feedback, leaves in order
    momentum: torch.Tensor       # (N,) f32 server momentum
    sizes: Dict[str, int]        # each leaf's element count, in order


def _flatten(tree: Tensors, sizes: Mapping[str, int]) -> torch.Tensor:
    """The leaves of ``tree`` in ``sizes``' order as one (N,) float32
    buffer (no per-leaf float32 copies held at once)."""
    first = tree[next(iter(sizes))]
    out = torch.empty(sum(sizes.values()), dtype=torch.float32,
                      device=first.device)
    off = 0
    for name, n in sizes.items():
        out[off:off + n] = tree[name].reshape(-1)
        off += n
    return out


def _unflatten(flat: torch.Tensor, like: Tensors, sizes: Mapping[str, int]
               ) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, n in sizes.items():
        leaf = like[name]
        out[name] = flat[off:off + n].reshape(leaf.shape).to(leaf.dtype)
        off += n
    return out


def sketch_compress_init(params: Tensors, cfg: SketchCompressConfig
                         ) -> SketchCompressState:
    sizes = {n: p.numel() for n, p in params.items()}
    dev = next(iter(params.values())).device
    total = sum(sizes.values())
    return SketchCompressState(
        error=torch.zeros(total, dtype=torch.float32, device=dev),
        momentum=torch.zeros(total, dtype=torch.float32, device=dev),
        sizes=sizes)


def make_sketch(cfg: SketchCompressConfig, device) -> CountSketch:
    """Shared hash functions: every worker builds the identical sketch
    (the paper's 'same hashing functions at every site' contract), the
    reference's ``make_params(key(cfg.seed), rows)`` bits."""
    return sketch_mod.init(
        hashing.make_params(prng.key(cfg.seed, device), cfg.rows),
        cfg.log2_cols)


def local_sketch(grads: Tensors, state: SketchCompressState,
                 cfg: SketchCompressConfig) -> CountSketch:
    """Per shard: the sketch of the flattened gradient."""
    flat = _flatten(grads, state.sizes)
    return sketch_mod.tensor_sketch_update(make_sketch(cfg, flat.device),
                                           flat)


def _kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest |x| (any tie order gives this value), from each
    chunk's k largest."""
    step = sketch_mod.TENSOR_CHUNK
    cands = torch.cat([torch.topk(x[s:s + step].abs(),
                                  min(k, x[s:s + step].numel()),
                                  sorted=False)[0]
                       for s in range(0, x.numel(), step)])
    return torch.topk(cands, k)[0][-1]


def decompress(merged: CountSketch, grads_like: Tensors,
               state: SketchCompressState, cfg: SketchCompressConfig
               ) -> Tuple[Dict[str, torch.Tensor], SketchCompressState,
                          torch.Tensor]:
    """Recover the top-k coordinates from the merged sketch, with momentum
    on the estimated gradient and error = previous error + estimate −
    transmitted (the reference's coordinate-side FetchSGD).  Returns
    (updates like ``grads_like``, the state, the transmitted density);
    the state's buffers are updated in place."""
    err, mom = state.error, state.momentum
    n = err.shape[0]
    est = sketch_mod.tensor_sketch_estimate(merged, n)
    mom.mul_(cfg.momentum).add_(est)
    corrected = err.add_(mom)                # err's buffer holds mom + err
    thresh = _kth_largest(corrected, min(cfg.top_k, n))
    keep = corrected.abs() >= torch.clamp(thresh, min=1e-30)
    transmitted = est.copy_(corrected).masked_fill_(~keep, 0.0)
    corrected.masked_fill_(keep, 0.0)        # new error: corrected − sent
    mom.masked_fill_(keep, 0.0)              # momentum resets where sent
    density = torch.sum(keep, dtype=torch.float32) / n
    return (_unflatten(transmitted, grads_like, state.sizes),
            SketchCompressState(error=corrected, momentum=mom,
                                sizes=state.sizes), density)


def merged_sketch(grads: Tensors, state: SketchCompressState,
                  cfg: SketchCompressConfig, axis_names=None, mesh=None
                  ) -> CountSketch:
    """This rank's sketch of its gradient, all-reduced over the mesh
    dimensions ``axis_names`` (innermost first); the rank's own sketch
    without them."""
    sk = local_sketch(grads, state, cfg)
    if axis_names:
        if mesh is None:
            raise ValueError("merging over axis_names needs the mesh")
        sk = sketch_mod.psum_merge(sk, mesh, axis_names)
    return sk


def compress_and_reduce(grads: Tensors, state: SketchCompressState,
                        cfg: SketchCompressConfig, axis_names=None,
                        mesh=None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   SketchCompressState, torch.Tensor]:
    """One full compression round.  ``axis_names``: the dimensions of
    ``mesh`` to merge the sketches over (None: one process, the merge is
    the identity)."""
    return decompress(merged_sketch(grads, state, cfg, axis_names, mesh),
                      grads, state, cfg)

"""The program's arguments and draws, as a configuration file states
them: shared by the drivers."""
from __future__ import annotations

import torch

from snsbench import datagen


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s entries, nested groups merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def args(cfg: dict, seed: int) -> dict:
    """The program's configuration objects as the file states them; the
    program's own seed (its embedding init, UMAP's negatives, the
    approximate kNN's draws) from ``--seed``."""
    from repro_torch.core import ann, tsne, umap
    from repro_torch.core.pipeline import SnsConfig
    prog_seed = seed % ((1 << 31) - 1)
    sns = dict(cfg["sns"], seed=prog_seed)
    if sns.get("embed_knn_method") == "ann":
        sns["embed_ann"] = ann.AnnConfig(**dict(cfg.get("ann", {}),
                                                seed=prog_seed))
    out = {"cfg": SnsConfig(**sns)}
    if sns["embedder"] == "tsne":
        out["tsne_cfg"] = tsne.TsneConfig(**cfg["tsne"])
    else:
        out["umap_cfg"] = umap.UmapConfig(**cfg["umap"])
    return out


def warmup_args(cfg: dict, seed: int) -> dict:
    """:func:`args` with the embedder's fields the configuration's
    ``warmup`` cuts (such as fewer iterations)."""
    warm = cfg.get("warmup", {})
    return args(merge(cfg, {k: v for k, v in warm.items()
                            if k in ("tsne", "umap")}), seed)


def draws(cfg: dict, seed: int, dev: torch.device):
    """The sketch's hash parameters and the replicas' jitter from the
    seed: (params, jitter, the program's ``pipeline.Draws`` of them)."""
    from repro_torch.core import hashing, pipeline
    sns = cfg["sns"]
    params = datagen.hash_params(seed, sns["rows"], dev)
    jitter = datagen.jitter(seed, sns["top_k"], sns["max_replicas"],
                            cfg["data"]["dims"], sns["jitter_frac"], dev)
    return params, jitter, pipeline.Draws(
        hash_params=hashing.MulShiftParams(*params), jitter=jitter)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

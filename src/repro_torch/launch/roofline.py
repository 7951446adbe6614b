"""Roofline of the dry run's records (the port of ``repro.launch.roofline``).

Per (arch × shape × mesh) cell, three terms in seconds, one rank's:

    compute    = dot FLOPs a rank / the card's peak rate
    memory     = HBM bytes a rank (the analytic model below) / HBM rate
    collective = bytes inside a host / its rate + bytes across hosts /
                 their rate

The dry run (``launch/dryrun.py``) costs one rank's program, so its FLOP
and collective counts are already a rank's.  MODEL_FLOPS uses the
6·N·D convention (2·N·B for a one-token decode step), giving the useful
share of the counted FLOPs.

The formulas are the reference's; its TPU v5e constants become
arguments.  Their defaults are one H100 SXM's published peaks: 989
TFLOP/s dense bf16 and 3.35 TB/s of HBM3.  The two collective rates are
assumptions about the cluster, not properties of the card: NVLink at 450
GB/s a direction between the 8 cards of a host, and 50 GB/s a card
between hosts (one 400 Gb/s NIC a card).  A record of the reference (an
``hlo_tripaware`` count) reads the same way; its "dcn" bytes are the
ones across pods.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Any, Dict, List

PEAK_FLOPS = 989e12        # H100 SXM, dense bf16
HBM_BW = 3.35e12           # H100 SXM HBM3
ICI_BW = 450e9             # assumed: NVLink, a direction, inside a host of 8
DCN_BW = 50e9              # assumed: one 400 Gb/s NIC a card, across hosts


def _cfg(rec: Dict[str, Any]):
    from repro_torch.configs import get_config
    cfg = get_config(rec["arch"])
    if rec.get("overrides"):
        cfg = dataclasses.replace(cfg, **rec["overrides"])
    return cfg


def _shape(rec: Dict[str, Any]):
    """(global batch, sequence, kind) of the record's cell."""
    if "global_batch" in rec:
        return rec["global_batch"], rec["seq_len"], rec["kind"]
    from repro_torch.models.config import SHAPES
    shp = SHAPES[rec["shape"]]
    return shp.global_batch, shp.seq_len, shp.kind


def analytic_hbm_bytes(rec: Dict[str, Any], tp: int = None) -> float:
    """A rank's HBM traffic for one step, the reference's model (fusion
    assumed: only the traffic a fused execution must pay).

    train:   weights 3× (forward, backward's input and weight gradients
             over the gathered layer tiles) + optimizer state (read m, v
             and an f32 master, write back: 7 f32 passes over the local
             shard) + the remat boundary activations (a write and 2
             reads) + the logits row.
    prefill: weights 1× + the KV cache write + boundary activations 1×.
    decode:  the active weights 1× + the whole KV/SSM cache read.

    ``tp``: the model-axis size (the record's ``tp``, else 16, the
    production mesh's)."""
    cfg = _cfg(rec)
    global_batch, seq_len, kind = _shape(rec)
    dev = rec["devices"]
    tp = tp or rec.get("tp", 16)
    dp = max(dev // tp, 1)
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    bsz_local = max(global_batch // dp, 1)
    d = cfg.d_model

    if kind == "train":
        w = 3 * (2 * n_params) / dev
        opt = 7 * (4 * n_params) / dev
        act = 3 * cfg.num_layers * bsz_local * seq_len * (2 * d) / tp
        logits = 3 * bsz_local * seq_len * 2 * cfg.vocab_size / tp
        return w + opt + act + logits
    if kind == "prefill":
        w = (2 * n_params) / dev
        kv_w = (2 * cfg.num_layers * bsz_local * seq_len
                * cfg.num_kv_heads * cfg.head_dim * 2) / tp
        act = cfg.num_layers * bsz_local * seq_len * (2 * d) / tp
        return w + kv_w + act
    w = (2 * n_active) / dev
    if cfg.family in ("ssm", "hybrid"):
        n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
        n_ssm = cfg.num_layers - n_attn
        cache = (n_attn * global_batch * seq_len
                 * cfg.num_kv_heads * cfg.head_dim * 2
                 + n_ssm * global_batch * cfg.ssm_heads
                 * cfg.ssm_headdim * cfg.ssm_state * 4) / dev
    else:
        layers = cfg.num_layers + cfg.encoder_layers
        cache = (layers * global_batch * seq_len
                 * cfg.num_kv_heads * cfg.head_dim * 2) / dev
        if cfg.encoder_layers:
            cache *= 2                         # self + cross caches
    return w + cache


def roofline_terms(rec: Dict[str, Any], peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW, ici_bw: float = ICI_BW,
                   dcn_bw: float = DCN_BW) -> Dict[str, Any]:
    """The three terms and the bottleneck of one dry-run record (the
    port's ``counts`` or the reference's ``hlo_tripaware``).  FLOPs and
    collective bytes: the record's counts; memory: the analytic model
    (:func:`analytic_hbm_bytes`)."""
    if rec.get("status") != "ok":
        return {"status": rec.get("status", "missing"),
                "reason": rec.get("reason", rec.get("error", ""))[:200]}
    ta = rec.get("counts") or rec.get("hlo_tripaware", {})
    flops = ta.get("flops", 0.0)
    coll_total = ta.get("collective_bytes", 0.0)
    dcn = ta.get("collective_dcn_bytes", 0.0)
    ici = coll_total - dcn
    bytes_acc = analytic_hbm_bytes(rec)

    t_compute = flops / peak_flops
    t_memory = bytes_acc / hbm_bw
    t_coll = ici / ici_bw + dcn / dcn_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get)

    n_act = rec["active_param_count"]
    dev = rec["devices"]
    if rec["kind"] == "train":
        model_flops = 6 * n_act * rec["global_batch"] * rec["seq_len"]
    elif rec["kind"] == "prefill":
        model_flops = 2 * n_act * rec["global_batch"] * rec["seq_len"]
    else:
        model_flops = 2 * n_act * rec["global_batch"]
    total = flops * dev
    ratio = model_flops / total if total else 0.0
    t_star = max(t_compute, t_memory, t_coll)
    frac = (model_flops / dev / peak_flops) / t_star if t_star else 0.0
    mem = rec["memory"]
    upper = ta.get("bytes")
    return {
        "status": "ok",
        **{k: float(f"{v:.6g}") for k, v in terms.items()},
        "bottleneck": bottleneck.replace("_s", ""),
        "model_flops": model_flops,
        "hlo_flops_per_dev": flops,
        "useful_ratio": round(ratio, 4),
        "roofline_frac": round(frac, 4),
        "ici_bytes": ici, "dcn_bytes": dcn,
        "hbm_hlo_upper_gb": None if upper is None
        else round(upper / 2**30, 1),
        "mem_per_dev_gb": round(
            ((mem.get("argument_bytes") or 0) + (mem.get("temp_bytes") or 0)
             + (mem.get("output_bytes") or 0)
             - (mem.get("alias_bytes") or 0)) / 2**30, 2),
    }


def build_table(result_dir: str, **constants) -> List[Dict[str, Any]]:
    rows = []
    for path in sorted(glob.glob(os.path.join(result_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        row = {"arch": rec["arch"], "shape": rec["shape"],
               "mesh": rec["mesh"]}
        row.update(roofline_terms(rec, **constants))
        rows.append(row)
    return rows


def to_markdown(rows: List[Dict[str, Any]]) -> str:
    hdr = ("| arch | shape | mesh | compute (ms) | memory (ms) | "
           "collective (ms) | bottleneck | useful ratio | roofline frac | "
           "mem/dev (GB) |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"{r.get('status')} ({r.get('reason', '')[:60]}) | — | — | —"
                f" |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {1e3 * r['compute_s']:.2f} | {1e3 * r['memory_s']:.2f} "
            f"| {1e3 * r['collective_s']:.2f} | {r['bottleneck']} "
            f"| {r['useful_ratio']:.3f} | {r['roofline_frac']:.3f} "
            f"| {r['mem_per_dev_gb']} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--results", default="results/dryrun")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = build_table(args.results)
    print(to_markdown(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()

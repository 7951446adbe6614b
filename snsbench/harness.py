"""One run of one cell: set-up, the measured window, the check, the
result line.

The cell's traffic mix (``traffic/<name>.json``) names its driver
(``drivers/<name>.py``), which makes the mix's inputs on the device from
the seed and warms up the cell's own shapes; the configuration's
``check.stages`` names the embedder's stage module (``stages/<name>.py``),
which captures what the check reads.  The window then runs maps back to
back, dataset after dataset of the pool, a further map only where the
last map's time says it ends inside the window.  With ``trace`` the
window's last map runs under ``torch.profiler``.  After the window the
program's outputs are judged (``check.judge``) and the metrics read
(``metrics/<name>.py``)."""
from __future__ import annotations

import json
import sys
import time
from typing import Optional

import torch

from snsbench import check, faults, program, spec, trace, window
from snsbench.capture import Capture

BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _activities(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def window_loop(site, seconds: float, traced: bool, cap) -> dict:
    """The measured window: maps back to back over the pool.  Where
    ``traced``, the last map runs under the profiler: the map after which,
    taking as long as the one before, no other would fit (profiling slows
    the maps that follow it, so it goes last and the window ends with
    it)."""
    from repro_torch import kernels
    maps, last, prof = [], None, None
    profile_next = False
    t0 = time.perf_counter()
    while True:
        d = (len(maps) + 1) % site.datasets
        cap.reset()
        last = None
        before = dict(kernels.LAUNCHES)
        if profile_next:
            cap.spans = True
            # the profiler starts before the map's clock and stops after it
            with torch.profiler.profile(
                    activities=_activities(site.dev)) as prof:
                ts = time.perf_counter()
                last = site.run_map(d)
                program.sync(site.dev)
                te = time.perf_counter()
            cap.spans = False
        else:
            ts = time.perf_counter()
            last = site.run_map(d)
            program.sync(site.dev)
            te = time.perf_counter()
        hh = last.hh
        maps.append({"dataset": d, "seconds": te - ts,
                     "stages": dict(last.stage_seconds),
                     "keys": (hh.key_hi << 32) | hh.key_lo,
                     "count": hh.count, "mask": hh.mask,
                     "launches": {k: v - before.get(k, 0) for k, v in
                                  kernels.LAUNCHES.items()
                                  if v - before.get(k, 0)}})
        go = window.may_start(te - t0, te - ts, seconds)
        if traced:
            # the profiled map ends the window; it runs next when the map
            # after it would not fit, past the window when none fits
            go = not profile_next
            profile_next = not window.may_start(te - t0, 2 * (te - ts),
                                                seconds)
        if not go:
            break
    return {"maps": maps, "last": last, "prof": prof, "window_s": te - t0,
            "profiled": len(maps) - 1 if prof is not None else None}


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, *,
             t_start: float, device: str = "cuda",
             cfg_override: Optional[dict] = None, **kw) -> dict:
    """The result line's object for the cell of ``BENCHMARK.json``;
    ``cfg_override`` changes its configuration (tests at small sizes)."""
    bench = spec.bench()
    cell = spec.cell(cell_name, bench)
    cfg = program.merge(spec.config(cell["config"], bench),
                        cfg_override or {})
    return run(cell_name, cfg, spec.traffic(cell["traffic"]), seed, seconds,
               traced, t_start=t_start, device=device, **kw)


def run(cell_name: str, cfg: dict, traffic: dict, seed: int, seconds: float,
        traced: bool, *, t_start: float, device: str = "cuda",
        control: Optional[str] = None, fault: Optional[str] = None) -> dict:
    """One run of ``cfg`` under ``traffic``, reporting ``cell_name``'s
    metrics; ``control`` judges the reference in lower precision in the
    program's place, ``fault`` plants one of ``faults.FAULTS``."""
    drv = spec.driver(traffic["driver"])
    stage = spec.stages(cfg["check"]["stages"])
    faults.plant(fault)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    site = drv.set_up(cfg, traffic, seed, dev, stage)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    cap = Capture().install(stage)
    try:
        w = getattr(drv, "window_loop", window_loop)(site, seconds, traced,
                                                     cap)
    finally:
        cap.uninstall()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = None
    if traced:
        t = time.perf_counter()
        summary = trace.summarize(w["prof"])
        print(f"trace read in {time.perf_counter() - t:.1f} s",
              file=sys.stderr)
    w["prof"] = None
    t = time.perf_counter()
    judged = check.judge(cfg, stage,
                         [site.dataset(d) for d in range(site.datasets)],
                         site.params, site.jitter, w["maps"], w["last"],
                         cap.got, seed, control=control)
    print(f"check made in {time.perf_counter() - t:.1f} s", file=sys.stderr)
    return _result(cell_name, cfg, w, judged, setup_s, peak, summary, dev,
                   drv.CHIPS, control)


def _result(cell_name, cfg, w, judged, setup_s, peak, summary, dev, count,
            control) -> dict:
    limits = cfg["check"]["limits"]
    numbers = judged["numbers"]
    correct = check.verdict(numbers, limits)
    failed = set(judged["failed_maps"])
    maps = w["maps"]
    if not correct:
        failed.add(len(maps) - 1)
    ctx = {"maps": maps, "window_s": w["window_s"], "setup_s": setup_s,
           "profiled": w["profiled"], "counts": judged["counts"],
           "trace": summary}
    kind = "per_layer" if summary is not None else "end_to_end"
    metrics = spec.read_metrics(spec.metrics_of(cell_name, kind), ctx)
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu",
                "count": count, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(maps),
           "failed": len(failed), "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info.update(busy_s=summary["busy_s"],
                        window_s=summary["window_s"])
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    if control:
        out["control"] = control
    print("maps (dataset, seconds): " + ", ".join(
        f"{m['dataset']} {m['seconds']!r}" for m in maps), file=sys.stderr)
    out["checks"] = {k: {"value": _finite(numbers[k]),
                         "limit": limits.get(k)} for k in numbers}
    return out


def _finite(v):
    """A number, or "inf"/"nan" as a string (strict JSON has neither)."""
    return v if v == v and abs(v) != float("inf") else str(v)


def print_result(out: dict) -> None:
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)

"""The device's side of a profiled map, read from ``torch.profiler``.

:func:`summarize` turns a profile into the kernels' records by name, the
seconds some operation ran on the device (the union of their intervals),
the traced window, and the idle gaps between device operations, each
labelled by what the host was doing in it: the innermost host operation
open at the gap's middle, under the innermost benchmark span (``sns:``)
open there."""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

TOP = 10
SPAN = "sns:"                  # the benchmark's spans (capture.Capture)


def summarize(prof) -> dict:
    """The profile's raw records (``kineto_results.events()``: building
    ``prof.events()`` takes the host minutes on a long map), in µs."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        iv = (ev.start_ns() / 1e3, ev.end_ns() / 1e3, name)
        if ev.device_type() != DeviceType.CUDA:
            host.append(iv + (ev.start_thread_id(),))
        elif not (ev.is_user_annotation() or name.startswith(SPAN)):
            dev.append(iv)      # a kernel, copy or set, not a span's range
    return summarize_intervals(dev, host)


def summarize_intervals(dev: List[Tuple], host: List[Tuple]) -> dict:
    """``dev``: (start µs, end µs, name) of each device operation;
    ``host``: (start µs, end µs, name, thread) of each host operation."""
    if not dev:
        return {"records": {}, "device_us": {}, "busy_s": 0.0,
                "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    starts = [s for s, _, _ in dev] + [h[0] for h in host]
    ends = [e for _, e, _ in dev] + [h[1] for h in host]
    t0, t1 = min(starts), max(ends)
    records: Dict[str, int] = collections.Counter()
    device_us: Dict[str, float] = collections.defaultdict(float)
    for s, e, name in dev:
        records[name] += 1
        device_us[name] += e - s
    busy, gaps, cur_s, cur_e = 0.0, [], None, t0
    for s, e, _ in sorted(dev):
        if cur_s is None or s > cur_e:
            if s > cur_e:
                gaps.append((cur_e, s))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if t1 > cur_e:
        gaps.append((cur_e, t1))
    labels = label_gaps(gaps, host)
    idle = collections.defaultdict(float)
    for (s, e), lab in zip(gaps, labels):
        idle[lab] += (e - s) / 1e6
    by_short = collections.defaultdict(float)
    for name, us in device_us.items():
        by_short[short_name(name)] += us
    ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:TOP]
    return {"records": dict(records), "device_us": dict(device_us),
            "busy_s": busy / 1e6, "window_s": (t1 - t0) / 1e6,
            "device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:TOP]}


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


def label_gaps(gaps: List[Tuple[float, float]], host: List[Tuple]
               ) -> List[str]:
    """For each gap, "<span> / <op>": the innermost ``sns:`` span and the
    innermost host operation of the busiest host thread open at the gap's
    middle ("-" where none is)."""
    if not host:
        return ["-"] * len(gaps)
    main = collections.Counter(h[3] for h in host).most_common(1)[0][0]
    evs = sorted((h for h in host if h[3] == main),
                 key=lambda h: (h[0], -h[1]))
    out = [None] * len(gaps)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    stack, spans, j = [], [], 0
    for i in order:
        mid = 0.5 * (gaps[i][0] + gaps[i][1])
        while j < len(evs) and evs[j][0] <= mid:
            st = spans if evs[j][2].startswith(SPAN) else stack
            st.append(evs[j])
            j += 1
        for st in (stack, spans):
            st[:] = [h for h in st if h[1] >= mid]
        span = spans[-1][2] if spans else "-"
        op = stack[-1][2] if stack else "-"
        out[i] = f"{span} / {op}"
    return out

"""The measured window's arithmetic: when a further map may start, and
what the window's map times come to."""
from __future__ import annotations

import statistics
from typing import List


def may_start(elapsed_s: float, last_map_s: float, seconds: float) -> bool:
    """A further map starts only if, taking as long as the last one, it
    ends inside the window of ``seconds``."""
    return elapsed_s + last_map_s <= seconds


def map_s(window_s: float, maps: int) -> float:
    """Wall time a map: the window over the maps it completed."""
    return window_s / maps


def percentile(values: List[float], pct: int) -> float:
    """The ``pct``-th percentile of ``values`` (linear between order
    statistics, ``statistics.quantiles(method="inclusive")``)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]


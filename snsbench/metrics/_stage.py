"""Shared by the stage readers: the mean of a ``stage_seconds`` entry
over the window's maps, the profiled map left out where others ran."""


def mean_stage(ctx: dict, stage: str):
    maps = [m for i, m in enumerate(ctx["maps"]) if i != ctx["profiled"]] \
        or ctx["maps"]
    vals = [m["stages"][stage] for m in maps if stage in m["stages"]]
    return sum(vals) / len(vals) if vals else None

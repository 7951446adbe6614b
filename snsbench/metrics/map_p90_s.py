"""``map_p90_s``: the 90th percentile of the window's map times (host
clock, each map ending in a device synchronize)."""
from snsbench import window


def read(ctx):
    return window.percentile([m["seconds"] for m in ctx["maps"]], 90)

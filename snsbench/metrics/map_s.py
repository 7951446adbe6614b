"""``map_s``: wall time a map, the window (first map's start to last map's
end, host clock, each map ending in a device synchronize) over the maps
completed in it."""
from snsbench import window


def read(ctx):
    return window.map_s(ctx["window_s"], len(ctx["maps"]))

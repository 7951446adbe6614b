"""``device_busy_ms``: the summed time of every device operation in the
profiled map (torch.profiler's kernel and copy records)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["device_us"]:
        return None
    return sum(t["device_us"].values()) / 1e3

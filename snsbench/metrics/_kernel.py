"""Shared by the roofline readers: a kernel's device seconds in the
profiled map, where the profiler recorded as many of its launches as the
program counted (else None: a record was lost, and nothing is guessed)."""


def kernel_seconds(ctx: dict, name_part: str, op: str):
    t = ctx.get("trace")
    if not t:
        return None
    names = [n for n in t["records"] if name_part in n]
    launches = ctx["maps"][ctx["profiled"]]["launches"].get(op, 0)
    if not names or not launches or \
            sum(t["records"][n] for n in names) != launches:
        return None
    return sum(t["device_us"][n] for n in names) / 1e6

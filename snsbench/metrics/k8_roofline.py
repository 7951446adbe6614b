"""``k8_roofline``: K8 ``sketch_estimate_table``'s least time on the card
for the profiled map's estimate of the candidate pool (``roofline.
k8_bytes`` of the pool's keys and the table cells their hashes read, as
the reference counts them) over its profiler time."""
from snsbench import roofline
from snsbench.metrics._kernel import kernel_seconds


def read(ctx):
    s = kernel_seconds(ctx, "sketch_estimate", "sketch_estimate_table")
    if s is None:
        return None
    c = ctx["counts"][ctx["maps"][ctx["profiled"]]["dataset"]]
    return roofline.share_pct(
        roofline.bound_s(roofline.k8_bytes(c["queries"], c["pool_cells"])), s)

"""``k7_roofline``: K7 ``sketch_update_table``'s least time on the card
for the profiled map's sketch update (``roofline.k7_bytes`` of the
distinct cells of the map's points and the table cells their hashes
touch, as the reference counts them) over its profiler time."""
from snsbench import roofline
from snsbench.metrics._kernel import kernel_seconds


def read(ctx):
    s = kernel_seconds(ctx, "sketch_update_kernel", "sketch_update_table")
    if s is None:
        return None
    c = ctx["counts"][ctx["maps"][ctx["profiled"]]["dataset"]]
    return roofline.share_pct(
        roofline.bound_s(roofline.k7_bytes(c["cells"], c["table_cells"])), s)

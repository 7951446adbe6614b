"""``optimize_host_s``: host seconds of the embedder's loop (the
program's span ``embed.optimize``), the time the host takes to enqueue
it, the mean over the window's maps.  Beside ``optimize_s`` it says
whether the host sets the loop's pace."""
from snsbench.metrics._stage import mean_stage


def read(ctx):
    return mean_stage(ctx, "embed.optimize")

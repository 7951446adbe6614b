"""``knn_s``: device seconds of the embed's kNN graph build (the
program's span ``embed.knn``: the exact build or the approximate one),
the mean over the window's maps."""
from snsbench.metrics._stage import mean_stage


def read(ctx):
    return mean_stage(ctx, "embed.knn@device")

"""``layout_s``: device seconds of UMAP's set-up before its epochs (the
program's span ``embed.layout``: the curve fit, the edge layout, the
normalized memberships, the init), the mean over the window's maps."""
from snsbench.metrics._stage import mean_stage


def read(ctx):
    return mean_stage(ctx, "embed.layout@device")

"""``affinity_s``: device seconds of the embed's affinities (the
program's span ``embed.affinity``: UMAP's fuzzy set, tSNE's P), the mean
over the window's maps."""
from snsbench.metrics._stage import mean_stage


def read(ctx):
    return mean_stage(ctx, "embed.affinity@device")

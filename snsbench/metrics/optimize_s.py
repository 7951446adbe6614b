"""``optimize_s``: device seconds of the embedder's loop (the program's
span ``embed.optimize``: UMAP's epochs, tSNE's iterations), between the
loop's first and last work on the device's stream, the mean over the
window's maps."""
from snsbench.metrics._stage import mean_stage


def read(ctx):
    return mean_stage(ctx, "embed.optimize@device")

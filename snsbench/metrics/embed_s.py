"""``embed_s``: host seconds of the map's embed stage (the program's
``SnsResult.stage_seconds["embed"]``, each ending in a device synchronize),
the mean over the window's maps."""
from snsbench.metrics._stage import mean_stage


def read(ctx):
    return mean_stage(ctx, "embed")

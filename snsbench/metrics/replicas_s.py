"""``replicas_s``: host seconds of the map's replicas stage (the program's
``SnsResult.stage_seconds["replicas"]``, each ending in a device synchronize),
the mean over the window's maps."""
from snsbench.metrics._stage import mean_stage


def read(ctx):
    return mean_stage(ctx, "replicas")

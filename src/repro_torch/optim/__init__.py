"""Optimizers of the LM stack (the port of ``repro.optim``): AdamW,
Adafactor, the learning-rate schedules and Count-Sketch gradient
compression.  Parameters, gradients and states are dicts keyed by the
model's parameter names; updates run in place under ``torch.no_grad``."""
from repro_torch.optim.adafactor import (AdafactorConfig, AdafactorState,
                                         adafactor_init, adafactor_update)
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup
from repro_torch.optim.sketch_compress import (SketchCompressConfig,
                                               SketchCompressState,
                                               compress_and_reduce,
                                               sketch_compress_init)

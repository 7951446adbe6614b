"""Training and serving steps, the trainer and its callbacks (the port of
``repro.train``)."""

"""Launchers of the LM stack (the port of ``repro.launch``): serving and
training."""

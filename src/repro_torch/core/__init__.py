"""The SnS core on tensors (see the package docstring)."""

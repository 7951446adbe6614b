"""Step factories of the LM stack (the port of ``repro.train``; serving
half)."""

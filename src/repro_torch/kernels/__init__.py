"""Hand-written CUDA kernels and their plain PyTorch twins.

``LAUNCHES`` counts kernel launches per op.  Each CUDA wrapper adds one
where it launches, and nowhere else, so a run can show that it went
through the kernels.
"""
import collections

LAUNCHES: collections.Counter = collections.Counter()

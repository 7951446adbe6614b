"""Sketch and Scale in PyTorch on an NVIDIA H100: the port of ``repro``.

Module paths mirror the JAX reference (``repro_torch.core.<m>`` ↔
``repro.core.<m>``).  This package imports neither ``jax`` nor ``repro``.
"""
